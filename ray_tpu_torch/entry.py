"""Entry points (counterparts of ``__graft_entry__.entry`` and
``__graft_entry__.dryrun_multichip``)."""

from __future__ import annotations

import functools
import math

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.convert import shard_params
from ray_tpu_torch.models.transformer import (AdamW, ParallelConfig,
                                              TransformerConfig, forward,
                                              init_params, make_train_step)
from ray_tpu_torch.parallel.launch import run_spmd
from ray_tpu_torch.parallel.mesh import (MeshConfig, build_mesh,
                                         default_mesh_shape)


def entry(device=None):
    """Returns ``(fn, args)``: the single-device forward of the flagship
    decoder, with the JAX entry's config and its [4, 128] zero tokens.
    ``fn(*args)`` gives fp32 logits [4, 128, 512]."""
    device = resolve_device(device)
    cfg = TransformerConfig(vocab=512, d_model=256, n_heads=8, n_layers=4,
                            d_ff=1024, max_seq=128)
    params = init_params(cfg, seed=0, device=device)
    tokens = torch.zeros((4, 128), dtype=torch.long, device=device)
    return functools.partial(forward, cfg=cfg), (params, tokens)


def dryrun_multichip(n_devices: int, device=None) -> float:
    """One AdamW step of the SPMD train step over an ``n_devices``-rank
    mesh shaped ``default_mesh_shape(n_devices)``: Megatron tp, ring
    attention on sp, GPipe on pp (2 microbatches), gradient means over
    dp. Ranks are started by ``run_spmd``: one GPU each on CUDA
    (``device=None``; raises with fewer than ``n_devices``), or gloo
    ranks with ``device="cpu"``. Returns the loss; raises if it is not
    finite.

    The reference's tiny config, 8-wide heads included: with sp = 1
    attention is local, which launches K1-K3 on CUDA (they pad a
    head_dim under 64 in shared memory)."""
    device = resolve_device(device)
    shape = default_mesh_shape(n_devices)
    losses = run_spmd(_dryrun_rank, n_devices, shape, device.type,
                      device=device)
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss on some rank: {losses}")
    return losses[0]


def _dryrun_rank(rank: int, shape: MeshConfig, device_type: str) -> float:
    del rank
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    mesh = build_mesh(shape, device_type=device_type)
    # tiny shapes, every axis exercised; sizes divisible by the mesh
    heads = max(4, 2 * shape.tp)
    cfg = TransformerConfig(
        vocab=64, d_model=heads * 8, n_heads=heads,
        n_layers=2 * max(1, shape.pp), d_ff=16 * shape.tp,
        max_seq=8 * shape.sp)
    pcfg = ParallelConfig(
        dp="dp" if shape.dp > 1 else None,
        pp="pp" if shape.pp > 1 else None,
        sp="sp" if shape.sp > 1 else None,
        tp="tp" if shape.tp > 1 else None,
        attn="ring" if shape.sp > 1 else "local",
        num_microbatches=2)
    step, optimizer = make_train_step(cfg, pcfg, mesh=mesh,
                                      optimizer=AdamW(1e-3))
    params = shard_params(init_params(cfg, seed=0, device=device), pcfg,
                          mesh)
    opt_state = optimizer.init(params)
    B = 4 * max(1, shape.dp)  # 2 microbatches of 2 per dp rank
    T = cfg.max_seq
    zeros = torch.zeros((B, T), dtype=torch.long, device=device)
    _, _, loss = step(params, opt_state, {"tokens": zeros, "targets": zeros})
    return loss.item()
