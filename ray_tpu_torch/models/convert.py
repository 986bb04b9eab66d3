"""Carry the JAX package's parameters across to the port, and onto each
rank's shard of a mesh."""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import (ParallelConfig,
                                              TransformerConfig, param_shapes,
                                              param_specs)
from ray_tpu_torch.parallel.collectives import bind_mesh, map_specs, unshard
from ray_tpu_torch.parallel.sharding import local_shard


def params_from_jax(tree: dict, cfg: TransformerConfig, device=None) -> dict:
    """JAX param tree (nested dicts of numpy or JAX arrays, any float
    dtype) -> the port's dict in ``cfg.dtype`` on ``device``.

    Each leaf goes through ``np.asarray(x, np.float32)``, which is
    lossless from bf16, so both packages compute on the same weights.
    Raises ``ValueError`` when a key or shape differs from ``cfg``'s."""
    device = resolve_device(device)

    def convert(node, shapes, path):
        if isinstance(shapes, dict):
            if not isinstance(node, dict) or set(node) != set(shapes):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"param tree at {path or '/'}: expected "
                                 f"keys {sorted(shapes)}, got {got}")
            return {k: convert(node[k], shapes[k], f"{path}/{k}")
                    for k in shapes}
        x = np.asarray(node, np.float32)
        if x.shape != shapes:
            raise ValueError(f"param {path}: expected shape {shapes}, got "
                             f"{x.shape}")
        # torch.tensor copies: a JAX array's numpy view is read-only
        return torch.tensor(x).to(device=device, dtype=cfg.dtype)

    return convert(tree, param_shapes(cfg), "")


def shard_params(params: dict, pcfg: ParallelConfig, mesh) -> dict:
    """This rank's shard of every leaf of the full param dict by
    ``param_specs(pcfg)`` on ``mesh``, as fresh tensors: the per-rank
    counterpart of ``jax.device_put(params, NamedSharding(mesh, spec))``.
    The train step takes these, and the optimizer is built over them."""
    return map_specs(lambda x, spec: local_shard(x, spec, mesh).clone(),
                     param_specs(pcfg), params)


def gather_params(params: dict, pcfg: ParallelConfig, mesh) -> dict:
    """The inverse of ``shard_params``: the full param dict from every
    rank's shards, by all-gathers over the sharded axes. Every rank of
    ``mesh`` calls it and gets the whole dict."""
    with torch.no_grad(), bind_mesh(mesh):
        return map_specs(lambda x, spec: unshard(x.detach(), spec).clone(),
                         param_specs(pcfg), params)
