"""Decoder-only transformer (Llama-style) over a dp/pp/sp/tp mesh.

Counterpart of ``ray_tpu/models/transformer.py``: the same config, the
same parameter dict (JAX key names, layer weights stacked on a leading
``[L, ...]`` dim, so params convert one to one) and the same math, with
a Python loop over layers in place of ``lax.scan``,
``torch.utils.checkpoint`` in place of ``jax.checkpoint``, and
``torch.optim`` behind optax's ``init`` in place of ``optax``.

One model definition, two execution modes sharing every line of math:

* **oracle**: ``ParallelConfig()`` with all axes ``None``: plain
  single-device forward (the differential-test reference).
* **SPMD**: per rank, on this rank's shards, with a mesh's axis names
  bound (``make_train_step(mesh=...)``, or ``parallel.shard_map``):
  Megatron-style tensor parallelism on ``tp`` (column-parallel
  QKV/gate/up, row-parallel O/down + ``tp_allreduce``; backward fixed up
  by ``tp_copy``), ring or Ulysses attention on ``sp``, a GPipe
  microbatch pipeline on ``pp`` (``parallel.pipeline_spmd``), and
  gradient means over the data axes (``dp``/``sp``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.rotary import apply_rotary, rope_frequencies
from ray_tpu_torch.parallel.collectives import (axis_index, axis_size,
                                                bind_mesh, pmean, psum,
                                                tp_allreduce, tp_copy,
                                                with_current_mesh)
from ray_tpu_torch.parallel.pipeline import pipeline_spmd
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.sharding import P, local_shard
from ray_tpu_torch.parallel.ulysses import ulysses_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 512
    max_seq: int = 256
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


_aten = torch.ops.aten
# Rematerialization policies (JAX's ``jax.checkpoint`` policies): the
# aten ops whose outputs a layer saves; None recomputes the whole layer.
# "dots" saves every matmul output; "dots_no_batch" only those without
# batch dims: the layer's ``h @ w`` products reach aten as mm, the plain
# attention's einsums as bmm. The ctypes flash kernels are invisible to
# the dispatcher, so K1 is always recomputed, as a pallas_call is under
# JAX's dot policies.
REMAT_POLICIES = {
    "full": None,
    "dots": frozenset({_aten.mm, _aten.addmm, _aten.bmm}),
    "dots_no_batch": frozenset({_aten.mm, _aten.addmm}),
}


ATTN_IMPLS = ("auto", "local", "ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh axis names (None = that parallelism disabled) and the layer
    options of the JAX ParallelConfig. ``attn`` ``"ring"`` or
    ``"ulysses"`` without an sp axis runs local flash attention, as the
    reference's ``_attend`` does; ``"auto"`` is ring with sp, else local.
    ``num_microbatches`` is read by the pipeline only (pp). ``remat``
    checkpoints every layer under ``remat_policy``."""
    dp: Optional[str] = None
    pp: Optional[str] = None
    sp: Optional[str] = None
    tp: Optional[str] = None
    attn: str = "auto"          # auto | local | ring | ulysses
    remat: bool = False
    remat_policy: str = "full"  # full | dots | dots_no_batch
    num_microbatches: Optional[int] = None

    def __post_init__(self):
        if self.attn not in ATTN_IMPLS:
            raise ValueError(f"unknown attn impl {self.attn!r}; expected "
                             f"one of {ATTN_IMPLS}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; "
                             f"expected one of {sorted(REMAT_POLICIES)}")

    def data_axes(self):
        return tuple(a for a in (self.dp, self.sp) if a)


def param_shapes(cfg: TransformerConfig) -> dict:
    """Shape of every parameter, in the layout of ``init_params``."""
    D, Hd, F_, L, V = (cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff,
                       cfg.n_layers, cfg.vocab)
    return {
        "embed": (V, D),
        "layers": {
            "attn_norm": (L, D), "wq": (L, D, Hd), "wk": (L, D, Hd),
            "wv": (L, D, Hd), "wo": (L, Hd, D), "mlp_norm": (L, D),
            "w_gate": (L, D, F_), "w_up": (L, D, F_), "w_down": (L, F_, D),
        },
        "final_norm": (D,),
    }


def param_specs(pcfg: ParallelConfig) -> dict:
    """PartitionSpec dict matching ``init_params`` output: layer weights
    split over pp on the stacked dim and over tp on the head/ffn dim."""
    pp, tp = pcfg.pp, pcfg.tp
    return {
        "embed": P(None, None),
        "layers": {
            "attn_norm": P(pp, None),
            "wq": P(pp, None, tp),
            "wk": P(pp, None, tp),
            "wv": P(pp, None, tp),
            "wo": P(pp, tp, None),
            "mlp_norm": P(pp, None),
            "w_gate": P(pp, None, tp),
            "w_up": P(pp, None, tp),
            "w_down": P(pp, tp, None),
        },
        "final_norm": P(None),
    }


def init_params(cfg: TransformerConfig, *, seed: int, device=None) -> dict:
    """Parameter dict; weights normal(0.02) drawn in fp32 from a
    ``torch.Generator`` on ``device`` seeded with ``seed``, then cast to
    ``cfg.dtype``; norm weights ones. (The draws differ from the JAX
    package's for the same seed; tests carry its params across with
    ``convert.params_from_jax``.)"""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = param_shapes(cfg)

    def w(shape):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        return x.normal_(0.0, 0.02, generator=gen).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    layers = {name: (ones if name.endswith("norm") else w)(shape)
              for name, shape in shapes["layers"].items()}
    return {"embed": w(shapes["embed"]), "layers": layers,
            "final_norm": ones(shapes["final_norm"])}


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer weights ``layers``
    (``params["layers"]``, or a pipeline stage's block of it)."""
    return {name: w[i] for name, w in layers.items()}


def mlp(lp: dict, x: torch.Tensor, tp: Optional[str] = None) -> torch.Tensor:
    """Residual SwiGLU block; gate and up in fp32, down in x's dtype.
    With ``tp``, gate/up are column-parallel and down row-parallel."""
    h = rmsnorm(x, lp["mlp_norm"])
    if tp:
        h = tp_copy(h, tp)
    g = F.silu((h @ lp["w_gate"]).float())
    u = (h @ lp["w_up"]).float()
    d = (g * u).to(x.dtype) @ lp["w_down"]
    if tp:
        d = tp_allreduce(d, tp)
    return x + d.to(x.dtype)


def qkv(lp: dict, h: torch.Tensor, head_dim: int):
    B, T = h.shape[:2]
    return tuple((h @ lp[w]).reshape(B, T, -1, head_dim)
                 for w in ("wq", "wk", "wv"))


def unembed(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Tied unembed in the model dtype, then fp32 logits."""
    return (x @ embed.T.to(x.dtype)).float()


def _attend(q, k, v, pcfg: ParallelConfig):
    impl = pcfg.attn
    if impl == "auto":
        impl = "ring" if pcfg.sp else "local"
    if impl == "local" or not pcfg.sp:
        # K1 forward, K2/K3 backward on CUDA; the plain path on the CPU
        return flash_attention(q, k, v, causal=True)
    if impl == "ring":
        return ring_attention(q, k, v, axis=pcfg.sp, causal=True)
    return ulysses_attention(q, k, v, axis=pcfg.sp, causal=True)


def _layer(lp: dict, x: torch.Tensor, cos, sin, positions,
           cfg: TransformerConfig, pcfg: ParallelConfig) -> torch.Tensor:
    """One block on local shards: attention then SwiGLU, each residual.
    x: [B_l, T_l, D] (tp-replicated); H/tp heads on a tp rank."""
    B, T = x.shape[:2]
    h = rmsnorm(x, lp["attn_norm"])
    if pcfg.tp:
        h = tp_copy(h, pcfg.tp)
    q, k, v = qkv(lp, h, cfg.head_dim)
    q = apply_rotary(q, cos, sin, positions=positions)
    k = apply_rotary(k, cos, sin, positions=positions)
    o = _attend(q, k, v, pcfg).reshape(B, T, -1) @ lp["wo"]  # row-parallel
    if pcfg.tp:
        o = tp_allreduce(o, pcfg.tp)
    x = x + o.to(x.dtype)
    return mlp(lp, x, pcfg.tp)


def _save_policy(saved: frozenset):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def _layer_fn(pcfg: ParallelConfig):
    """``_layer`` for ``pcfg``, checkpointed as it asks when autograd
    records. Every rank of a group recomputes the same layers in the
    same order, so the recompute's collectives match across ranks."""
    layer = functools.partial(_layer, pcfg=pcfg)
    if not (pcfg.remat and torch.is_grad_enabled()):
        return layer
    saved = REMAT_POLICIES[pcfg.remat_policy]
    kwargs = {} if saved is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_policy(saved))}
    # the recompute runs inside the backward, on autograd's own thread
    # for CUDA tensors: carry the mesh its collectives resolve against
    return functools.partial(checkpoint, with_current_mesh(layer),
                             use_reentrant=False, **kwargs)


def _stack_fn(cfg, pcfg, cos, sin, positions):
    """Run the (locally held) layer stack over one activation."""
    layer = _layer_fn(pcfg)

    def run(layers, x):
        for i in range(layers["wq"].shape[0]):
            x = layer(layer_params(layers, i), x, cos, sin, positions, cfg)
        return x
    return run


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            pcfg: ParallelConfig = ParallelConfig()) -> torch.Tensor:
    """tokens [B_l, T_l] (integer) -> logits [B_l, T_l, V] (fp32).

    Call directly for the oracle, or per rank with a mesh bound (on this
    rank's param shards) for SPMD."""
    T = tokens.shape[1]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq,
                                theta=cfg.rope_theta, device=tokens.device)
    positions = torch.arange(T, device=tokens.device)
    if pcfg.sp:
        positions = axis_index(pcfg.sp) * T + positions
    x = params["embed"][tokens]
    stack = _stack_fn(cfg, pcfg, cos, sin, positions)
    if pcfg.pp:
        x = pipeline_spmd(stack, params["layers"], x, axis=pcfg.pp,
                          num_microbatches=pcfg.num_microbatches)
    else:
        x = stack(params["layers"], x)
    x = rmsnorm(x, params["final_norm"])
    return unembed(x, params["embed"])


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig,
            pcfg: ParallelConfig = ParallelConfig()) -> torch.Tensor:
    """Mean next-token cross-entropy over fp32 logits; batch holds
    ``tokens`` and ``targets``, both [B, T] integer. Per rank, the LOCAL
    mean; the train step reduces it over the data axes."""
    logits = forward(params, batch["tokens"], cfg, pcfg)
    return F.cross_entropy(logits.flatten(0, 1),
                           batch["targets"].flatten().long())


def param_leaves(params: dict) -> list:
    """The param tensors in the dict's order (embed, layers, final_norm)."""
    return [leaf for v in params.values()
            for leaf in (param_leaves(v) if isinstance(v, dict) else [v])]


def _trainable(params: dict) -> list:
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return leaves


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw(lr)`` as ``make_train_step`` takes it:
    ``init(params)`` marks the param tensors as trainable and returns the
    optimizer state, a ``torch.optim.AdamW`` over them with optax's
    defaults (weight decay 1e-4, where torch's own default is 1e-2). Its
    moments are kept in the params' dtype, as optax keeps them."""
    lr: float = 3e-4

    def init(self, params: dict) -> torch.optim.Optimizer:
        return torch.optim.AdamW(_trainable(params), lr=self.lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd(lr)`` as ``make_train_step`` takes it: plain gradient
    descent, no momentum."""
    lr: float

    def init(self, params: dict) -> torch.optim.Optimizer:
        return torch.optim.SGD(_trainable(params), lr=self.lr)


def make_train_step(cfg: TransformerConfig,
                    pcfg: ParallelConfig = ParallelConfig(), mesh=None,
                    optimizer=None):
    """``(step, optimizer)`` with ``step(params, opt_state, batch) ->
    (params, opt_state, loss)``, the JAX call shape; ``opt_state =
    optimizer.init(params)``. The step updates the params in place and
    returns them, and the loss as a 0-d device tensor (no host sync).
    ``optimizer`` is any object whose ``init(params)`` returns a
    ``torch.optim.Optimizer`` over ``param_leaves(params)`` (default
    ``AdamW()``, optax's ``adamw(3e-4)``).

    With ``mesh`` (a ``DeviceMesh`` from ``parallel.build_mesh``), the
    step is this rank's body of the reference's shard_map'd step: params
    are this rank's shards by ``param_specs(pcfg)``
    (``convert.shard_params``), so the optimizer state built over them
    is sharded alike; ``batch`` is the full global batch, of which the
    step takes this rank's block by ``P(dp, sp)``; gradients are reduced
    leaf by leaf as the reference's are, and the loss returned is the
    global mean, the same on every rank."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh from "
                        f"parallel.build_mesh, got {type(mesh).__name__}")
    optimizer = optimizer or AdamW()
    specs = param_leaves(param_specs(pcfg))
    batch_spec = P(pcfg.dp, pcfg.sp)

    def reduce_grads(params):
        # Gradient calculus (psum transposes to psum, so per-rank grads
        # equal d(sum over ranks of loss_r)/d leaf):
        # * tp: the layer uses tp_copy/tp_allreduce (Megatron f/g with
        #   JAX's transposes), so every tp rank's grads are already the
        #   true single-counted gradient: no reduction.
        # * pp: the pipeline's output broadcast sums the n_pp redundant
        #   loss copies' cotangents into every path, so divide by n_pp;
        #   pp-replicated leaves (embed, final_norm) then need their
        #   per-rank halves psum'd over pp.
        # * dp/sp: distinct data shards: pmean.
        n_pp = axis_size(pcfg.pp) if pcfg.pp else 1
        for p, spec in zip(param_leaves(params), specs):
            g = p.grad / n_pp if pcfg.pp else p.grad
            if pcfg.pp and pcfg.pp not in spec:
                g = psum(g, pcfg.pp)
            for ax in pcfg.data_axes():
                g = pmean(g, ax)
            p.grad = g

    def local_step(params, opt_state, batch):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch, cfg, pcfg)
        loss.backward()
        loss = loss.detach()
        with torch.no_grad():
            reduce_grads(params)
            for ax in pcfg.data_axes():
                loss = pmean(loss, ax)
        opt_state.step()
        return params, opt_state, loss

    if mesh is None:
        return local_step, optimizer

    def step(params, opt_state, batch):
        with bind_mesh(mesh):
            local = {k: local_shard(x, batch_spec, mesh)
                     for k, x in batch.items()}
            return local_step(params, opt_state, local)

    return step, optimizer
