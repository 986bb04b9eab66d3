"""Decoder-only transformer (Llama-style), oracle mode.

Counterpart of ``ray_tpu/models/transformer.py`` on one device: the
same config, the same parameter dict (JAX key names, layer weights
stacked on a leading ``[L, ...]`` dim, so params convert one to one) and
the same math, with a Python loop over layers in place of ``lax.scan``,
``torch.utils.checkpoint`` in place of ``jax.checkpoint``, and
``torch.optim.AdamW`` behind optax's ``init`` in place of
``optax.adamw``. Parallel meshes are a later slice.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.rotary import apply_rotary, rope_frequencies


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


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh axis names and the layer options of the JAX ParallelConfig.
    The port runs the oracle only: every axis must be ``None`` until
    ``parallel/`` is ported, so ``attn`` is ``"auto"`` or ``"local"``
    (both the flash kernel) and ``num_microbatches`` (pipeline only)
    must be ``None``. ``remat`` checkpoints every layer under
    ``remat_policy``."""
    dp: Optional[str] = None
    pp: Optional[str] = None
    sp: Optional[str] = None
    tp: Optional[str] = None
    attn: str = "auto"          # auto | local (ring | ulysses need sp)
    remat: bool = False
    remat_policy: str = "full"  # full | dots | dots_no_batch
    num_microbatches: Optional[int] = None

    def __post_init__(self):
        axes = {a: getattr(self, a) for a in ("dp", "pp", "sp", "tp")
                if getattr(self, a) is not None}
        if axes:
            raise NotImplementedError(
                f"parallel axes {axes} are not ported yet; the port runs "
                "the single-device oracle only")
        if self.attn in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn={self.attn!r} needs an sp axis, which is not "
                "ported yet")
        if self.num_microbatches is not None:
            raise NotImplementedError(
                "num_microbatches needs a pp axis, which is not ported yet")
        if self.attn not in ("auto", "local"):
            raise ValueError(f"unknown attn impl {self.attn!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; "
                             f"expected one of {sorted(REMAT_POLICIES)}")


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


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer weights."""
    return {name: w[i] for name, w in params["layers"].items()}


def mlp(lp: dict, x: torch.Tensor) -> torch.Tensor:
    """Residual SwiGLU block; gate and up in fp32, down in x's dtype."""
    h = rmsnorm(x, lp["mlp_norm"])
    g = F.silu((h @ lp["w_gate"]).float())
    u = (h @ lp["w_up"]).float()
    return x + ((g * u).to(x.dtype) @ lp["w_down"]).to(x.dtype)


def qkv(lp: dict, h: torch.Tensor, head_dim: int):
    B, T = h.shape[:2]
    return tuple((h @ lp[w]).reshape(B, T, -1, head_dim)
                 for w in ("wq", "wk", "wv"))


def unembed(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Tied unembed in the model dtype, then fp32 logits."""
    return (x @ embed.T.to(x.dtype)).float()


def _layer(lp: dict, x: torch.Tensor, cos, sin, positions,
           cfg: TransformerConfig) -> torch.Tensor:
    """One block: attention then SwiGLU, each residual. x: [B, T, D]."""
    B, T = x.shape[:2]
    h = rmsnorm(x, lp["attn_norm"])
    q, k, v = qkv(lp, h, cfg.head_dim)
    q = apply_rotary(q, cos, sin, positions=positions)
    k = apply_rotary(k, cos, sin, positions=positions)
    o = flash_attention(q, k, v, causal=True).reshape(B, T, -1)
    x = x + (o @ lp["wo"]).to(x.dtype)
    return mlp(lp, x)


def _save_policy(saved: frozenset):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def _layer_fn(pcfg: ParallelConfig):
    """``_layer``, checkpointed as ``pcfg`` asks when autograd records."""
    if not (pcfg.remat and torch.is_grad_enabled()):
        return _layer
    saved = REMAT_POLICIES[pcfg.remat_policy]
    kwargs = {} if saved is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_policy(saved))}
    return functools.partial(checkpoint, _layer, use_reentrant=False,
                             **kwargs)


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            pcfg: ParallelConfig = ParallelConfig()) -> torch.Tensor:
    """tokens [B, T] (integer) -> logits [B, T, V] (fp32)."""
    T = tokens.shape[1]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq,
                                theta=cfg.rope_theta, device=tokens.device)
    positions = torch.arange(T, device=tokens.device)
    layer = _layer_fn(pcfg)
    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        x = layer(layer_params(params, i), x, cos, sin, positions, cfg)
    x = rmsnorm(x, params["final_norm"])
    return unembed(x, params["embed"])


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig,
            pcfg: ParallelConfig = ParallelConfig()) -> torch.Tensor:
    """Mean next-token cross-entropy over fp32 logits; batch holds
    ``tokens`` and ``targets``, both [B, T] integer."""
    logits = forward(params, batch["tokens"], cfg, pcfg)
    return F.cross_entropy(logits.flatten(0, 1),
                           batch["targets"].flatten().long())


def param_leaves(params: dict) -> list:
    """The param tensors in the dict's order (embed, layers, final_norm)."""
    return [leaf for v in params.values()
            for leaf in (param_leaves(v) if isinstance(v, dict) else [v])]


class AdamW:
    """``optax.adamw(3e-4)`` as ``make_train_step`` takes it:
    ``init(params)`` marks the param tensors as trainable and returns the
    optimizer state, a ``torch.optim.AdamW`` over them with optax's
    defaults (weight decay 1e-4, where torch's own default is 1e-2). Its
    moments are kept in the params' dtype, as optax keeps them."""

    def init(self, params: dict) -> torch.optim.Optimizer:
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)


def make_train_step(cfg: TransformerConfig,
                    pcfg: ParallelConfig = ParallelConfig(), mesh=None,
                    optimizer=None):
    """``(step, optimizer)`` with ``step(params, opt_state, batch) ->
    (params, opt_state, loss)``, the JAX call shape; ``opt_state =
    optimizer.init(params)``. The step updates the params in place and
    returns them, and the loss as a 0-d device tensor (no host sync).
    ``optimizer`` is any object whose ``init(params)`` returns a
    ``torch.optim.Optimizer`` over ``param_leaves(params)`` (default
    ``AdamW()``, optax's ``adamw(3e-4)``)."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...) needs parallel/, which is not "
            "ported yet; the port trains on one device")
    optimizer = optimizer or AdamW()

    def step(params, opt_state, batch):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch, cfg, pcfg)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step, optimizer
