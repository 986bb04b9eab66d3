"""Decoder-only transformer (Llama-style), oracle mode.

Counterpart of ``ray_tpu/models/transformer.py`` on one device: the
same config, the same parameter dict (JAX key names, layer weights
stacked on a leading ``[L, ...]`` dim, so params convert one to one) and
the same math, with a Python loop over layers in place of ``lax.scan``.
Parallel meshes, the loss's gradient and the train step are later
slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

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


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh axis names. The port runs the oracle only: every axis must be
    ``None`` until ``parallel/`` is ported."""
    dp: Optional[str] = None
    pp: Optional[str] = None
    sp: Optional[str] = None
    tp: Optional[str] = None

    def __post_init__(self):
        axes = {a: getattr(self, a) for a in ("dp", "pp", "sp", "tp")
                if getattr(self, a) is not None}
        if axes:
            raise NotImplementedError(
                f"parallel axes {axes} are not ported yet; the port runs "
                "the single-device oracle only")


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


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            pcfg: ParallelConfig = ParallelConfig()) -> torch.Tensor:
    """tokens [B, T] (integer) -> logits [B, T, V] (fp32)."""
    del pcfg  # oracle only; ParallelConfig refuses any axis
    B, T = tokens.shape
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq,
                                theta=cfg.rope_theta, device=tokens.device)
    positions = torch.arange(T, device=tokens.device)
    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = rmsnorm(x, lp["attn_norm"])
        q, k, v = qkv(lp, h, cfg.head_dim)
        q = apply_rotary(q, cos, sin, positions=positions)
        k = apply_rotary(k, cos, sin, positions=positions)
        o = flash_attention(q, k, v, causal=True).reshape(B, T, -1)
        x = x + (o @ lp["wo"]).to(x.dtype)
        x = mlp(lp, x)
    x = rmsnorm(x, params["final_norm"])
    return unembed(x, params["embed"])
