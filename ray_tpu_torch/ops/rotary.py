"""Rotary position embeddings (counterpart of ``ray_tpu/ops/rotary.py``)."""

from __future__ import annotations

import torch

from ray_tpu_torch._private.device import resolve_device


def rope_frequencies(head_dim: int, max_seq: int, *,
                     theta: float = 10000.0, device=None):
    """cos/sin tables [max_seq, head_dim // 2] in fp32."""
    device = resolve_device(device)
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    ang = torch.outer(t, inv)
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
                 positions: torch.Tensor | None = None) -> torch.Tensor:
    """x: [B, T, H, D]; cos/sin: [max_seq, D // 2]; positions: [T] token
    positions (default ``arange(T)``). Rotates the two HALVES of each
    head vector (not interleaved pairs), in fp32, cast back."""
    T = x.shape[1]
    if positions is None:
        c, s = cos[:T], sin[:T]
    else:
        c, s = cos[positions], sin[positions]
    c = c[None, :, None, :]
    s = s[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
