"""Normalization ops (counterpart of ``ray_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, times the fp32 weight, cast back to x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)
