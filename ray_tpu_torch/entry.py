"""Entry point (counterpart of ``__graft_entry__.entry``)."""

from __future__ import annotations

import functools

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import (TransformerConfig, forward,
                                              init_params)


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
