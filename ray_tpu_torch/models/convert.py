"""Carry the JAX package's parameters across to the port."""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import TransformerConfig, param_shapes


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
