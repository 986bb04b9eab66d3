"""Ulysses-style sequence parallelism: head↔sequence all-to-all
(counterpart of ``ray_tpu/parallel/ulysses.py``).

An alternative SP schedule to ring attention: an all-to-all over the
``sp`` axis converts seq-sharded/head-full activations into
seq-full/head-sharded ones, runs ordinary (full-sequence) attention on
the local heads, then converts back. Two all-to-alls per attention.

Call inside ``shard_map``; q/k/v: [B, T_local, H, D], H % sp == 0.
"""

from __future__ import annotations

from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.parallel.collectives import all_to_all


def _seq_to_heads(x, axis):
    # [B, T/n, H, D] → [B, T, H/n, D]
    return all_to_all(x, axis, split_dim=2, concat_dim=1, tiled=True)


def _heads_to_seq(x, axis):
    # [B, T, H/n, D] → [B, T/n, H, D]
    return all_to_all(x, axis, split_dim=1, concat_dim=2, tiled=True)


def ulysses_attention(q, k, v, *, axis: str = "sp", causal: bool = True,
                      sm_scale: float | None = None, attn_fn=None):
    """Returns [B, T_local, H, D]. ``attn_fn(q, k, v, causal=, sm_scale=)``
    runs full attention on head-sharded tensors (defaults to the plain
    ``ops.attention.attention``, as the reference's does)."""
    D = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else D ** -0.5
    qh = _seq_to_heads(q, axis)
    kh = _seq_to_heads(k, axis)
    vh = _seq_to_heads(v, axis)
    attn_fn = attn_fn or attention
    oh = attn_fn(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    return _heads_to_seq(oh, axis)
