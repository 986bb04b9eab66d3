"""Ring attention over a mesh axis (counterpart of
``ray_tpu/parallel/ring_attention.py``).

K/V shards rotate around the ``sp`` axis ring through ``ppermute`` while
each rank keeps a blockwise online-softmax accumulator over its local Q
shard, so attention over a sequence of length ``n_sp * T_local`` never
materializes on one device. The block step is plain torch, as the
reference's is plain XLA.

Call inside ``shard_map`` with q/k/v sharded on dim 1 (seq) over
``axis``. Shapes: [batch, seq_local, heads, head_dim].
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.collectives import (axis_index, axis_size,
                                                ppermute_ring)


def _block_attn(q, k, v, q_pos, kv_pos, causal, sm_scale):
    # q: [B,Tq,H,D] k,v: [B,Tk,H,D] (fp32) → scores [B,H,Tq,Tk]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    if causal:
        mask = q_pos[:, None] >= kv_pos[None, :]      # [Tq,Tk]
        s = torch.where(mask[None, None], s, float("-inf"))
    m = s.amax(dim=-1)                                 # [B,H,Tq]
    # Fully-masked rows (no visible keys yet in the ring) → avoid -inf.
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(dim=-1)                                  # [B,H,Tq]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o, m_safe, l


def ring_attention(q, k, v, *, axis: str = "sp", causal: bool = True,
                   sm_scale: float | None = None):
    """Blockwise ring attention. Returns [B, T_local, H, D] in q.dtype."""
    n = axis_size(axis)
    my = axis_index(axis)
    B, T, H, D = q.shape
    sm_scale = sm_scale if sm_scale is not None else D ** -0.5
    ar = torch.arange(T, device=q.device)
    q_pos = my * T + ar

    q32 = q.float()
    o_acc = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    m_acc = torch.full((B, H, T), -1e30, device=q.device)  # finite "-inf"
    l_acc = torch.zeros((B, H, T), device=q.device)
    # K and V travel as one stacked tensor: one ppermute per hop, so every
    # rank's backward issues its sends and receives in the same order
    kv = torch.stack([k.float(), v.float()])
    for i in range(n):
        src = (my - i) % n                       # whose K/V block we hold
        kv_pos = src * T + ar
        o, m, l = _block_attn(q32, kv[0], kv[1], q_pos, kv_pos, causal,
                              sm_scale)
        # online softmax merge
        m_new = torch.maximum(m_acc, m)
        alpha = torch.exp(m_acc - m_new)
        beta = torch.exp(m - m_new)
        l_acc = l_acc * alpha + l * beta
        o_acc = (o_acc * alpha.transpose(1, 2)[..., None]
                 + o * beta.transpose(1, 2)[..., None])
        m_acc = m_new
        # rotate K/V to the next rank; the last hop's result is unused,
        # as the reference's scan carries it
        kv = ppermute_ring(kv, axis)
    l_acc = l_acc.clamp_min(1e-30)
    out = o_acc / l_acc.transpose(1, 2)[..., None]
    return out.to(q.dtype)
