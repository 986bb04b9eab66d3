"""KV-cached autoregressive decoding for the flagship transformer.

Counterpart of ``ray_tpu/models/decode.py``. The KV cache is
preallocated as ``k``/``v`` [L, B, max_len, H, Dh]; ``prefill`` runs the
prompt through the full-sequence layers (the K1 flash kernel on CUDA)
while writing the cache, and ``decode_step`` attends one new token
against the whole cache under a position mask, with the accumulation
dtypes of ``ops.attention.attention``.

Unlike the JAX functions, which return new arrays, these UPDATE THE
CACHE IN PLACE (and return it too): the cache is the largest tensor of
a serving process, and a copy per step would double its traffic.

Oracle: greedy ``generate`` matches per-step argmax of the full
``forward`` on the growing prefix, which pins rope offsets, cache
writes and position masks to the training forward's semantics.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import (TransformerConfig,
                                              layer_params, mlp, qkv,
                                              unembed)
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.rotary import apply_rotary, rope_frequencies


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, *,
                  device=None) -> Dict:
    """Whole-batch cache; ``pos`` (a Python int) is the next position."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": 0}


def _prompt_through_stack(params, tokens, ck, cv, cfg: TransformerConfig):
    """Run tokens [B, T0] through every layer, writing layer l's K/V into
    ``ck[l]``/``cv[l]`` ([B, max_len, H, Dh] views) at rows [0, T0).
    Returns last-token logits [B, V]."""
    B, T0 = tokens.shape
    max_len = ck.shape[2]
    if T0 > max_len:
        raise ValueError(f"prompt ({T0}) exceeds cache max_len "
                         f"({max_len})")
    # tables for the cache length, as decode_step builds them
    cos, sin = rope_frequencies(cfg.head_dim, max_len,
                                theta=cfg.rope_theta, device=tokens.device)
    positions = torch.arange(T0, device=tokens.device)
    x = params["embed"][tokens]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = rmsnorm(x, lp["attn_norm"])
        q, k, v = qkv(lp, h, cfg.head_dim)
        q = apply_rotary(q, cos, sin, positions=positions)
        k = apply_rotary(k, cos, sin, positions=positions)
        o = flash_attention(q, k, v, causal=True).reshape(B, T0, -1)
        x = x + (o @ lp["wo"]).to(x.dtype)
        x = mlp(lp, x)
        ck[i, :, :T0] = k
        cv[i, :, :T0] = v
    x = rmsnorm(x[:, -1], params["final_norm"])
    return unembed(x, params["embed"])


def prefill(params, tokens: torch.Tensor, cache: Dict,
            cfg: TransformerConfig) -> Tuple[torch.Tensor, Dict]:
    """Prompt [B, T0] -> (last-token logits [B, V], cache with pos T0)."""
    logits = _prompt_through_stack(params, tokens, cache["k"], cache["v"],
                                   cfg)
    cache["pos"] = tokens.shape[1]
    return logits, cache


def _attend_cache(q, ck, cv, valid, sm_scale):
    """One query per row against the whole cache: q [B, 1, H, D], ck/cv
    [B, max_len, H, D], valid [B or 1, 1, max_len]. fp32 scores and
    softmax, p cast to the cache dtype, P·V accumulated in fp32."""
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), ck.float()) * sm_scale
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1).to(cv.dtype)
    return torch.einsum("bhk,bkhd->bhd", p.float(), cv.float()).to(q.dtype)


def _decode_layers(params, x, cache, cfg, rotate, write, valid):
    """The decode stack shared by both caches: x [B, 1, D_model]."""
    B = x.shape[0]
    sm_scale = cfg.head_dim ** -0.5
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = rmsnorm(x, lp["attn_norm"])
        q, k, v = qkv(lp, h, cfg.head_dim)
        q, k = rotate(q), rotate(k)
        ck, cv = cache["k"][i], cache["v"][i]
        write(ck, k)
        write(cv, v)
        o = _attend_cache(q, ck, cv, valid, sm_scale)
        x = x + (o.reshape(B, 1, -1) @ lp["wo"]).to(x.dtype)
        x = mlp(lp, x)
    x = rmsnorm(x[:, 0], params["final_norm"])
    return unembed(x, params["embed"])


def decode_step(params, cache: Dict, token: torch.Tensor,
                cfg: TransformerConfig) -> Tuple[torch.Tensor, Dict]:
    """One token [B] in, next-token logits [B, V] out; the cache takes
    the token's K/V at ``pos`` and ``pos`` advances. A full cache raises
    (JAX would clamp the write, torch indexing would fail elsewhere)."""
    pos = int(cache["pos"])
    max_len = cache["k"].shape[2]
    if pos >= max_len:
        raise ValueError(f"KV cache full (pos {pos} of {max_len}); "
                         f"allocate a larger max_len")
    dev = token.device
    cos, sin = rope_frequencies(cfg.head_dim, max_len,
                                theta=cfg.rope_theta, device=dev)
    positions = torch.tensor([pos], device=dev)
    valid = (torch.arange(max_len, device=dev) <= pos)[None, None, :]

    def write(c, new):
        c[:, pos] = new[:, 0]

    logits = _decode_layers(
        params, params["embed"][token][:, None, :], cache, cfg,
        lambda t: apply_rotary(t, cos, sin, positions=positions), write,
        valid)
    cache["pos"] = pos + 1
    return logits, cache


# ------------------------------------------------------------- slot cache
# Continuous batching (serve/decode_scheduler.py) needs a decode offset
# per SLOT: ``pos`` is a [slots] tensor. ``slot_prefill`` rewrites rows
# [0, T0) of its slot and resets that slot's pos, so a reused slot never
# attends its predecessor's K/V. ``slot_decode_step`` writes every row's
# K/V at the row's own pos but advances pos only where ``active``; an
# inactive row is re-entered only through ``slot_prefill``, so what it
# takes meanwhile is never read.


def init_slot_cache(cfg: TransformerConfig, slots: int, max_len: int, *,
                    device=None) -> Dict:
    """KV cache with an independent decode offset per batch row."""
    cache = init_kv_cache(cfg, slots, max_len, device=device)
    cache["pos"] = torch.zeros((slots,), dtype=torch.long,
                               device=cache["k"].device)
    return cache


def slot_prefill(params, tokens: torch.Tensor, cache: Dict, slot: int,
                 cfg: TransformerConfig) -> Tuple[torch.Tensor, Dict]:
    """One prompt [1, T0] into cache row ``slot``; returns (last-token
    logits [1, V], cache with ``pos[slot] = T0``)."""
    slots = cache["k"].shape[1]
    if not 0 <= slot < slots:
        raise ValueError(f"slot {slot} out of range [0, {slots})")
    s = slice(slot, slot + 1)
    logits = _prompt_through_stack(params, tokens, cache["k"][:, s],
                                   cache["v"][:, s], cfg)
    cache["pos"][slot] = tokens.shape[1]
    return logits, cache


def _rotary_rows(x, cos, sin, pos):
    """apply_rotary with one position per ROW: x [B, 1, H, D], pos [B]."""
    c = cos[pos][:, None, None, :]
    s = sin[pos][:, None, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def slot_decode_step(params, cache: Dict, token: torch.Tensor,
                     active: torch.Tensor,
                     cfg: TransformerConfig) -> Tuple[torch.Tensor, Dict]:
    """One continuous-batching step: token [B] in, logits [B, V] out.
    Every row writes its K/V at its own pos and attends [0, pos]; only
    ``active`` rows advance. Inactive rows' logits are garbage.

    An active row must have ``pos < max_len`` (the engine checks, as the
    JAX engine does). Only an inactive row can sit at ``max_len``; its
    write and rope lookup are clamped to the last row, where JAX drops
    the write: either way nothing reads it."""
    B = token.shape[0]
    max_len = cache["k"].shape[2]
    pos = cache["pos"]
    at = pos.clamp(max=max_len - 1)
    dev = token.device
    cos, sin = rope_frequencies(cfg.head_dim, max_len,
                                theta=cfg.rope_theta, device=dev)
    valid = (torch.arange(max_len, device=dev)[None, None, :]
             <= pos[:, None, None])
    rows = torch.arange(B, device=dev)

    def write(c, new):
        c[rows, at] = new[:, 0]

    logits = _decode_layers(
        params, params["embed"][token][:, None, :], cache, cfg,
        lambda t: _rotary_rows(t, cos, sin, at), write, valid)
    cache["pos"] = torch.where(active, pos + 1, pos)
    return logits, cache


def generate(params, prompt: torch.Tensor, cfg: TransformerConfig, *,
             steps: int, generator: Optional[torch.Generator] = None,
             temperature: float = 0.0,
             max_len: Optional[int] = None) -> torch.Tensor:
    """Autoregressive sampling from prompt [B, T0]: greedy at temperature
    0, categorical otherwise (an explicit ``generator`` is required then;
    a silent fixed seed would make every call return the same
    completion). Returns tokens [B, steps]."""
    B, T0 = prompt.shape
    max_len = max_len or min(cfg.max_seq, T0 + steps)
    if T0 + steps > max_len:
        raise ValueError(f"prompt ({T0}) + steps ({steps}) exceeds "
                         f"max_len ({max_len})")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires an explicit generator")
    cache = init_kv_cache(cfg, B, max_len, device=prompt.device)
    logits, cache = prefill(params, prompt, cache, cfg)
    toks = []
    for i in range(steps):
        if temperature > 0.0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        # the last token needs no successor logits: skip its step
        if i < steps - 1:
            logits, cache = decode_step(params, cache, tok, cfg)
    return torch.stack(toks, dim=1)
