"""Canonical fixed-point scheduling score, shared by both backends.

A copy of ``ray_tpu/_private/scheduler/scoring.py``.

The reference does its resource arithmetic in fixed point
(src/ray/raylet/scheduling/fixed_point.h) precisely so scheduling decisions
are deterministic; we follow suit so the host backend and the batched
backend produce the same placements (differentially tested in
tests/test_torch_scheduler.py).

Key (lower wins), conceptually one 58-bit integer per (task, node):

    [ util_fp : 21 ][ anti_locality : 21 ][ remote : 1 ][ node_idx : 15 ]

  util_fp       = ceil(max_r (used_r + demand_r) / total_r * 2^20), clamped
  anti_locality = 2^20 - min(locality_bytes >> 10, 2^20 - 1)  (more local
                  arg bytes -> smaller)
  remote        = 0 for the local node, 1 otherwise
  node_idx      = stable index in the tick's node list (final tiebreak)

The reference's JAX kernel runs without x64, so it carries the key as an
(hi, lo) int32 pair compared lexicographically; the port keeps the pair:

    hi = util_fp * 2^10 + (anti_locality >> 11)            (31 bits)
    lo = (anti_locality & 2^11-1) * 2^16 + remote * 2^15 + node_idx  (27 bits)

The hybrid rule sits above the key: if the local node is ready and its
util_fp <= spread_threshold_fp, it wins outright (reference HybridPolicy's
prefer-local-under-threshold behavior, scheduling_policy.h).
"""

from __future__ import annotations

UTIL_SCALE = 1 << 20
UTIL_MAX = (1 << 21) - 1
LOC_MAX = (1 << 20) - 1       # anti-locality values live in [1, 2^20]
NODE_MAX = (1 << 15) - 1

HI_LOC_SHIFT = 11             # low bits of anti_loc carried in `lo`
LO_LOC_MASK = (1 << 11) - 1


def util_fixed_point(used_plus_demand: float, total: float) -> int:
    """ceil((used+demand)/total * 2^20) in int, clamped to 21 bits."""
    if total <= 0:
        return 0
    v = used_plus_demand / total
    fp = int(v * UTIL_SCALE)
    if fp / UTIL_SCALE < v:
        fp += 1
    return min(max(fp, 0), UTIL_MAX)


def anti_locality(locality_bytes: int) -> int:
    return (1 << 20) - min(locality_bytes >> 10, LOC_MAX)


def pack_key(util_fp: int, anti_loc: int, is_local: bool, node_idx: int):
    """(hi, lo) int pair; compare lexicographically (tuples compare so)."""
    hi = (util_fp << 10) | (anti_loc >> HI_LOC_SHIFT)
    lo = ((anti_loc & LO_LOC_MASK) << 16) | \
        ((0 if is_local else 1) << 15) | (node_idx & NODE_MAX)
    return (hi, lo)


def spread_threshold_fp(spread_threshold: float) -> int:
    return int(spread_threshold * UTIL_SCALE)
