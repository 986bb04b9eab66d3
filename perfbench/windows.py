"""What the metric readers share: the run's window, its stamps and
calls, and percentiles. A reader takes the run's record and returns a
number, or None where it finds nothing to read."""

from __future__ import annotations

import math

import numpy as np

from perfbench.devtrace import Timeline


def percentile(values, q: float):
    """numpy's linear percentile; None for no values or where the
    percentile falls on a missing (infinite) one."""
    if not values:
        return None
    v = float(np.percentile(np.asarray(values, dtype=np.float64), q))
    return v if math.isfinite(v) else None


def window_s(rec: dict) -> float:
    return (rec["t1"] - rec["t0"]) / 1e9


def in_window(rec: dict, t: int) -> bool:
    return rec["t0"] < t <= rec["t1"]


def overlap(rec: dict, a: int, b: int) -> float:
    """The share of the interval [a, b] that lies in the window."""
    if b <= a:
        return float(rec["t0"] < b <= rec["t1"])
    return max(0, min(b, rec["t1"]) - max(a, rec["t0"])) / (b - a)


def tokens_in_window(rec: dict) -> float:
    """The tokens the engine emitted in the window, each call's tokens
    counted by the share of the call that lies in it. A step returns all
    its rows' tokens at once, so a plain count would jump by a whole
    step as the window's end crosses one."""
    return sum(overlap(rec, a, b) * (work[0] if kind == "step" else 1)
               for kind, a, b, work in rec["calls"])


def token_gaps_ms(rec: dict) -> list:
    """Gaps between consecutive tokens of a request, for every token
    stamped in the window."""
    return [(b - a) / 1e6 for r in rec["requests"]
            for a, b in zip(r.stamps, r.stamps[1:]) if in_window(rec, b)]


def ttfts_ms(rec: dict) -> list:
    """Submit to first token of every request sent in the window; one
    that failed or never got its token counts as infinitely late."""
    out = []
    for r in rec["requests"]:
        if not in_window(rec, r.submit_ns):
            continue
        ok = r.stamps and (r.error is None or r.error[0] > r.stamps[0])
        out.append((r.stamps[0] - r.submit_ns) / 1e6 if ok else math.inf)
    return out


def calls(rec: dict, kind: str) -> list:
    """Engine calls of a kind that started and ended in the window."""
    return [c for c in rec["calls"] if c[0] == kind
            and rec["t0"] <= c[1] and c[2] <= rec["t1"]]


def timeline(rec: dict):
    """The device trace over the window, with the host spans, or None
    for an untraced run or a trace that holds no device work."""
    if not rec.get("device_work"):
        return None
    if "_timeline" not in rec:
        spans = [(f"engine.{k}", a, b) for k, a, b, _ in rec.get("calls", [])]
        spans += rec.get("spans", [])
        rec["_timeline"] = Timeline(rec["device_work"], spans, rec["t0"],
                                    rec["t1"])
    return rec["_timeline"]


def share(num: float, den: float):
    """num / den in percent, or None where there is nothing to divide
    by."""
    return 100.0 * num / den if den > 0 else None
