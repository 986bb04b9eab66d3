"""Wall of the engine's prefills in the window per 1,000 prompt tokens;
each call ends in a host read of the first token."""

from perfbench.windows import calls


def read(rec):
    if rec["kind"] != "serve":
        return None
    pre = calls(rec, "prefill")
    tokens = sum(n for _, _, _, n in pre)
    if not tokens:
        return None
    return sum(b - a for _, a, b, _ in pre) / 1e6 / tokens * 1000
