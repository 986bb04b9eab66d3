"""Mean wall of the engine's decode steps in the window; each call ends
in a host read of the step's argmax."""

from perfbench.windows import calls


def read(rec):
    if rec["kind"] != "serve":
        return None
    steps = calls(rec, "step")
    if not steps:
        return None
    return sum(b - a for _, a, b, _ in steps) / len(steps) / 1e6
