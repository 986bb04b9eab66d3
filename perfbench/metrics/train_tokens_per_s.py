"""Batch tokens of every step dispatched in the window over the window's
seconds; the window ends in a device sync, so every step is done."""

from perfbench.windows import window_s


def read(rec):
    if rec["kind"] != "train" or rec["steps"] == 0:
        return None
    return rec["steps"] * rec["tokens_per_step"] / window_s(rec)
