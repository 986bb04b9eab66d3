"""Share of the traced window in which no kernel, copy or memset ran on
the card (1 - the union of the device intervals over the window)."""

from perfbench.windows import timeline


def read(rec):
    tl = timeline(rec)
    if rec["kind"] != "serve" or tl is None:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
