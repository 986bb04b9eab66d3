"""The whole serving window's share of the card's bf16 peak: the model
FLOPs of every prompt prefilled and every token decoded in the window
(no recompute; attention over valid positions only; prefill logits for
the last row only) over the window at 989 TFLOP/s; an engine call that
straddles the window's start or close counts by the share inside."""

from perfbench.accounting import PEAK_FLOPS, decode_step_flops, prefill_flops
from perfbench.windows import overlap, share, window_s


def read(rec):
    if rec["kind"] != "serve":
        return None
    s = rec["shape"]
    flops = sum(overlap(rec, a, b) * (prefill_flops(s, work)
                                      if kind == "prefill"
                                      else decode_step_flops(s, *work))
                for kind, a, b, work in rec["calls"])
    return share(flops / PEAK_FLOPS["bf16"], window_s(rec))
