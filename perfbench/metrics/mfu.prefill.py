"""The prefills' share of the card's bf16 peak: the model FLOPs of every
prompt prefilled in the window (accounting.prefill_flops: causal
attention over the pairs the mask keeps, logits for the last row only)
over the prefills' wall at 989 TFLOP/s."""

from perfbench.accounting import PEAK_FLOPS, prefill_flops
from perfbench.windows import calls, share


def read(rec):
    if rec["kind"] != "serve":
        return None
    pre = calls(rec, "prefill")
    flops = sum(prefill_flops(rec["shape"], T) for _, _, _, T in pre)
    wall = sum(b - a for _, a, b, _ in pre) / 1e9
    return share(flops / PEAK_FLOPS["bf16"], wall) if pre else None
