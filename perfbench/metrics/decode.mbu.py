"""The decode steps' share of the card's memory bandwidth: the bytes
their inputs need (accounting.decode_step_bytes: every parameter once,
the valid K/V rows of the active slots, the new rows, the fp32 logits)
at 3.35 TB/s, over the device time of the kernels the steps launched."""

from perfbench.accounting import PEAK_BYTES_PER_S, decode_step_bytes
from perfbench.windows import calls, share, timeline


def read(rec):
    tl = timeline(rec)
    if rec["kind"] != "serve" or tl is None:
        return None
    steps = calls(rec, "step")
    need = sum(decode_step_bytes(rec["shape"], n, valid)
               for _, _, _, (n, valid) in steps)
    spent = sum(t1 - t0 for _, t0, t1 in tl.inside("engine.step")) / 1e9
    return share(need / PEAK_BYTES_PER_S, spent) if steps else None
