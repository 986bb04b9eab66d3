"""The training window's share of the card's bf16 peak: the step's FLOPs
(accounting.train_flops: 6 per parameter and token plus causal
attention forward and backward, no recompute) times the steps, over the
window at 989 TFLOP/s."""

from perfbench.accounting import PEAK_FLOPS, train_flops
from perfbench.windows import share, window_s


def read(rec):
    if rec["kind"] != "train" or rec["steps"] == 0:
        return None
    flops = rec["steps"] * train_flops(rec["n_params"], rec["shape"],
                                       rec["batch"], rec["seq_len"])
    return share(flops / PEAK_FLOPS["bf16"], window_s(rec))
