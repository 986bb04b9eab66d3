"""K1-K3's share of their roofline in the training window: the least
time of every K1 (forward and the remat recompute), K2 and K3 call at
the step's shape (accounting.k1_bound, bwd_bound), over the device time
of those kernels, found by name."""

from perfbench.accounting import bwd_bound, k1_bound
from perfbench.windows import share, timeline

KERNELS = (("flash_bwd_dkv", "dkv"), ("flash_bwd_dq", "dq"),
           ("flash_fwd", None))


def read(rec):
    tl = timeline(rec)
    if rec["kind"] != "train" or tl is None:
        return None
    s = rec["shape"]
    args = (rec["batch"], rec["seq_len"], s.n_heads, s.head_dim, "bf16", True)
    bound = spent = 0.0
    for name, t0, t1 in tl.work:
        for key, kernel in KERNELS:
            if key in name:
                bound += (k1_bound(*args) if kernel is None
                          else bwd_bound(*args, kernel))[0]
                spent += (t1 - t0) / 1e9
                break
    return share(bound, spent) if spent else None
