"""K1's share of its roofline in the window's prefills: the least time
of every call (accounting.k1_bound: causal, q/k/v read once, O and lse
written once, bf16 operations at 989 TFLOP/s or bytes at 3.35 TB/s, the
larger) over the device time of the flash forward kernels the prefills
launched. One call per layer and prefill, at batch 1."""

from perfbench.accounting import k1_bound
from perfbench.windows import calls, share, timeline


def read(rec):
    tl = timeline(rec)
    if rec["kind"] != "serve" or tl is None:
        return None
    s = rec["shape"]
    bound = sum(s.n_layers * k1_bound(1, T, s.n_heads, s.head_dim, "bf16",
                                      True)[0]
                for _, _, _, T in calls(rec, "prefill"))
    spent = sum(t1 - t0 for name, t0, t1 in tl.inside("engine.prefill")
                if "flash_fwd" in name) / 1e9
    return share(bound, spent) if bound else None
