"""Device ms a training step spends in kernels that are neither the
port's own nor matrix products (trace.kernel_class "other": elementwise
work, casts, copies, reductions, the optimizer), over the window."""

from perfbench.windows import timeline


def read(rec):
    tl = timeline(rec)
    if rec["kind"] != "train" or tl is None or rec["steps"] == 0:
        return None
    return tl.by_class().get("other", 0.0) * 1e3 / rec["steps"]
