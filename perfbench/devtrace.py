"""The device trace of a traced run (``--trace 1``), reduced to what the
metric readers need.

``Trace`` wraps ``torch.profiler`` (CPU and CUDA activities) around the
run and, when stopped, keeps only the device work: one (name, start,
end) per kernel, copy or memset, on the benchmark's host clock
(``time.perf_counter_ns``), mapped there through a marker span recorded
at the start. ``Timeline`` answers the readers' questions over a window:
busy time (the union of the intervals), time by name and by kernel
class, the kernels that ran inside host spans of a kind, and the idle
gaps by what the host was doing.

Frozen copies, marked with their origin: ``device_summary`` and
``kernel_class`` (``chip_smoke.py``'s ``device_summary`` and
``_kernel_class``), over intervals instead of profiler events.
"""

from __future__ import annotations

import bisect
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

CLOCK_MARK = "perfbench.clock"

# --- copied from chip_smoke.py (_MATMUL_NAMES, _kernel_class): the
# port's own kernels, the library's matrix products (cuBLAS names), and
# everything else (elementwise, casts, copies, reductions, optimizer).
_MATMUL_NAMES = ("nvjet", "gemm", "gemv", "cutlass", "xmma")


def kernel_class(name: str) -> str:
    if "flash_" in name:
        return "port_kernels"
    if any(t in name for t in _MATMUL_NAMES):
        return "matmul"
    return "other"


# --- copied from chip_smoke.py (device_summary), over intervals.
def device_summary(intervals) -> dict:
    """Over device work (name, t0, t1) in ns: the summed ms, the kernel
    launches and copies, one interval each, and per name its ms and
    count."""
    by_name: dict = {}
    for name, t0, t1 in intervals:
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (t1 - t0) / 1e6, count + 1)
    copies = sum(count for name, (_, count) in by_name.items()
                 if name.startswith(("Memcpy", "Memset")))
    return {"busy_ms": sum(ms for ms, _ in by_name.values()),
            "kernel_launches": len(intervals) - copies, "copies": copies,
            "by_name": by_name}


class Trace:
    """A profiler window: ``start()``, the work, ``stop()`` -> the
    device intervals on ``perf_counter_ns``."""

    def __init__(self):
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._mark = None
        self._wall_offset = None

    def start(self) -> None:
        self._prof.__enter__()
        self._wall_offset = time.time_ns() - time.perf_counter_ns()
        self._mark = time.perf_counter_ns()
        with record_function(CLOCK_MARK):
            pass

    def stop(self) -> list:
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        offset = None
        work = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    t0 = e.start_ns()
                    work.append((e.name(), t0, t0 + e.duration_ns()))
            elif offset is None and e.name() == CLOCK_MARK:
                offset = e.start_ns() - self._mark
        if offset is None:  # the profiler's clock is the wall clock
            offset = self._wall_offset
        self._prof = None
        work.sort(key=lambda w: w[1])
        return [(n, t0 - offset, t1 - offset) for n, t0, t1 in work]


def _merge(intervals, w0, w1):
    """The union of the intervals clipped to [w0, w1], sorted."""
    out = []
    for _, t0, t1 in intervals:
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


class Timeline:
    """Device intervals (sorted by start), clipped to the window
    [w0, w1], and host spans (label, t0, t1), all in ns."""

    def __init__(self, intervals, spans, w0: int, w1: int):
        self.w0, self.w1 = int(w0), int(w1)
        self.work = [(n, max(t0, self.w0), min(t1, self.w1))
                     for n, t0, t1 in intervals
                     if t1 > self.w0 and t0 < self.w1]
        self.spans = sorted(spans, key=lambda s: s[1])
        self._span_starts = [s[1] for s in self.spans]

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in
                   _merge(self.work, self.w0, self.w1)) / 1e9

    def span_at(self, t: int):
        """The host span that holds time t, or None."""
        i = bisect.bisect_right(self._span_starts, t) - 1
        if i >= 0 and self.spans[i][1] <= t <= self.spans[i][2]:
            return self.spans[i]
        return None

    def inside(self, label: str) -> list:
        """The device intervals that start inside a host span of that
        label (whose host call waited for them: see TimedEngine)."""
        out = []
        for w in self.work:
            s = self.span_at(w[1])
            if s is not None and s[0] == label:
                out.append(w)
        return out

    def share_in_spans(self) -> float:
        """Share of the device time whose work started inside a host
        span: how well the trace's clock was mapped onto the host's."""
        total = sum(t1 - t0 for _, t0, t1 in self.work)
        held = sum(t1 - t0 for _, t0, t1 in self.work
                   if self.span_at(t0) is not None)
        return held / total if total else 0.0

    def by_class(self) -> dict:
        out: dict = {}
        for name, (ms, _) in device_summary(self.work)["by_name"].items():
            cls = kernel_class(name)
            out[cls] = out.get(cls, 0.0) + ms / 1e3
        return out

    def top_ops(self, n: int = 10) -> list:
        rows = device_summary(self.work)["by_name"]
        top = sorted(rows.items(), key=lambda r: -r[1][0])[:n]
        return [[name[:120], ms / 1e3] for name, (ms, _) in top]

    def idle_by_host(self, n: int = 10) -> list:
        """Idle device time in the window, summed by the host span that
        held each gap's midpoint ("outside spans" where none did)."""
        merged = _merge(self.work, self.w0, self.w1)
        edges = [self.w0] + [t for iv in merged for t in iv] + [self.w1]
        out: dict = {}
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            s = self.span_at((g0 + g1) // 2)
            label = s[0] if s is not None else "outside spans"
            out[label] = out.get(label, 0.0) + (g1 - g0) / 1e9
        return sorted(([k, v] for k, v in out.items()),
                      key=lambda r: -r[1])[:n]


def stop(trace):
    """``trace.stop()`` and the seconds it took, or (None, 0.0) for no
    trace."""
    if trace is None:
        return None, 0.0
    t = time.perf_counter()
    work = trace.stop()
    return work, time.perf_counter() - t
