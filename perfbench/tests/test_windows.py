"""The window arithmetic of the end-to-end readers: a stall inside the
window lowers the rate and raises the tail; a failed request counts as
missing; a reader with nothing to read returns None."""

import math

from perfbench import core
from perfbench.accounting import Shape
from perfbench.timed_engine import Request
from perfbench.windows import percentile

MS = 1_000_000


def _serve_rec(stall_ms=0, fail=False):
    """Four requests, each a token every 10 ms over one second; with a
    stall, every tenth gap of every request is stall_ms longer."""
    reqs = []
    for i in range(4):
        r = Request(i, 0, [1, 2, 3], 100)
        r.submit_ns = 0
        t, stamps = 2 * MS, []
        while t <= 1000 * MS:
            stamps.append(t)
            t += 10 * MS + (stall_ms * MS if len(stamps) % 10 == 0 else 0)
        r.stamps = [s for s in stamps if s <= 1000 * MS]
        reqs.append(r)
    calls = [("step", t - 2 * MS, t, (4, 0))
             for t in sorted({t for r in reqs for t in r.stamps})]
    late = Request(9, 0, [1], 5)
    late.submit_ns = 100 * MS
    if fail:
        late.error = (150 * MS, "failed")
    else:
        late.stamps = [130 * MS]
    reqs.append(late)
    if not fail:
        calls.append(("prefill", 125 * MS, 130 * MS, 1))
    return {"kind": "serve", "t0": 0, "t1": 1000 * MS, "requests": reqs,
            "calls": calls, "shape": Shape(10, 4, 2, 2, 1, 4)}


def _read(name, rec):
    return core.reader(name)(rec)


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    calm, stalled = _serve_rec(), _serve_rec(stall_ms=30)
    assert _read("output_tokens_per_s", calm) == 401.0
    assert _read("output_tokens_per_s", stalled) < 401.0 * 0.8
    assert _read("itl_p95_ms", calm) == 10.0
    assert _read("itl_p95_ms", stalled) > _read("itl_p95_ms", calm)


def test_ttft_counts_a_failed_request_as_missing():
    assert _read("ttft_p95_ms", _serve_rec()) == 30.0
    assert _read("ttft_p95_ms", _serve_rec(fail=True)) is None


def test_a_call_across_the_close_counts_by_its_share():
    rec = _serve_rec()
    rec["calls"].append(("step", 998 * MS, 1002 * MS, (4, 0)))
    assert _read("output_tokens_per_s", rec) == 403.0


def test_percentile_is_numpys_linear_one():
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5
    assert percentile([], 95) is None
    assert percentile([1.0] * 99 + [math.inf], 50) == 1.0


def test_train_rate_counts_all_steps_over_all_the_window():
    rec = {"kind": "train", "t0": 0, "t1": 2_000 * MS, "steps": 10,
           "tokens_per_step": 400}
    assert _read("train_tokens_per_s", rec) == 2000.0
    stalled = dict(rec, t1=2_500 * MS)
    assert _read("train_tokens_per_s", stalled) == 1600.0
    assert _read("output_tokens_per_s", rec) is None


def test_device_readers_find_nothing_without_a_trace():
    rec = _serve_rec()
    for name in ("decode.mbu", "idle_share.serve",
                 "flash_fwd_roofline.prefill"):
        assert _read(name, rec) is None
