"""The serving window closes even when the scheduler's close leaves a
request unresolved: ``DecodeScheduler.aclose()`` cancels its loop, and a
request whose prefill is in flight at that moment is in neither its
queue nor its batch, so its future never resolves."""

import asyncio
import time

import numpy as np

from perfbench.kinds import serve_closed_loop
from perfbench.timed_engine import TimedEngine


class _Engine:
    slots = 1

    def prefill(self, slot, prompt):
        return 1

    def step(self, tokens):
        return {s: 2 for s in tokens}


class _SlowReturn(TimedEngine):
    """Stamps the first token, then holds the call: the window sees the
    token while the scheduler still awaits the prefill."""

    def prefill(self, slot, prompt):
        tok = super().prefill(slot, prompt)
        if self.prefills > 1:
            time.sleep(0.5)
        return tok


class _Traffic:
    clients = 2

    def request(self, client, rnd):
        return np.arange(3), 1


def test_the_window_closes_past_an_orphaned_admission():
    engine = _SlowReturn(_Engine())
    t = time.perf_counter()
    rec = asyncio.run(asyncio.wait_for(
        serve_closed_loop._drive(engine, _Traffic(), 0.2), timeout=30))
    assert time.perf_counter() - t < 20
    assert rec["t1"] > rec["t0"]
    assert all(r.stamps for r in rec["requests"])
