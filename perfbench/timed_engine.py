"""The engine wrapper that stamps every token.

A frozen copy of ``TimedEngine`` in ``chip_smoke.py``, extended: each
engine call is a host span (kind, start, end, work) and every token it
returns is stamped, on the request it belongs to, at the call's end.
Each engine call ends in a host read of an argmax, so the card is done
when the stamp is taken. Under a trace each call is also a
``torch.profiler.record_function`` span (``engine.prefill``,
``engine.step``). Stamps are ``time.perf_counter_ns()``.
"""

from __future__ import annotations

import time

from torch.profiler import record_function


class Request:
    """One request of the run, as the benchmark sees it."""

    def __init__(self, client: int, rnd: int, prompt, max_tokens: int):
        self.client, self.rnd = client, rnd
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.submit_ns = None
        self.stamps: list = []       # one per token, in order
        self.slot = None
        self.refill = False          # its slot had held another request
        self.tokens = None           # what the scheduler returned
        self.error = None


class TimedEngine:
    """Engine protocol (``slots``, ``prefill``, ``step``) over the
    port's engine; ``register`` tells it which request a prompt is."""

    def __init__(self, engine):
        self.engine = engine
        self.slots = engine.slots
        self.calls: list = []        # (kind, t0_ns, t1_ns, work)
        self._by_prompt: dict = {}
        self._slot_req: dict = {}
        self._used: set = set()
        self.prefills = 0

    def register(self, req: Request) -> None:
        self._by_prompt[id(req.prompt)] = req

    def prefill(self, slot, prompt):
        req = self._by_prompt[id(prompt)]
        t0 = time.perf_counter_ns()
        with record_function("engine.prefill"):
            tok = self.engine.prefill(slot, prompt)
        t1 = time.perf_counter_ns()
        req.stamps.append(t1)
        req.slot, req.refill = slot, slot in self._used
        self._used.add(slot)
        self._slot_req[slot] = req
        self.calls.append(("prefill", t0, t1, len(prompt)))
        self.prefills += 1
        return tok

    def step(self, tokens):
        # each active row attends its cached positions and its own:
        # prompt + tokens so far
        valid = sum(len(self._slot_req[s].prompt)
                    + len(self._slot_req[s].stamps) for s in tokens)
        t0 = time.perf_counter_ns()
        with record_function("engine.step"):
            out = self.engine.step(tokens)
        t1 = time.perf_counter_ns()
        for slot in tokens:
            self._slot_req[slot].stamps.append(t1)
        self.calls.append(("step", t0, t1, (len(tokens), valid)))
        return out
