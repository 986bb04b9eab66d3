"""The port's continuous-batching scheduler and slot engine.

Fake-engine half: the admission policy cases of
tests/test_decode_scheduler.py, run against the port's copy of
``DecodeScheduler`` (cases that differ only in their inputs merged into
parametrised tests).

Oracle half: ``TorchSlotEngine`` under the scheduler (a slot freed and
re-prefilled mid-flight included) gives the same greedy tokens as the
JAX package's ``JaxSlotEngine`` on the same params, in fp32.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtfm
from ray_tpu.serve.decode_scheduler import DecodeScheduler as JaxScheduler
from ray_tpu.serve.decode_scheduler import JaxSlotEngine
from ray_tpu_torch.exceptions import ServeOverloadedError
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as ttfm
from ray_tpu_torch.serve.decode_scheduler import (DecodeScheduler,
                                                  TorchSlotEngine)


class FreeRunEngine:
    """Deterministic sync engine: prefill emits prompt[0]+100, each step
    increments. Records per-step occupancy."""

    def __init__(self, slots):
        self.slots = slots
        self.step_slots = []
        self.prefills = []

    def prefill(self, slot, prompt):
        self.prefills.append((slot, tuple(prompt)))
        return prompt[0] + 100

    def step(self, tokens):
        self.step_slots.append(sorted(tokens))
        return {s: t + 1 for s, t in tokens.items()}


class GatedEngine(FreeRunEngine):
    """Async engine whose step() waits for one permit per decode step, so
    admission timing relative to step boundaries is deterministic."""

    def __init__(self, slots):
        super().__init__(slots)
        self.gate = asyncio.Semaphore(0)

    async def step(self, tokens):
        await self.gate.acquire()
        self.step_slots.append(sorted(tokens))
        return {s: t + 1 for s, t in tokens.items()}


async def _until(pred):
    while not pred():
        await asyncio.sleep(0.001)


@pytest.mark.parametrize("slots,prompts,max_tokens,eos,want", [
    (2, [[7]], 4, None, [[107, 108, 109, 110]]),
    (3, [[i] for i in range(10)], 3, None,
     [[i + 100, i + 101, i + 102] for i in range(10)]),
    (1, [[1]], 50, 103, [[101, 102, 103]]),
], ids=["single", "occupancy", "eos"])
def test_free_run(slots, prompts, max_tokens, eos, want):
    async def run():
        eng = FreeRunEngine(slots=slots)
        sched = DecodeScheduler(eng)
        outs = await asyncio.gather(
            *[sched.submit(p, max_tokens=max_tokens, eos_token=eos)
              for p in prompts])
        assert outs == want
        assert max(len(s) for s in eng.step_slots) <= slots
        st = sched.stats()
        assert st["completed"] == len(prompts)
        assert st["active_slots"] == 0 and st["free_slots"] == slots
        await sched.aclose()
    asyncio.run(run())


def test_late_request_joins_next_step_not_batch_drain():
    async def run():
        eng = GatedEngine(slots=2)
        sched = DecodeScheduler(eng)
        a = asyncio.ensure_future(sched.submit([1], max_tokens=8))
        await _until(lambda: eng.prefills)
        eng.gate.release()          # A decodes step 1 alone
        await _until(lambda: eng.step_slots)
        b = asyncio.ensure_future(sched.submit([2], max_tokens=2))
        for _ in range(10):
            eng.gate.release()
        assert await b == [102, 103]
        assert await a == [101, 102, 103, 104, 105, 106, 107, 108]
        assert any(len(s) == 2 for s in eng.step_slots)
        assert sched.stats()["admitted_mid_batch"] == 1
        await sched.aclose()
    asyncio.run(run())


def test_finished_sequence_frees_slot_immediately():
    async def run():
        eng = GatedEngine(slots=1)
        sched = DecodeScheduler(eng)
        a = asyncio.ensure_future(sched.submit([1], max_tokens=2))
        await _until(lambda: eng.prefills)
        b = asyncio.ensure_future(sched.submit([2], max_tokens=2))
        for _ in range(4):
            eng.gate.release()
        assert await a == [101, 102]
        assert await b == [102, 103]
        assert [s for s, _ in eng.prefills] == [0, 0]
        await sched.aclose()
    asyncio.run(run())


def test_queue_cap_sheds_typed():
    async def run():
        eng = GatedEngine(slots=1)
        sched = DecodeScheduler(eng, max_queue_depth=2)
        a = asyncio.ensure_future(sched.submit([1], max_tokens=4))
        await _until(lambda: eng.prefills)
        q = [asyncio.ensure_future(sched.submit([i], max_tokens=1))
             for i in (2, 3)]
        await asyncio.sleep(0)
        with pytest.raises(ServeOverloadedError) as ei:
            await sched.submit([4], max_tokens=1)
        assert ei.value.retry_after_s > 0
        assert sched.stats()["shed"] == 1
        for _ in range(8):
            eng.gate.release()
        await asyncio.gather(a, *q)
        await sched.aclose()
    asyncio.run(run())


class FlakyStepEngine(FreeRunEngine):
    def __init__(self, slots):
        super().__init__(slots)
        self.boom = True

    def step(self, tokens):
        if self.boom:
            self.boom = False
            raise RuntimeError("device fell over")
        return super().step(tokens)


class PickyEngine(FreeRunEngine):
    def prefill(self, slot, prompt):
        if prompt[0] < 0:
            raise ValueError("negative prompt")
        return super().prefill(slot, prompt)


@pytest.mark.parametrize("engine,bad,err", [
    (FlakyStepEngine, [1], RuntimeError),   # a failed device step
    (PickyEngine, [-1], ValueError),        # one bad prompt
], ids=["step", "prefill"])
def test_failure_fails_only_its_requests(engine, bad, err):
    async def run():
        eng = engine(slots=1)
        sched = DecodeScheduler(eng)
        with pytest.raises(err):
            await sched.submit(bad, max_tokens=3)
        # the loop and the slot survive
        assert await sched.submit([5], max_tokens=2) == [105, 106]
        assert sched.stats()["free_slots"] == 1
        await sched.aclose()
    asyncio.run(run())


def test_aclose_fails_pending_typed():
    async def run():
        eng = GatedEngine(slots=1)
        sched = DecodeScheduler(eng)
        a = asyncio.ensure_future(sched.submit([1], max_tokens=4))
        await _until(lambda: eng.prefills)
        await sched.aclose()
        with pytest.raises(ServeOverloadedError):
            await a
        with pytest.raises(ServeOverloadedError):
            await sched.submit([2], max_tokens=1)
    asyncio.run(run())


def test_zero_slot_engine_rejected():
    with pytest.raises(ValueError, match="at least one slot"):
        DecodeScheduler(FreeRunEngine(slots=0))


# ------------------------------------------------------------- jax oracle


def _params(n_layers=2):
    shape = dict(vocab=97, d_model=64, n_heads=4, n_layers=n_layers,
                 d_ff=128, max_seq=64)
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **shape)
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, **shape)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _serve(scheduler_cls, engine, prompts, steps):
    async def run():
        sched = scheduler_cls(engine)
        outs = await asyncio.gather(
            *[sched.submit(p, max_tokens=n) for p, n in zip(prompts, steps)])
        await sched.aclose()
        return outs
    return asyncio.run(run())


def test_torch_slot_engine_matches_jax_slot_engine():
    jcfg, jparams, tcfg, tparams = _params()
    prompts = [[5, 11, 23], [40, 2, 9], [88, 17, 3, 60]]
    steps = [6, 3, 4]   # seq 1 finishes early; seq 2 takes its slot
    want = _serve(JaxScheduler,
                  JaxSlotEngine(jparams, jcfg, slots=2, max_len=32),
                  prompts, steps)
    eng = TorchSlotEngine(tparams, tcfg, slots=2, max_len=32, device="cpu")
    got = _serve(DecodeScheduler, eng, prompts, steps)
    assert got == want
    assert [len(t) for t in got] == steps


def test_torch_slot_engine_guards():
    _, _, tcfg, tparams = _params(n_layers=1)
    eng = TorchSlotEngine(tparams, tcfg, slots=2, max_len=4, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.prefill(0, [1, 2, 3, 4])
    eng.prefill(1, [1, 2, 3])
    eng.step({1: 7})                # writes position 3, the last row
    with pytest.raises(ValueError, match="slot 1 KV cache full"):
        eng.step({1: 8})
    # slot 1 now sits at max_len as an inactive free rider: other rows
    # keep stepping (its write is clamped, never read)
    eng.prefill(0, [4, 5])
    assert set(eng.step({0: 9})) == {0}
