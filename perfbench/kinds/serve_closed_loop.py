"""Serving cells: the port's ``DecodeScheduler`` over ``TorchSlotEngine``
under a closed loop of clients, and the check of what it served.

Set-up draws the weights, builds the engine, warms its shapes (a
prefill of the mix's shortest and of its longest prompt, and decode
steps), then lets every client send its first request; the window opens
when every slot has been filled. It lasts ``seconds``. At its close the
clients stop sending; every request already sent is given up to
``DRAIN_S`` to get its first token, and then the scheduler is closed.
"""

from __future__ import annotations

import asyncio
import bisect
import time

import numpy as np
import torch

from perfbench import devtrace, loadgen, windows
from perfbench.model import (draw_weights, port_config, reference_of,
                             shape_of, sync)
from perfbench.timed_engine import Request, TimedEngine

DRAIN_S = 60.0
CLOSE_WAIT_S = 5.0
FILL_TIMEOUT_S = 600.0


async def _drive(engine: TimedEngine, traffic, seconds: float) -> dict:
    from ray_tpu_torch.serve.decode_scheduler import DecodeScheduler

    sched = DecodeScheduler(engine, max_queue_depth=max(64, traffic.clients))
    reqs: list = []
    closed = {"ns": None}

    async def client(c: int) -> None:
        rnd = 0
        while closed["ns"] is None:
            prompt, n = traffic.request(c, rnd)
            req = Request(c, rnd, prompt, n)
            rnd += 1
            engine.register(req)
            reqs.append(req)
            req.submit_ns = time.perf_counter_ns()
            try:
                req.tokens = await sched.submit(prompt, max_tokens=n)
            except Exception as e:  # noqa: BLE001 - counted, the client goes on
                req.error = (time.perf_counter_ns(), f"{type(e).__name__}: {e}")

    fill = min(traffic.clients, engine.slots)
    tasks = [asyncio.create_task(client(c)) for c in range(traffic.clients)]
    waited = time.perf_counter()
    while engine.prefills < fill:
        if time.perf_counter() - waited > FILL_TIMEOUT_S:
            raise RuntimeError(f"only {engine.prefills} of {fill} slots "
                               f"filled in {FILL_TIMEOUT_S} s")
        await asyncio.sleep(0.001)
    t0 = engine.calls[fill - 1][2]
    stats0 = sched.stats()
    await asyncio.sleep(max(0.0, (t0 + seconds * 1e9
                                  - time.perf_counter_ns()) / 1e9))
    t1 = closed["ns"] = time.perf_counter_ns()
    stats1 = sched.stats()
    deadline = time.perf_counter() + DRAIN_S
    while time.perf_counter() < deadline and any(
            not r.stamps and r.error is None for r in reqs):
        await asyncio.sleep(0.005)
    await sched.aclose()
    # aclose() leaves a request whose prefill was in flight unresolved
    # (it is in neither the queue nor the batch): stop its client
    _, pending = await asyncio.wait(tasks, timeout=CLOSE_WAIT_S)
    for task in pending:
        task.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    return {"t0": t0, "t1": t1, "requests": reqs, "stats0": stats0,
            "stats1": stats1, "fill": fill}


def run(config: dict, mix: dict, seed: int, seconds: float, device,
        trace=None) -> tuple:
    """The window; returns (the run's record, the state to check)."""
    from ray_tpu_torch.serve.decode_scheduler import TorchSlotEngine

    marks = [("entered", time.perf_counter_ns())]
    shape = shape_of(config)
    cfg = port_config(config)
    params = draw_weights(config, seed, device)
    sync(device)
    marks.append(("weights", time.perf_counter_ns()))
    engine = TorchSlotEngine(params, cfg, slots=int(mix["slots"]),
                             max_len=int(mix["max_len"]), device=device)
    traffic = loadgen.ServeTraffic(mix, seed, shape.vocab)
    short, long_ = traffic.warmup_prompts()
    a = engine.prefill(0, short)
    engine.step({0: a})
    b = engine.prefill(1, long_)
    engine.step({0: a, 1: b})
    sync(device)
    marks.append(("warm", time.perf_counter_ns()))
    timed = TimedEngine(engine)
    if trace is not None:
        trace.start()
    rec = asyncio.run(_drive(timed, traffic, seconds))
    sync(device)
    work, stop_s = devtrace.stop(trace)
    marks.append(("filled", rec["t0"]))
    rec.update(kind="serve", shape=shape, calls=timed.calls,
               device_work=work, trace_stop_s=stop_s, marks=marks)
    return rec, {"engine": engine, "params": params}


def extra(rec: dict) -> dict:
    """Beside the result: the tails' quantiles, and the share of token
    gaps in the window that hold a prefill as well as a step (the
    95th percentile of the gaps is steady only away from that share)."""
    gaps = windows.token_gaps_ms(rec)
    ends = sorted(b for kind, _, b, _ in rec["calls"] if kind == "prefill")
    held = sum(1 for r in rec["requests"]
               for a, b in zip(r.stamps, r.stamps[1:])
               if windows.in_window(rec, b)
               and bisect.bisect_left(ends, b) > bisect.bisect_right(ends, a))
    quantiles = (50, 90, 95, 99)
    return {"itl_ms": {q: windows.percentile(gaps, q) for q in quantiles},
            "ttft_ms": {q: windows.percentile(windows.ttfts_ms(rec), q)
                        for q in quantiles},
            "gaps_with_prefill": held / len(gaps) if gaps else None}


def failed(rec: dict) -> int:
    """Requests that raised before the close, or that were sent before
    it and never got a first token."""
    return sum(1 for r in rec["requests"]
               if (r.error is not None and r.error[0] <= rec["t1"])
               or (r.error is None and not r.stamps))


def attempted(rec: dict) -> int:
    return len(rec["requests"])


def sample(rec: dict, seed: int, budget: int) -> list:
    """The finished requests the reference checks, drawn from the seed:
    the one with the most served tokens, one that refilled a slot
    another request had left (where any did), then others in a seeded
    order while their prompt and served tokens stay within ``budget``."""
    done = [r for r in rec["requests"] if r.tokens]
    if not done:
        return []
    rng = np.random.default_rng(loadgen._seed_words(seed) + [5])
    order = [done[i] for i in rng.permutation(len(done))]
    longest = max(done, key=lambda r: len(r.tokens))
    picked = [longest]
    refills = [r for r in order if r.refill and r is not longest]
    if refills:
        picked.append(refills[0])
    used = sum(len(r.prompt) + len(r.tokens) for r in picked)
    for r in order:
        if r in picked:
            continue
        n = len(r.prompt) + len(r.tokens)
        if used + n > budget:
            continue
        picked.append(r)
        used += n
    return picked


def check(config: dict, mix: dict, seed: int, rec: dict, state: dict,
          device, control: bool = False) -> dict:
    """Frees the program's state, then compares the sampled requests'
    served tokens with the reference. Returns the numbers compared (and,
    with ``control``, the fp8 control's reading beside them)."""
    from perfbench.model import free_device_memory

    state.clear()
    free_device_memory(device)
    picked = sample(rec, seed, int(mix["check_prompt_tokens"]))
    off = sum(1 for r in rec["requests"] if r.tokens is not None
              and (len(r.tokens) != r.max_tokens
                   or min(r.tokens) < 0 or max(r.tokens) >= shape_of(config).vocab))
    out = {"failed_requests": failed(rec), "wrong_lengths": off,
           "checked_requests": len(picked),
           "checked_tokens": sum(len(r.tokens) for r in picked)}
    if not picked:
        out["logit_gap"] = float("inf")
        return out
    refmod = reference_of(config)
    refmod.fp32_only()
    params = draw_weights(config, seed, device)
    ref = refmod.Decoder(config["port"], params)
    ctl = (refmod.Decoder(config["port"], params, quant=refmod.fp8)
           if control else None)
    gaps, ctl_gaps = [], []
    for r in picked:
        g, c = refmod.served_gaps(ref, r.prompt, r.tokens, ctl)
        gaps.append(g)
        if c is not None:
            ctl_gaps.append(c)
    out["logit_gap"] = float(torch.cat(gaps).max())
    if control:
        out["control_logit_gap"] = float(torch.cat(ctl_gaps).max())
    return out
