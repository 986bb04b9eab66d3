"""Continuous batching for KV-cached decode: one in-flight batch,
slot admission at step boundaries.

Counterpart of ``ray_tpu/serve/decode_scheduler.py``. ``DecodeScheduler``
is a copy of the JAX package's (the port imports nothing from it): one
long-lived decode batch over a per-slot KV cache; a new request is
admitted into any open slot at the next step boundary, a finished one
frees its slot at once, and past ``max_queue_depth`` waiting requests
``submit`` sheds with the typed :class:`ServeOverloadedError`.

The scheduler is engine-agnostic: anything with ``slots``,
``prefill(slot, prompt) -> first_token`` and
``step({slot: last_token}) -> {slot: next_token}`` drives it.
:class:`TorchSlotEngine` adapts the port's per-slot cache
(``models/decode.py``). Engine calls run in the default executor, so a
decode step does not block the asyncio loop that keeps accepting
requests.
"""

from __future__ import annotations


import asyncio
import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.exceptions import ServeOverloadedError
from ray_tpu_torch.models import decode

logger = logging.getLogger(__name__)


_SPAWNED: set = set()


def spawn_logged(coro, what: str, loop=None) -> "asyncio.Task":
    """Tracked fire-and-forget: create a task, hold a strong reference
    until it finishes, and turn an unhandled exception into a log line
    instead of a silent GC-time mutter. Returns the task."""
    if loop is None:
        loop = asyncio.get_event_loop()
    task = loop.create_task(coro)
    _SPAWNED.add(task)

    def _done(t, _what=what):
        _SPAWNED.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            logger.error("background task %r died: %r", _what, exc,
                         exc_info=exc)

    task.add_done_callback(_done)
    return task


@dataclass
class _Request:
    prompt: Any
    max_tokens: int
    eos_token: Optional[int]
    future: asyncio.Future
    tokens: List[int] = field(default_factory=list)
    joined_mid_batch: bool = False


class DecodeScheduler:
    """One in-flight decode batch; admission at step boundaries.

    ``submit`` is awaited per request and resolves with the generated
    token list. The background loop starts lazily on the first submit
    and parks (zero cycles) whenever queue and batch are both empty.
    """

    def __init__(self, engine, *, max_queue_depth: int = 64,
                 retry_after_s: float = 1.0):
        if int(engine.slots) <= 0:
            raise ValueError("engine must expose at least one slot")
        self._engine = engine
        self._free: List[int] = list(range(engine.slots))
        self._queue: deque[_Request] = deque()
        self._active: Dict[int, _Request] = {}
        self._max_queue_depth = int(max_queue_depth)
        self._retry_after_s = float(retry_after_s)
        self._wakeup = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        self._closed = False
        # counters surfaced by stats() (and the replica's stats() ->
        # autoscaler/admission view)
        self.steps = 0
        self.slot_steps = 0          # sum of batch occupancy per step
        self.completed = 0
        self.shed = 0
        self.admitted = 0
        self.admitted_mid_batch = 0
        self.tokens_generated = 0

    # ------------------------------------------------------------ public

    async def submit(self, prompt, *, max_tokens: int,
                     eos_token: Optional[int] = None) -> List[int]:
        """Queue one prompt; resolves with its generated tokens.

        Sheds (typed, never queues) once ``max_queue_depth`` requests
        are already waiting for a slot — the per-replica half of the
        SLO contract; the proxy's admission controller is the cluster
        half."""
        if self._closed:
            raise ServeOverloadedError("decode scheduler is closed",
                                       retry_after_s=self._retry_after_s)
        if len(self._queue) >= self._max_queue_depth:
            self.shed += 1
            raise ServeOverloadedError(
                f"decode queue full ({len(self._queue)} waiting, cap "
                f"{self._max_queue_depth})",
                retry_after_s=self._retry_after_s)
        req = _Request(prompt, int(max_tokens), eos_token,
                       asyncio.get_running_loop().create_future())
        self._queue.append(req)
        self._wakeup.set()
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = spawn_logged(self._run(),
                                               "serve-decode-loop")
        return await req.future

    def queue_depth(self) -> int:
        return len(self._queue)

    def stats(self) -> dict:
        return {
            "queue_depth": len(self._queue),
            "active_slots": len(self._active),
            "free_slots": len(self._free),
            "steps": self.steps,
            "slot_steps": self.slot_steps,
            "mean_occupancy": (self.slot_steps / self.steps
                               if self.steps else 0.0),
            "completed": self.completed,
            "shed": self.shed,
            "admitted": self.admitted,
            "admitted_mid_batch": self.admitted_mid_batch,
            "tokens_generated": self.tokens_generated,
        }

    async def aclose(self) -> None:
        """Stop the loop; fail queued and in-flight requests typed."""
        self._closed = True
        task, self._loop_task = self._loop_task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        err = ServeOverloadedError("decode scheduler closed",
                                   retry_after_s=self._retry_after_s)
        for req in list(self._queue) + list(self._active.values()):
            if not req.future.done():
                req.future.set_exception(err)
        self._queue.clear()
        self._active.clear()
        self._free = list(range(self._engine.slots))

    # ------------------------------------------------------------- loop

    async def _prefill(self, slot: int, req: _Request) -> None:
        loop = asyncio.get_running_loop()
        if asyncio.iscoroutinefunction(self._engine.prefill):
            first = await self._engine.prefill(slot, req.prompt)
        else:
            first = await loop.run_in_executor(
                None, self._engine.prefill, slot, req.prompt)
        req.tokens.append(int(first))
        self.tokens_generated += 1

    def _finish(self, slot: int, req: _Request) -> None:
        del self._active[slot]
        self._free.append(slot)
        self.completed += 1
        if not req.future.done():
            req.future.set_result(req.tokens)

    def _done(self, req: _Request) -> bool:
        return (len(req.tokens) >= req.max_tokens or
                (req.eos_token is not None and req.tokens and
                 req.tokens[-1] == req.eos_token))

    async def _admit(self) -> None:
        """Fill open slots from the queue head (step boundary only)."""
        while self._free and self._queue:
            req = self._queue.popleft()
            if req.future.done():   # caller gave up while queued
                continue
            slot = self._free.pop()
            req.joined_mid_batch = bool(self._active)
            self.admitted += 1
            if req.joined_mid_batch:
                self.admitted_mid_batch += 1
            try:
                await self._prefill(slot, req)
            except Exception as e:  # noqa: BLE001 — one bad prompt
                # must not kill the batch: fail ITS future, free the
                # slot, keep decoding everyone else
                self._free.append(slot)
                if not req.future.done():
                    req.future.set_exception(e)
                continue
            if self._done(req):
                self._free.append(slot)
                self.completed += 1
                if not req.future.done():
                    req.future.set_result(req.tokens)
            else:
                self._active[slot] = req

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._closed:
            await self._admit()
            if not self._active:
                self._wakeup.clear()
                if not self._queue:
                    await self._wakeup.wait()
                continue
            tokens = {slot: req.tokens[-1]
                      for slot, req in self._active.items()}
            try:
                if asyncio.iscoroutinefunction(self._engine.step):
                    out = await self._engine.step(tokens)
                else:
                    out = await loop.run_in_executor(
                        None, self._engine.step, tokens)
            except Exception as e:  # noqa: BLE001 — a failed device
                # step fails the IN-FLIGHT requests typed; the loop and
                # the queue survive (shed at the door, never collapse)
                logger.error("decode step failed: %r", e, exc_info=e)
                for slot, req in list(self._active.items()):
                    del self._active[slot]
                    self._free.append(slot)
                    if not req.future.done():
                        req.future.set_exception(e)
                continue
            self.steps += 1
            self.slot_steps += len(tokens)
            for slot, tok in out.items():
                req = self._active.get(slot)
                if req is None:
                    continue
                req.tokens.append(int(tok))
                self.tokens_generated += 1
                if self._done(req):
                    self._finish(slot, req)


class TorchSlotEngine:
    """Adapts the per-slot KV cache (``models/decode.py``) to the
    scheduler's engine protocol. Greedy decoding; prompts are integer
    token-id sequences; ``params`` lie on ``device`` (default CUDA).
    Every call runs under ``torch.inference_mode()``."""

    def __init__(self, params, cfg, *, slots: int, max_len: int,
                 device=None):
        self.device = resolve_device(device)
        self._params = params
        self._cfg = cfg
        self.slots = int(slots)
        self.max_len = int(max_len)
        with torch.inference_mode():
            self._cache = decode.init_slot_cache(cfg, self.slots,
                                                 self.max_len,
                                                 device=self.device)

    def prefill(self, slot: int, prompt) -> int:
        tokens = torch.as_tensor(prompt, dtype=torch.long,
                                 device=self.device)[None, :]
        if tokens.shape[1] >= self.max_len:
            raise ValueError(
                f"prompt ({tokens.shape[1]}) >= slot max_len "
                f"({self.max_len})")
        with torch.inference_mode():
            logits, self._cache = decode.slot_prefill(
                self._params, tokens, self._cache, slot, self._cfg)
            return int(torch.argmax(logits[0]))

    def step(self, tokens: Dict[int, int]) -> Dict[int, int]:
        pos = self._cache["pos"].tolist()
        tok = [0] * self.slots
        act = [False] * self.slots
        for slot, t in tokens.items():
            # a slot at capacity has nowhere to write its K/V; the
            # scheduler's max_tokens bound plus the prompt-length check
            # make this unreachable, so refuse loudly
            if pos[slot] >= self.max_len:
                raise ValueError(f"slot {slot} KV cache full")
            tok[slot], act[slot] = int(t), True
        with torch.inference_mode():
            logits, self._cache = decode.slot_decode_step(
                self._params, self._cache,
                torch.tensor(tok, dtype=torch.long, device=self.device),
                torch.tensor(act, device=self.device), self._cfg)
            nxt = torch.argmax(logits, dim=-1).tolist()
        return {slot: nxt[slot] for slot in tokens}
