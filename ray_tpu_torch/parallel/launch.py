"""Start SPMD ranks: one process per device, each in the default group.

A JAX process owns all its devices and ``shard_map`` runs one body per
device inside it. A torch rank owns one device, so the port's SPMD code
runs in ``n`` processes, each calling the same function with its own
rank. This module starts them and joins them; it has no counterpart in
the JAX package.

Processes are started with the ``spawn`` method only: a process that has
touched CUDA (or JAX) must not be forked. Each rank joins the default
process group through a file store in a fresh temporary directory (no
network): gloo on the CPU, NCCL on CUDA with one GPU per rank. Every
group gets a timeout, and the caller kills the ranks when its deadline
passes, so a collective that one rank skips fails in seconds instead of
hanging.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ray_tpu_torch._private.device import resolve_device

BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


class SpmdError(RuntimeError):
    """A rank raised, died or missed the deadline; the message holds the
    rank's traceback."""


@contextlib.contextmanager
def process_group(rank: int, world_size: int, *, device, init_method: str,
                  timeout_s: float):
    """Join the default process group as ``rank`` of ``world_size`` for
    the ``with`` block: gloo for a CPU ``device``, NCCL (on GPU ``rank``,
    made current) for CUDA. Raises if the backend cannot initialize; it
    never falls back to another one."""
    device = resolve_device(device)
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(rank)
        kwargs["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        BACKENDS[device.type], init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(payload, rank, n, device, init_method, timeout_s, results):
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        if device.type == "cpu":   # n ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        with process_group(rank, n, device=device, init_method=init_method,
                           timeout_s=timeout_s):
            out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_spmd(fn, n: int, *args, device=None, timeout_s: float = 120.0):
    """Run ``fn(rank, *args)`` on ``n`` spawned ranks of one default
    process group; returns the ranks' results, a list in rank order.

    ``fn``, ``args`` and the results are pickled, so ``fn`` must be
    importable by name. ``device=None`` means CUDA, one GPU per rank,
    and raises when there are fewer than ``n``; ``device="cpu"`` runs
    gloo ranks. ``timeout_s`` bounds every collective and the whole
    run: when it passes, the ranks are killed and ``SpmdError`` raised.
    A rank's exception is re-raised here as ``SpmdError`` carrying that
    rank's traceback."""
    device = resolve_device(device)
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"run_spmd on CUDA needs {n} GPUs, one per rank; "
                           f"{torch.cuda.device_count()} visible")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="run_spmd-") as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        # fn and args go through a file: a start whose pickle outgrows the
        # pipe's buffer waits for the child to read it, so the ranks
        # would start one after another
        payload = os.path.join(tmp, "payload.pkl")
        with open(payload, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(payload, r, n, device, init_method,
                                   timeout_s, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            outs = _collect(procs, results, n, deadline, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)
    failed = sorted((r, tb) for r, (ok, tb) in outs.items() if not ok)
    if failed:
        raise SpmdError("\n".join(f"rank {r} of {n} raised:\n{tb}"
                                  for r, tb in failed))
    return [outs[r][1] for r in range(n)]


def _collect(procs, results, n, deadline, timeout_s) -> dict:
    """Drain the ranks' results (before any join) until all ``n`` are in;
    raise ``SpmdError`` at the deadline or when a rank dies silently."""
    outs = {}
    while len(outs) < n:
        left = deadline - time.monotonic()
        if left <= 0:
            missing = sorted(set(range(n)) - set(outs))
            raise SpmdError(f"run_spmd: ranks {missing} of {n} did not "
                            f"finish within {timeout_s} s")
        try:
            rank, ok, payload = results.get(timeout=min(left, 0.5))
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in outs and p.exitcode not in (None, 0)]
            if dead:
                raise SpmdError(
                    f"run_spmd: ranks {dead} of {n} died (exit codes "
                    f"{[procs[r].exitcode for r in dead]})") from None
            continue
        outs[rank] = (ok, payload)
    return outs
