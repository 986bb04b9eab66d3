#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each, in order:

1. ``env``: torch and nvcc versions, the card's name and power limit.
2. ``build``: compiles every kernel in ``ray_tpu_torch/csrc`` from the
   checkout (one nvcc per source, all at once) and reports the seconds.
3. ``kernel``: K1 through its wrapper against its plain version
   ``flash_attention_reference`` on the card, O and lse, at the serving
   prefill shape, the training shape and around them (ragged T,
   non-causal, head_dim 128, the entry's head_dim 32, 16 and the dry
   run's 8, which the kernels pad to their tile width); bf16 runs the tensor-core route
   (``csrc/flash_fwd_sm90.cu``) and is held to two ulps on O, fp32 the
   scalar route (``csrc/flash_fwd.cu``); each row names its route and
   its worst share of the allowance. Kernel and plain timed with CUDA
   events, the kernel also by its device time in a profiler window, as
   ``scaled_dot_product_attention`` (a yardstick only; the port never
   calls it) is; all beside the least time the card could take.
4. ``serve``: the full-width decoder (vocab 32768, d_model 1024, 16
   heads, 8 layers, d_ff 4096, bf16; depth as in the model bench) behind
   ``DecodeScheduler`` + ``TorchSlotEngine`` (16 slots, max_len 1024)
   answering 32 concurrent requests with ragged prompts and lengths.
   K1's launch counts are reset just before and read just after; every
   launch took the sm90 route.
5. ``exact``: the same widths in fp32 at 2 layers; greedy tokens
   through the slot engine (a slot freed and reused mid-flight) equal
   the whole-batch ``generate`` exactly, and each first token equals
   the argmax of ``forward`` on the prompt.
6. ``kernel_bwd``: K2 and K3 through their wrappers against
   ``flash_backward_reference`` on the card, with O and lse from K1, at
   the training shape and around it (ragged T, non-causal, head_dim
   128, 32, 16 and 8, the prefill width); bf16 runs the tensor-core route
   (``csrc/flash_bwd_sm90.cu``) and is held to two ulps, fp32 the scalar
   route (``csrc/flash_bwd.cu``); each row names its route. Each kernel
   and its plain version timed with CUDA events, the backward of
   ``scaled_dot_product_attention`` (a yardstick only) by its kernels'
   device time, beside the least time the card could take.
7. ``train``: the serve phase's widths, bf16, 8 layers, batch 16 x 1024
   tokens, remat "full", through ``make_train_step``: one warm-up step,
   then timed steps with the kernels' launch counts reset just before
   and read just after (K1 twice per layer and step, K2 and K3 once,
   all on the sm90 route); step time, tokens/s, TFLOP/s, peak memory,
   and a loss that falls.
   Then a ``profile`` line over one step.
8. ``train_exact``: fp32, the same widths at 2 layers, one ragged
   sequence of 300 tokens: ``loss_fn``'s value and every gradient leaf
   on the card (K1-K3 on the scalar route) against the same
   call on the CPU (plain versions), relative to each leaf's largest
   magnitude.
9. ``mesh_train``: the ``train`` phase's model, batch and remat through
   ``make_train_step(cfg, pcfg, mesh=build_mesh(MeshConfig(1, 1, 1, 1),
   device_type="cuda"))`` on a world-size-1 NCCL process group in this
   process, with all four axes named (``attn="local"``, 2 microbatches):
   every collective, the pipeline loop and the gradient reduction run on
   the card. One warm-up step, then timed steps with the launch counts
   reset just before and read just after (K1 2 x layers x microbatches
   per step, K2 and K3 layers x microbatches, all on the sm90 route);
   step time beside the ``train`` phase's, tokens/s, peak memory, and
   losses that fall and stay within ``MESH_LOSS_TOL`` of the ``train``
   phase's (same params, batch and steps). Then a ``profile`` line over
   one step, with the count, host ms and device ms of every collective
   in it.
10. ``mesh_exact``: fp32, the same widths at 2 layers, batch 2 x 300
   tokens, SGD: from the same params, the mesh step's loss and every
   reduced gradient leaf against ``make_train_step``'s oracle step's,
   and ``forward`` with ``attn="ring"`` and ``"ulysses"`` (sp named,
   size 1) against ``"local"``, relative to each tensor's largest
   magnitude, under ``MESH_EXACT_TOL``; K1-K3 on the scalar route,
   launch counts asserted.
11. ``entry``: ``ray_tpu_torch.entry()`` (the reference's entry config,
   head_dim 32) on the card: [4, 128, 512] finite logits, with K1's
   launch counts reset just before and read just after (once per layer,
   all on the sm90 route); the CPU call's params and tokens carried to
   the card, logits against the CPU's within ``ENTRY_TOL``; and K1 at
   the entry's attention shape against the plain ``attention`` in fp32
   on the same inputs, within K1's bf16 tolerance.
12. ``scheduler``: the ``cuda_batched`` backend (``csrc/sched_scan.cu``)
   against ``scan_reference`` on CPU tensors and the port's
   ``HostBackend``, decisions compared exactly: the cases of
   tests/test_scheduler_diff.py and its 12-tick sequence (row uploads
   equal to the CPU backend's), and the reference's two quirks (the
   kernel follows ``scan_reference``, not the host). The kernel alone
   on fractional arrays, signed ones (negative and zero demands, a grant
   giving availability back), ones whose placements resume after 7,000
   positions, and a node bucket too large for shared memory (the
   global-state route, checked by the walk's ``shared`` counter). Then
   the `sched` configuration (``sched_config``, a synthetic stress
   size): a first tick of 100,000 pending over 256 nodes and three drain
   waves (no arrivals, availability drawn anew before each), the scan's
   launches counted over them, each tick's walk counters printed and its
   scan held to ``scan_reference``; the first tick's scan with every
   task placing (``dense``); a 10,000 pending tick held to
   ``HostBackend``; kernel ms (first and incremental tick, dense), split
   into the walk kernel's set-up and loop (its own global-timer counts)
   and the rest (the pre-pass and the gap between the two kernels),
   tick wall ms (inputs copied outside the timed window), µs per task
   and per placement, rows uploaded, the bound over what the output
   needs (the locality rows of the positions ready on some node at their
   turn, by ``sched_ready_positions``) beside the bound over every row,
   and a cProfile split of one first tick's host time.

Then the ``kernels`` line, the ``nvidia-smi`` card line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero; without
CUDA it exits 1 before printing a result.
"""

from __future__ import annotations

import asyncio
import contextlib
import cProfile
import json
import pstats
import random
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch._private import kernels
from ray_tpu_torch._private.scheduler import NodeView, PendingRequest
from ray_tpu_torch._private.scheduler import cuda_batched
from ray_tpu_torch._private.scheduler.cuda_batched import (CudaBatchedBackend,
                                                           sched_scan,
                                                           scan_reference,
                                                           walk_counters)
from ray_tpu_torch._private.scheduler.host_backend import HostBackend
from ray_tpu_torch.models import decode
from ray_tpu_torch.models.convert import shard_params
from ray_tpu_torch.models.transformer import (SGD, ParallelConfig,
                                              TransformerConfig, forward,
                                              init_params, loss_fn,
                                              make_train_step, param_leaves)
from ray_tpu_torch.ops.attention import (_route, attention,
                                         flash_attention,
                                         flash_attention_reference,
                                         flash_backward_reference,
                                         flash_bwd_dkv,
                                         flash_bwd_dkv_reference,
                                         flash_bwd_dq, flash_bwd_dq_reference,
                                         flash_delta, flash_forward)
from ray_tpu_torch.parallel.collectives import bind_mesh
from ray_tpu_torch.parallel.launch import process_group
from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from ray_tpu_torch.serve.decode_scheduler import (DecodeScheduler,
                                                  TorchSlotEngine)

SEED = 0
DEVICE = "cuda"
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# K1's tolerances (atol, rtol) against its plain version, on O and on
# lse. O in fp32 differs only in summation order. O in bf16 is held to
# BWD_TOL's two bf16 ulps: the sm90 route keeps P to ~16 bits as a hi +
# lo pair of bf16, so both sides round fp32 sums that differ as little;
# one bf16 rounding of P (as FlashAttention-2/3 do) moves O ~10x past it,
# and the (3e-2, 1e-2) this replaced passed that too (bwd_fault_check.py
# plants it). lse is fp32 on both routes, m + log(l) of fp32 sums that
# differ only in order: 1e-5 (a CPU simulation of the sm90 rounding
# points gave <= 1e-6).
TOL = {torch.float32: {"o": (1e-4, 1e-4), "lse": (1e-5, 1e-5)},
       torch.bfloat16: {"o": (1e-4, 2.0 ** -6), "lse": (1e-5, 1e-5)}}
PREFILL_CASE = (1, 512, 16, 64, torch.bfloat16, True)
TRAIN_CASE = (16, 1024, 16, 64, torch.bfloat16, True)
PREFILL_CASE_FP32 = (1, 512, 16, 64, torch.float32, True)   # scalar route
# the attention of ray_tpu_torch.entry(): 8 heads of 32 (padded to the
# tensor-core tile's 64 columns in shared memory)
ENTRY_CASE = (4, 128, 8, 32, torch.bfloat16, True)
KERNEL_CASES = [
    PREFILL_CASE,
    TRAIN_CASE,
    PREFILL_CASE_FP32,
    (16, 512, 16, 64, torch.bfloat16, True),
    (16, 512, 16, 64, torch.float32, True),
    (1, 300, 16, 64, torch.bfloat16, True),    # ragged tail of T
    (1, 300, 16, 64, torch.float32, True),
    (1, 512, 16, 64, torch.bfloat16, False),
    (2, 256, 8, 128, torch.bfloat16, True),    # head_dim 128
    (2, 256, 8, 128, torch.float32, True),
    ENTRY_CASE,                                # entry(): head_dim 32
    (4, 128, 8, 32, torch.float32, True),
    (2, 300, 4, 8, torch.bfloat16, True),      # dryrun_multichip's 8
    (2, 300, 4, 8, torch.float32, True),
    (2, 200, 4, 16, torch.bfloat16, False),    # head_dim 16
]
SERVE_WIDTHS = dict(vocab=32768, d_model=1024, n_heads=16, d_ff=4096,
                    max_seq=1024)
# dQ, dK, dV tolerances (atol, rtol) of K2/K3 against their plain
# version. fp32: that of tests/test_ops.py for the Pallas backward (the
# sums differ only in order). bf16: both sides round fp32 sums that
# differ as little (the sm90 route keeps p and ds to ~16 bits as a hi +
# lo pair of bf16), so they may land one bf16 ulp apart, at most 2^-7 of
# the value; rtol allows two ulps and atol values near 0. A kernel that
# drops a tile, or the lo half of the split, moves dQ, dK, dV (~0.05 at
# the training shape) far past it (bwd_fault_check.py plants such
# faults).
BWD_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-4, 2.0 ** -6)}
TRAIN_CASE_FP32 = (16, 1024, 16, 64, torch.float32, True)   # scalar route
BWD_CASES = [
    TRAIN_CASE,
    TRAIN_CASE_FP32,
    (16, 512, 16, 64, torch.bfloat16, True),   # the prefill width
    (1, 512, 16, 64, torch.float32, True),
    (1, 300, 16, 64, torch.float32, True),     # ragged tail of T
    (1, 300, 16, 64, torch.bfloat16, True),
    (1, 512, 16, 64, torch.bfloat16, False),
    (2, 256, 8, 128, torch.float32, True),     # head_dim 128
    (2, 256, 8, 128, torch.bfloat16, True),
    ENTRY_CASE,                                # head_dim 32
    (4, 128, 8, 32, torch.float32, True),
    (2, 300, 4, 8, torch.bfloat16, True),      # head_dim 8
    (2, 300, 4, 8, torch.float32, True),
    (2, 200, 4, 16, torch.bfloat16, False),    # head_dim 16
]
FWD_SOURCES = {"sm90": "ray_tpu_torch/csrc/flash_fwd_sm90.cu",
               "scalar": "ray_tpu_torch/csrc/flash_fwd.cu"}
BWD_SOURCES = {"sm90": "ray_tpu_torch/csrc/flash_bwd_sm90.cu",
               "scalar": "ray_tpu_torch/csrc/flash_bwd.cu"}
# The trainer benchmark's baseline point (ray_tpu/models/bench_model.py:
# the widths above, 8 layers, batch 16 x 1024 tokens, remat "full").
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 16, 1024, 6
# train_exact: whole-model fp32 tolerance, relative to each leaf's
# largest magnitude.
EXACT_TOL = 1e-4
# the mesh phases: every axis named on a 1 x 1 x 1 x 1 mesh, two
# microbatches through the pipeline loop
MESH_AXES = dict(dp="dp", pp="pp", sp="sp", tp="tp")
MESH_MICROBATCHES = 2
MESH_EXACT_LR = 0.1
# mesh_train's losses against the train phase's, relative: the largest
# gap measured over the 7 steps on an H100 80GB HBM3 is 4.4e-5; 1e-3 is
# ~20x that and a quarter of a bf16 ulp (2^-8 relative).
MESH_LOSS_TOL = 1e-3
# mesh_exact, fp32, relative to each tensor's largest magnitude: ~10x
# the largest error measured on an H100 80GB HBM3: loss 9.0e-8, reduced
# gradients 2.4e-6, ring / Ulysses logits 2.0e-6.
MESH_EXACT_TOL = {"loss": 1e-6, "grad": 3e-5, "attn": 2e-5}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_env(card: str) -> None:
    nvcc = subprocess.run([kernels.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc, "card": card,
          "device": torch.cuda.get_device_name(0)})


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = kernels.build()
    for name in kernels.kernel_names():
        kernels.library(name)
    # per kernel instantiation: its name, then its spills and registers
    # (and any ptxas warning, e.g. serialized wgmma)
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if any(w in ln for w in ("Compiling entry", "registers",
                                      "spill", "warning"))]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs), "ptxas": ptxas})


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(prof):
    """Device-side events of a profile (a CPU op's entry would repeat
    its kernels' time)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def device_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: the summed time of the kernels
    it launches over ``iters`` calls in a profiler window (after a
    warm-up call), per call. For a library call whose host work outlasts
    its kernels, where CUDA events around the calls would time the
    host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in _device_events(prof)) / 1e3 / iters


def _bound(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def _pairs(T, causal):
    """(q, k) pairs the mask keeps, per head."""
    return T * (T + 1) // 2 if causal else T * T


def k1_bound(B, T, H, D, dtype, causal):
    """Least time for K1's work: 2 matmuls of 2 flops per (q, k) pair the
    mask keeps, against q, k, v read once and O, lse written once."""
    flops = 4 * B * H * D * _pairs(T, causal)
    nbytes = 4 * B * T * H * D * torch.finfo(dtype).bits // 8 + B * H * T * 4
    return _bound(flops, nbytes, dtype)


def bwd_bound(B, T, H, D, dtype, causal, kernel):
    """Least time for K2's (``"dkv"``: s, dp, dV, dK) or K3's (``"dq"``:
    s, dp, dQ) work: 2 flops per (q, k) pair the mask keeps and head_dim
    element of each matmul, against q, k, v, dO, lse and delta read once
    and the outputs (dK, dV or dQ) written once."""
    mats, tensors = (4, 6) if kernel == "dkv" else (3, 5)
    flops = 2 * mats * B * H * D * _pairs(T, causal)
    nbytes = (tensors * B * T * H * D * torch.finfo(dtype).bits // 8
              + 2 * B * H * T * 4)
    return _bound(flops, nbytes, dtype)


def tol_share(got, ref, atol, rtol) -> float:
    """The worst element's error over its allowance atol + rtol |ref|;
    > 1 fails."""
    ref = ref.float()
    return float(((got.float() - ref).abs() / (atol + rtol * ref.abs()))
                 .max())


def _k1_inputs(case, seed):
    B, T, H, D, dtype, _ = case
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn((B, T, H, D), generator=gen, device=DEVICE).to(dtype)
            for _ in range(3)]


def _k1_check(out, lse, ref, ref_lse, dtype) -> dict:
    tol = TOL[dtype]
    return {"o": tol_share(out, ref, *tol["o"]),
            "lse": tol_share(lse, ref_lse, *tol["lse"])}


def phase_kernel() -> dict:
    """K1 against its plain version, per case; returns the rows by
    case."""
    rows, failures = {}, []
    for i, case in enumerate(KERNEL_CASES):
        B, T, H, D, dtype, causal = case
        q, k, v = _k1_inputs(case, SEED + i)
        route = _route(q)
        before = flash_attention.launches_by_route[route]
        out, lse = flash_forward(q, k, v, causal=causal)
        assert flash_attention.launches_by_route[route] == before + 1, (
            case, route)
        ref, ref_lse = flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        shares = _k1_check(out, lse, ref, ref_lse, dtype)
        ok = max(shares.values()) <= 1.0
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        iters = _iters(B, T, H)
        bound_ms, bound_by = k1_bound(*case)

        def fwd():
            flash_forward(q, k, v, causal=causal)

        def lib():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        row = {"phase": "kernel", "shape": [B, T, H, D],
               "dtype": str(dtype).removeprefix("torch."), "causal": causal,
               "route": route, "source": FWD_SOURCES[route],
               "max_abs_err": float((out.float() - ref.float()).abs().max()),
               "max_abs_err_lse": float((lse - ref_lse).abs().max()),
               "tol": TOL[dtype], "tol_share": shares, "ok": ok,
               "ms": time_ms(fwd, iters), "device_ms": device_ms(fwd, iters),
               "plain_ms": time_ms(lambda: flash_attention_reference(
                   q, k, v, causal=causal), iters),
               "library_ms": device_ms(lib, iters),
               "library_event_ms": time_ms(lib, iters),
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        rows[case] = row
        if not ok:
            failures.append(case)
        del out, lse, ref, ref_lse
    if failures:
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"{failures}")
    return rows


def _iters(B, T, H):
    return 10 if B * T * H > 2 ** 17 else 20 if B * T * H > 2 ** 15 else 100


def _routes_launched() -> dict:
    return {"fwd": dict(flash_attention.launches_by_route),
            "dkv": dict(flash_bwd_dkv.launches_by_route),
            "dq": dict(flash_bwd_dq.launches_by_route)}


def phase_kernel_bwd() -> dict:
    """K2 and K3 against their plain version, per case; returns the rows
    by case."""
    rows, failures = {}, []
    for i, case in enumerate(BWD_CASES):
        B, T, H, D, dtype, causal = case
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 100 + i)
        q, k, v, do = (torch.randn((B, T, H, D), generator=gen,
                                   device=DEVICE).to(dtype)
                       for _ in range(4))
        out, lse = flash_forward(q, k, v, causal=causal)
        delta = flash_delta(out, do)
        route = _route(q)
        before = _routes_launched()
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
        after = _routes_launched()
        for kernel in ("dkv", "dq"):
            assert after[kernel][route] == before[kernel][route] + 1, (
                case, route, before, after)
        refs = flash_backward_reference(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        atol, rtol = BWD_TOL[dtype]
        errs, shares = {}, {}
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            errs[name] = float((got.float() - ref.float()).abs().max())
            shares[name] = tol_share(got, ref, atol, rtol)
        ok = max(shares.values()) <= 1.0
        del refs
        # the library's backward of the same attention, on a graph kept
        # for repeated calls: a yardstick only, the port never calls it
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2)

        def lib_bwd():
            torch.autograd.grad(o_lib, (qt, kt, vt), dot, retain_graph=True)

        iters = _iters(B, T, H)
        plain_iters = max(2, iters // 10)
        kw = dict(causal=causal)
        row = {"phase": "kernel_bwd", "shape": [B, T, H, D],
               "dtype": str(dtype).removeprefix("torch."), "causal": causal,
               "route": route, "source": BWD_SOURCES[route],
               "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
               "tol": [atol, rtol], "tol_share_by": shares, "ok": ok,
               "dkv_ms": time_ms(lambda: flash_bwd_dkv(
                   q, k, v, do, lse, delta, **kw), iters),
               "dq_ms": time_ms(lambda: flash_bwd_dq(
                   q, k, v, do, lse, delta, **kw), iters),
               "dkv_plain_ms": time_ms(lambda: flash_bwd_dkv_reference(
                   q, k, v, do, lse, delta, **kw), plain_iters),
               "dq_plain_ms": time_ms(lambda: flash_bwd_dq_reference(
                   q, k, v, do, lse, delta, **kw), plain_iters),
               "library_bwd_ms": device_ms(lib_bwd, iters),
               "library_bwd_event_ms": time_ms(lib_bwd, iters)}
        for kernel in ("dkv", "dq"):
            row[f"{kernel}_bound_ms"], row[f"{kernel}_bound_by"] = bwd_bound(
                *case, kernel)
        row["k1_bound_ms"] = k1_bound(*case)[0]
        emit(row)
        rows[case] = row
        if not ok:
            failures.append(case)
        del o_lib, qt, kt, vt
    if failures:
        raise AssertionError(f"K2/K3 disagree with their plain version at "
                             f"{failures}")
    return rows


class TimedEngine:
    """Engine wrapper that stamps when each prompt's first token is out
    and sums the seconds spent in prefills and in decode steps (each
    engine call ends in a host read of an argmax, so the GPU is done)."""

    def __init__(self, engine):
        self.engine = engine
        self.slots = engine.slots
        self.reset()

    def reset(self):
        self.prefills, self.prefill_s, self.step_s = 0, 0.0, 0.0
        self.first_token_at = {}

    def prefill(self, slot, prompt):
        t0 = time.perf_counter()
        tok = self.engine.prefill(slot, prompt)
        self.first_token_at[id(prompt)] = t1 = time.perf_counter()
        self.prefill_s += t1 - t0
        self.prefills += 1
        return tok

    def step(self, tokens):
        t0 = time.perf_counter()
        out = self.engine.step(tokens)
        self.step_s += time.perf_counter() - t0
        return out


async def serve_all(engine, prompts, max_tokens):
    sched = DecodeScheduler(engine)
    try:
        outs = await asyncio.gather(
            *[sched.submit(p, max_tokens=int(n))
              for p, n in zip(prompts, max_tokens)])
        return outs, sched.stats()
    finally:
        await sched.aclose()


def phase_serve() -> tuple[int, dict]:
    """The full-width serve run; returns K1's launches in it, in all
    and by route."""
    cfg = TransformerConfig(n_layers=8, dtype=torch.bfloat16,
                            **SERVE_WIDTHS)
    params = init_params(cfg, seed=SEED, device=DEVICE)
    engine = TimedEngine(TorchSlotEngine(params, cfg, slots=16,
                                         max_len=1024, device=DEVICE))
    rng = np.random.default_rng(SEED)
    lens = rng.integers(128, 513, size=32)
    max_tokens = rng.integers(2, 65, size=32)
    assert any(n % 128 for n in lens), lens
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in lens]
    # warm-up: CUDA context, cuBLAS handles and the kernel's first launch
    asyncio.run(serve_all(engine, [prompts[0][:200]], [3]))
    torch.cuda.synchronize()

    engine.reset()
    _reset_launch_counts()
    t0 = time.perf_counter()
    outs, stats = asyncio.run(serve_all(engine, prompts, max_tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    routes = dict(flash_attention.launches_by_route)

    for toks, n in zip(outs, max_tokens):
        assert len(toks) == n, (len(toks), n)
        assert all(0 <= t < cfg.vocab for t in toks)
    assert engine.prefills == len(prompts), engine.prefills
    assert launches == cfg.n_layers * engine.prefills, (
        launches, engine.prefills)
    # every K1 launch of the bf16 prefills took the tensor-core route
    assert routes == {"sm90": launches, "scalar": 0}, routes
    ttft = np.array([engine.first_token_at[id(p)] - t0 for p in prompts])
    tokens = sum(len(t) for t in outs)
    emit({"phase": "serve", "requests": len(prompts),
          "prompt_tokens": int(lens.sum()), "tokens": tokens,
          "wall_s": wall, "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
          "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
          "decode_tokens_per_s": (tokens - len(prompts)) / wall,
          "decode_tokens_per_step_s": (tokens - len(prompts)) / engine.step_s,
          "prefill_s": engine.prefill_s, "step_s": engine.step_s,
          "steps": stats["steps"], "mean_occupancy": stats["mean_occupancy"],
          "prefills": engine.prefills, "flash_launches": launches,
          "flash_launches_by_route": routes})
    phase_profile(engine.engine, prompts[0][:512])
    return launches, routes


# Kernel classes of a profile window: the port's own kernels, the
# library's matrix products (cuBLAS names), and everything else
# (elementwise, casts, copies, reductions, the optimizer).
_MATMUL_NAMES = ("nvjet", "gemm", "gemv", "cutlass", "xmma")


def _kernel_class(name: str) -> str:
    if "flash_" in name:
        return "port_kernels"
    if any(t in name for t in _MATMUL_NAMES):
        return "matmul"
    return "other"


# The port's collectives (ray_tpu_torch/parallel/collectives.py): a
# profile records each autograd Function's forward under its class name
# and its backward under that name + "Backward"; each span holds the
# collective's copies and its c10d call.
_COLLECTIVES = ("_Psum", "_AllGather", "_PsumScatter", "_AllToAll",
                "_Ppermute", "_TpCopy", "_TpAllreduce")


def _collectives(prof) -> dict:
    """The collectives of a profile window: per span name its calls, its
    host ms (the span's wall on the host, its children included) and its
    device ms (the kernels and copies launched within it); the c10d
    calls beneath them alike; and every device event of NCCL's own."""
    names = set(_COLLECTIVES) | {n + "Backward" for n in _COLLECTIVES}
    events = prof.key_averages()

    def row(e):
        return [e.count, e.cpu_time_total / 1e3, e.device_time_total / 1e3]

    spans = {e.key: row(e) for e in events if e.key in names}
    c10d = {e.key: row(e) for e in events if e.key.startswith("c10d::")}
    return {"calls": sum(r[0] for r in spans.values()),
            "host_ms": sum(r[1] for r in spans.values()),
            "device_ms": sum(r[2] for r in spans.values()),
            "by_span": spans, "c10d": c10d,
            "nccl_device": [[e.key[:80], e.self_device_time_total / 1e3,
                             e.count] for e in _device_events(prof)
                            if "nccl" in e.key.lower()]}


def _profile(fn, label: str) -> None:
    """Device time by kernel over one call of ``fn`` (after a warm-up
    call): wall, summed kernel time, its split by kernel class, the
    device's idle share, and the port's collectives where it ran any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    by_class = {}
    for e in events:
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3
    comm = _collectives(prof)
    emit({"phase": "profile", "window": label, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
          "device_ms_by_class": by_class,
          "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                  for e in top],
          "port_kernels": [[e.key[:80], e.self_device_time_total / 1e3,
                            e.count] for e in events
                           if _kernel_class(e.key) == "port_kernels"],
          **({"collectives": comm} if comm["calls"] else {})})


def phase_profile(engine, prompt) -> None:
    """Where a serving step's time goes: one prefill of a 512-token
    prompt, and one decode step with every slot active."""
    _profile(lambda: engine.prefill(0, prompt),
             f"slot_prefill T={len(prompt)}")
    batch = {s: 1 for s in range(engine.slots)}
    _profile(lambda: engine.step(batch),
             f"slot_decode_step {engine.slots} active slots")


def phase_exact() -> None:
    cfg = TransformerConfig(n_layers=2, dtype=torch.float32, **SERVE_WIDTHS)
    params = init_params(cfg, seed=SEED + 1, device=DEVICE)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
               for n in (100, 173, 64)]
    steps = [6, 3, 4]   # request 1 finishes early; request 2 takes its slot
    engine = TorchSlotEngine(params, cfg, slots=2, max_len=256,
                             device=DEVICE)
    outs, _ = asyncio.run(serve_all(engine, prompts, steps))
    with torch.inference_mode():
        for prompt, n, got in zip(prompts, steps, outs):
            tokens = torch.tensor([prompt], device=DEVICE)
            want = decode.generate(params, tokens, cfg, steps=n,
                                   max_len=256)[0].tolist()
            assert got == want, (len(prompt), got, want)
            first = int(forward(params, tokens, cfg)[0, -1].argmax())
            assert got[0] == first, (len(prompt), got[0], first)
    emit({"phase": "exact", "requests": len(prompts), "tokens": outs,
          "match": True})


def _launch_counts() -> dict:
    return {"flash_fwd": flash_attention.launches,
            "flash_bwd_dkv": flash_bwd_dkv.launches,
            "flash_bwd_dq": flash_bwd_dq.launches}


def _reset_launch_counts() -> None:
    for fn in (flash_attention, flash_bwd_dkv, flash_bwd_dq):
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def _assert_routes(want: dict, route: str) -> None:
    """Every launch of K1 (``fwd``), K2 (``dkv``) and K3 (``dq``) since the
    reset took ``route``, as many as ``want`` says."""
    other = {"sm90": "scalar", "scalar": "sm90"}[route]
    assert _routes_launched() == {
        kernel: {route: want[f"flash_{name}"], other: 0}
        for kernel, name in (("fwd", "fwd"), ("dkv", "bwd_dkv"),
                             ("dq", "bwd_dq"))}, _routes_launched()


def _rel_err(got, want) -> float:
    """The largest error of ``got`` relative to ``want``'s largest
    magnitude."""
    want = want.detach().float()
    return float((got.detach().float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _train_batch(vocab, B, T, device, gen):
    seq = torch.randint(0, vocab, (B, T + 1), generator=gen, device=device)
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}


def _mesh():
    return build_mesh(MeshConfig(1, 1, 1, 1),
                      device_type=torch.device(DEVICE).type)


def phase_train(mesh=None, oracle: dict | None = None) -> dict:
    """The full-width train step: on one device (``mesh`` None, the
    ``train`` phase), or through the mesh path on ``mesh`` with every
    axis named and ``MESH_MICROBATCHES`` microbatches (``mesh_train``),
    its losses held to ``oracle``, the one-device phase's result.
    Returns the launches of the timed steps by kernel and by kernel and
    route, the median step ms and the losses, warm-up step first."""
    name = "train" if mesh is None else "mesh_train"
    M = 1 if mesh is None else MESH_MICROBATCHES
    cfg = TransformerConfig(n_layers=TRAIN_LAYERS, dtype=torch.bfloat16,
                            **SERVE_WIDTHS)
    remat = dict(remat=True, remat_policy="full")
    pcfg = (ParallelConfig(**remat) if mesh is None else ParallelConfig(
        attn="local", num_microbatches=M, **remat, **MESH_AXES))
    B, T, L = TRAIN_BATCH, TRAIN_SEQ, cfg.n_layers
    params = init_params(cfg, seed=SEED, device=DEVICE)
    n_params = sum(p.numel() for p in param_leaves(params))
    if mesh is not None:
        params = shard_params(params, pcfg, mesh)
    batch = _train_batch(cfg.vocab, B, T, DEVICE,
                         torch.Generator(device=DEVICE).manual_seed(SEED))
    step, optimizer = make_train_step(cfg, pcfg, mesh=mesh)
    opt_state = optimizer.init(params)
    torch.cuda.reset_peak_memory_stats()
    # warm-up: cuBLAS handles, the optimizer's state, the first launches
    params, opt_state, loss0 = step(params, opt_state, batch)
    torch.cuda.synchronize()

    _reset_launch_counts()
    losses, step_s = [loss0], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = _launch_counts()
    routes = _routes_launched()
    # K1 in the forward and the remat recompute of every layer, K2 and
    # K3 once, for each microbatch
    want = {"flash_fwd": 2 * L * M * TRAIN_STEPS,
            "flash_bwd_dkv": L * M * TRAIN_STEPS,
            "flash_bwd_dq": L * M * TRAIN_STEPS}
    assert launches == want, (launches, want)
    # every launch of the bf16 step took the tensor-core route
    _assert_routes(want, "sm90")
    losses = [x.item() for x in losses]
    first, last = losses[0], losses[-1]
    assert np.isfinite(first) and np.isfinite(last), (first, last)
    assert last < first, (first, last)
    # bench_model.py's accounting: 6 N per token, plus the causal
    # attention matmuls (forward and backward)
    flops = (6.0 * n_params * B * T
             + 12.0 * L * B * cfg.n_heads * T * T * cfg.head_dim / 2.0)
    step_ms = float(np.median(step_s)) * 1e3
    tflops = flops / (step_ms / 1e3) / 1e12
    row = {"phase": name, "layers": L, "batch": B, "seq": T,
           "dtype": "bfloat16", "remat": pcfg.remat_policy,
           "n_params": n_params, "steps": TRAIN_STEPS,
           "step_ms": step_ms, "step_ms_all": [x * 1e3 for x in step_s],
           "tokens_per_s": B * T / (step_ms / 1e3),
           "achieved_tflops": tflops,
           "peak_share": tflops * 1e12 / PEAK_FLOPS[torch.bfloat16],
           "loss_first": first, "loss_last": last, "losses": losses[1:],
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": {k: n // TRAIN_STEPS
                                 for k, n in launches.items()},
           "launches_per_step_by_route": {
               k: {r: n // TRAIN_STEPS for r, n in by.items()}
               for k, by in routes.items()}}
    if mesh is not None:
        # the same params, batch and steps as the oracle's: only the
        # microbatch split (bf16 roundings in another order) parts them
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, oracle["losses"]))
        row.update({"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                    "axes": MESH_AXES, "microbatches": M,
                    "backend": torch.distributed.get_backend(),
                    "oracle_step_ms": oracle["step_ms"],
                    "step_ms_over_oracle": step_ms / oracle["step_ms"],
                    "oracle_losses": oracle["losses"],
                    "loss_rel_gap_max": loss_gap,
                    "loss_tol": MESH_LOSS_TOL})
    emit(row)
    if mesh is not None:
        assert loss_gap <= MESH_LOSS_TOL, (losses, oracle["losses"])

    def one_step():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, batch)

    _profile(one_step, f"{name}_step B={B} T={T} M={M} remat=full")
    return {"launches": launches, "routes": routes, "step_ms": step_ms,
            "losses": losses}


def phase_train_exact() -> None:
    """Loss and gradients on the card (K1-K3 at a ragged T) against the
    same call on the CPU (plain versions)."""
    cfg = TransformerConfig(n_layers=2, dtype=torch.float32, **SERVE_WIDTHS)
    params = init_params(cfg, seed=SEED + 2, device=DEVICE)
    batch = _train_batch(cfg.vocab, 1, 300, "cpu",
                         torch.Generator().manual_seed(SEED + 2))

    def loss_and_grads(device):
        def leaf(p):
            return p.detach().to(device).requires_grad_()

        tree = {k: ({kk: leaf(p) for kk, p in v.items()}
                    if isinstance(v, dict) else leaf(v))
                for k, v in params.items()}
        loss = loss_fn(tree, {k: x.to(device) for k, x in batch.items()},
                       cfg)
        grads = torch.autograd.grad(loss, param_leaves(tree))
        return loss.detach(), grads

    _reset_launch_counts()
    loss, grads = loss_and_grads(DEVICE)
    torch.cuda.synchronize()
    launches = _launch_counts()
    want = dict.fromkeys(("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"), 2)
    assert launches == want, launches
    _assert_routes(want, "scalar")
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = loss_and_grads("cpu")
    cpu_s = time.perf_counter() - t0
    loss_err = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    errs = [_rel_err(g.cpu(), c) for g, c in zip(grads, cpu_grads)]
    emit({"phase": "train_exact", "layers": 2, "batch": 1, "seq": 300,
          "dtype": "float32", "loss": loss.item(), "cpu_loss": cpu_loss.item(),
          "loss_rel_err": loss_err, "grad_rel_err_max": max(errs),
          "grad_rel_err": errs, "tol": EXACT_TOL, "cpu_s": cpu_s,
          "launches": launches})
    assert loss_err <= EXACT_TOL and max(errs) <= EXACT_TOL, (loss_err, errs)


def phase_mesh_exact() -> None:
    """fp32: one SGD step through the mesh path against the oracle step
    from the same params (the loss and every reduced gradient leaf), and
    ring/Ulysses attention against local."""
    cfg = TransformerConfig(n_layers=2, dtype=torch.float32, **SERVE_WIDTHS)
    L, M = cfg.n_layers, MESH_MICROBATCHES
    mesh = _mesh()
    params0 = init_params(cfg, seed=SEED + 3, device=DEVICE)
    batch = _train_batch(cfg.vocab, 2, 300, DEVICE,
                         torch.Generator(device=DEVICE).manual_seed(SEED + 3))

    def one_step(pcfg, mesh):
        params = shard_params(params0, pcfg, mesh) if mesh else {
            k: ({kk: p.clone() for kk, p in v.items()}
                if isinstance(v, dict) else v.clone())
            for k, v in params0.items()}
        step, optimizer = make_train_step(cfg, pcfg, mesh=mesh,
                                          optimizer=SGD(MESH_EXACT_LR))
        state = optimizer.init(params)
        _reset_launch_counts()
        _, _, loss = step(params, state, batch)
        torch.cuda.synchronize()
        # the step leaves each leaf's gradient (reduced, on the mesh) in
        # its .grad
        return (loss.item(), [p.grad for p in param_leaves(params)],
                _launch_counts())

    pcfg = ParallelConfig(attn="local", num_microbatches=M, **MESH_AXES)
    loss, grads, launches = one_step(pcfg, mesh)
    want = {"flash_fwd": L * M, "flash_bwd_dkv": L * M,
            "flash_bwd_dq": L * M}
    assert launches == want, (launches, want)
    _assert_routes(want, "scalar")
    oracle_loss, oracle_grads, oracle_launches = one_step(
        ParallelConfig(), None)
    assert oracle_launches == dict.fromkeys(want, L), oracle_launches
    loss_err = abs(loss - oracle_loss) / abs(oracle_loss)
    grad_errs = [_rel_err(g, h) for g, h in zip(grads, oracle_grads)]

    attn_errs, attn_launches = {}, {}
    with torch.no_grad(), bind_mesh(mesh):
        logits = {}
        for attn in ("local", "ring", "ulysses"):
            _reset_launch_counts()
            logits[attn] = forward(params0, batch["tokens"], cfg,
                                   ParallelConfig(sp="sp", attn=attn))
            attn_launches[attn] = flash_attention.launches
        for attn in ("ring", "ulysses"):
            attn_errs[attn] = _rel_err(logits[attn], logits["local"])
    # local attention is K1 on every layer; ring and Ulysses blocks are
    # plain torch, as the reference's are plain XLA
    assert attn_launches == {"local": L, "ring": 0, "ulysses": 0}, (
        attn_launches)
    emit({"phase": "mesh_exact", "layers": L, "batch": 2, "seq": 300,
          "dtype": "float32", "microbatches": M, "optimizer": "sgd",
          "lr": MESH_EXACT_LR, "loss": loss, "oracle_loss": oracle_loss,
          "loss_rel_err": loss_err, "grad_rel_err_max": max(grad_errs),
          "grad_rel_err": grad_errs, "attn_rel_err": attn_errs,
          "tol": MESH_EXACT_TOL, "launches": launches,
          "oracle_launches": oracle_launches,
          "forward_k1_launches": attn_launches})
    assert loss_err <= MESH_EXACT_TOL["loss"], loss_err
    assert max(grad_errs) <= MESH_EXACT_TOL["grad"], grad_errs
    assert max(attn_errs.values()) <= MESH_EXACT_TOL["attn"], attn_errs


# ------------------------------------------------------------------ entry

# whole-model bf16 tolerance on logits (ROADMAP: sums across layers run
# in another order on the card)
ENTRY_TOL = 6e-2


def phase_entry() -> int:
    """``ray_tpu_torch.entry()`` on the card (head_dim 32, K1 on the sm90
    route once per layer), with K1's launch counts reset just before and
    read just after; its CPU call's params and tokens carried to the
    card against the CPU logits (the CPU and CUDA generators draw
    different params); and K1 at the entry's attention shape against
    ``attention`` (fp32, the plain path) on the same inputs, within
    K1's bf16 tolerance. Returns K1's launches in the drive."""
    _reset_launch_counts()
    fn, (params, tokens) = ray_tpu_torch.entry()
    with torch.no_grad():
        logits = fn(params, tokens)
    torch.cuda.synchronize()
    k1_launches = flash_attention.launches
    k1_routes = dict(flash_attention.launches_by_route)
    cfg = fn.keywords["cfg"]
    assert logits.shape == (4, 128, 512), logits.shape
    assert bool(torch.isfinite(logits).all())
    assert k1_launches == cfg.n_layers > 0, k1_launches
    assert k1_routes == {"sm90": k1_launches, "scalar": 0}, k1_routes
    fn, (params, tokens) = ray_tpu_torch.entry(device="cpu")
    with torch.no_grad():
        want = fn(params, tokens)
        card = {k: ({kk: p.to(DEVICE) for kk, p in v.items()}
                    if isinstance(v, dict) else v.to(DEVICE))
                for k, v in params.items()}
        got = fn(card, tokens.to(DEVICE)).cpu()
    err = float((got - want).abs().max())
    share = tol_share(got, want, ENTRY_TOL, ENTRY_TOL)
    q, k, v = _k1_inputs(ENTRY_CASE, SEED + 500)
    with torch.no_grad():
        out = flash_attention(q, k, v)
        plain = attention(q.float(), k.float(), v.float())
    k1_share = tol_share(out, plain, *TOL[torch.bfloat16]["o"])
    emit({"phase": "entry", "shape": list(logits.shape),
          "head_dim": cfg.head_dim,
          "dtype": str(cfg.dtype).removeprefix("torch."),
          "max_abs_err_vs_cpu": err, "tol": ENTRY_TOL, "tol_share": share,
          "k1_launches": k1_launches, "k1_routes": k1_routes,
          "k1_vs_attention": {
              "shape": list(ENTRY_CASE[:4]),
              "max_abs_err": float((out.float() - plain).abs().max()),
              "tol": TOL[torch.bfloat16]["o"], "tol_share": k1_share}})
    assert share <= 1.0, (err, share)
    assert k1_share <= 1.0, k1_share
    return k1_launches


# -------------------------------------------------------------- scheduler

# The cases of tests/test_scheduler_diff.py, rebuilt from their seeds,
# and the two places where the reference's kernel departs from its host
# oracle (the port follows the kernel).
SCHED_SPREAD = 0.5
# The `sched` configuration: the scale of the repo's own on-chip drain
# (ci/sched_tpu_probe.py:27, 100,000 tasks) over the reference's
# envelope of 250+ nodes (BASELINE.md:36-40), node 0 local.
SCHED_TASKS, SCHED_NODES, SCHED_WAVES = 100_000, 256, 3
SCHED_HOST_TASKS = 10_000   # the tick also held to HostBackend
SCHED_SOURCE = "ray_tpu_torch/csrc/sched_scan.cu"
# fp32 arithmetic per (task, node, resource) the scan must do where the
# task is ready on some node: avail + eps, totals - avail, + d, *
# 1/totals, * 2^20; and for every valid task the feasibility test,
# totals + eps >= d (totals + eps once per node)
SCHED_FLOPS_PER_CELL = 5
SCHED_FEASIBLE_OPS_PER_CELL = 1


def sched_random_state(rng, num_tasks, num_nodes):
    """``_random_state`` of tests/test_scheduler_diff.py: integer units,
    node 0 local."""
    nodes = []
    for i in range(num_nodes):
        total = {"CPU": float(rng.choice([2, 4, 8, 16]))}
        if rng.random() < 0.5:
            total["MEM"] = float(rng.choice([4, 8]))
        if rng.random() < 0.3:
            total["TPU"] = float(rng.choice([1, 4]))
        avail = {k: float(rng.randint(0, int(v))) for k, v in total.items()}
        nodes.append(NodeView(
            node_id=bytes([i]) * 28, address=f"tcp://n{i}",
            total=total, available=avail, is_local=(i == 0)))
    pending = []
    for t in range(num_tasks):
        res = {"CPU": float(rng.choice([1, 2, 4]))}
        if rng.random() < 0.3:
            res["MEM"] = float(rng.choice([1, 2]))
        if rng.random() < 0.2:
            res["TPU"] = float(rng.choice([1, 2]))
        locality = {}
        for n in nodes:
            if rng.random() < 0.4:
                locality[n.node_id] = rng.randint(0, 10_000_000)
        pending.append(PendingRequest(
            req_id=t + 1, scheduling_class=0, resources=res,
            locality=locality, deps_ready=rng.random() < 0.8))
    return pending, nodes


def _node(name: str, cpu: float, avail: float, local: bool) -> NodeView:
    return NodeView(node_id=name.encode() * 28, address=f"tcp://{name}",
                    total={"CPU": cpu}, available={"CPU": avail},
                    is_local=local)


def _req(req_id, cpu, **kw) -> PendingRequest:
    return PendingRequest(req_id=req_id, scheduling_class=0,
                          resources={"CPU": cpu}, **kw)


def sched_cases() -> list:
    """``(name, pending, nodes, spread)`` for every case of
    tests/test_scheduler_diff.py but the multi-tick ones."""
    cases = []
    for seed in range(8):
        rng = random.Random(seed)
        pending, nodes = sched_random_state(
            rng, num_tasks=rng.randint(1, 40), num_nodes=rng.randint(1, 6))
        cases.append((f"random_{seed}", pending, nodes, 0.5))
    cases.append(("infeasible_and_wait",
                  [_req(1, 64.0), _req(2, 1.0)],
                  [_node("a", 2.0, 0.0, True)], 0.5))
    cases.append(("spillback_when_local_full", [_req(1, 1.0)],
                  [_node("a", 2.0, 0.0, True),
                   _node("b", 2.0, 2.0, False)], 0.5))
    cases.append(("deps_gate_local_grant",
                  [_req(1, 1.0, deps_ready=False)],
                  [_node("a", 2.0, 2.0, True),
                   _node("b", 2.0, 2.0, False)], 1.0))
    cases.append(("deps_gate_spill_proceeds",
                  [_req(2, 1.0, deps_ready=False,
                        locality={b"b" * 28: 10_000_000})],
                  [_node("a", 2.0, 0.0, True),
                   _node("b", 2.0, 2.0, False)], 0.5))
    cases.append(("locality_breaks_tie",
                  [_req(1, 1.0, locality={b"c" * 28: 50_000_000})],
                  [_node("a", 2.0, 0.0, True), _node("b", 2.0, 2.0, False),
                   _node("c", 2.0, 2.0, False)], 0.5))
    cases.append(("sequential_consumption",
                  [_req(i, 1.0) for i in range(1, 4)],
                  [_node("a", 2.0, 2.0, True)], 1.0))
    return cases


def sched_quirk_cases() -> list:
    """Where the reference's kernel and its host oracle disagree; the
    port follows the kernel. ``no_local_node``: argmax(is_local) makes
    node a the local node of the hybrid rule and the frontier gate
    (host: request 1 spills to b, 2 to a; kernel: 1 to a, 2 waits).
    ``fp32_fractional``: fp32 availability and utilisation against the
    host's Python floats (kernel grants request 15 and spills 29, the
    host the other way round)."""
    return [
        ("no_local_node",
         [_req(1, 1.0, locality={b"b" * 28: 50_000_000}),
          _req(2, 1.0, deps_ready=False)],
         [_node("a", 4.0, 4.0, False), _node("b", 4.0, 4.0, False)], 0.5),
        ("fp32_fractional", [_req(i, 0.1) for i in range(1, 40)],
         [_node("a", 3.0, 3.0, True), _node("b", 3.0, 3.0, False)], 0.5),
    ]


def sched_sequence(backends, check) -> None:
    """The 12 ticks of test_resident_state_incremental_across_ticks
    (arrivals, departures, locality and dependency changes, availability
    moving between ticks) through every backend; ``check(tick, outs)``
    sees each tick's decisions per backend, and the first backend's
    drive the mutations."""
    rng = random.Random(7)
    pending, nodes = sched_random_state(rng, num_tasks=30, num_nodes=4)
    next_id = len(pending) + 1
    for tick in range(12):
        outs = [b.schedule(pending, nodes, 0.5) for b in backends]
        check(tick, outs)
        granted = {d.req_id for d in outs[0]
                   if d.action in ("grant", "spill")}
        pending = [r for r in pending if r.req_id not in granted]
        for r in pending:
            if rng.random() < 0.2:
                r.deps_ready = not r.deps_ready
            if rng.random() < 0.2:
                r.locality[nodes[rng.randrange(len(nodes))].node_id] = \
                    rng.randint(0, 10_000_000)
        for _ in range(rng.randint(0, 6)):
            res = {"CPU": float(rng.choice([1, 2, 4]))}
            pending.append(PendingRequest(
                req_id=next_id, scheduling_class=0, resources=res,
                deps_ready=rng.random() < 0.8))
            next_id += 1
        for n in nodes:
            n.available = {k: float(rng.randint(0, int(v)))
                           for k, v in n.total.items()}


def sched_config(n_tasks: int, n_nodes: int, seed: int = SEED):
    """The `sched` configuration's first tick: ``(pending, nodes)``.
    Nodes: CPU from {8, 16, 32, 64}, object store 16 or 32, half with
    memory 64 or 128, a quarter with 1, 4 or 8 GPUs; availability random
    integer units; node 0 local. Requests: CPU from {1, 2, 4}, 30 % also
    memory 1 or 2, 10 % a GPU or two; 0-100 MB of arguments on 10 % of
    the (task, node) pairs; 80 % with their dependencies ready."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        total = {"CPU": float(rng.choice([8, 16, 32, 64])),
                 "object_store_memory": float(rng.choice([16, 32]))}
        if rng.random() < 0.5:
            total["memory"] = float(rng.choice([64, 128]))
        if rng.random() < 0.25:
            total["GPU"] = float(rng.choice([1, 4, 8]))
        avail = {k: float(rng.integers(0, int(v) + 1))
                 for k, v in total.items()}
        nodes.append(NodeView(node_id=i.to_bytes(4, "big") * 7,
                              address=f"tcp://n{i}", total=total,
                              available=avail, is_local=i == 0))
    cpu = rng.choice([1.0, 2.0, 4.0], n_tasks)
    mem = np.where(rng.random(n_tasks) < 0.3,
                   rng.choice([1.0, 2.0], n_tasks), 0.0)
    gpu = np.where(rng.random(n_tasks) < 0.1,
                   rng.choice([1.0, 2.0], n_tasks), 0.0)
    deps = rng.random(n_tasks) < 0.8
    ids = [n.node_id for n in nodes]
    has = rng.random((n_tasks, n_nodes)) < 0.1
    nbytes = rng.integers(0, 100_000_001, (n_tasks, n_nodes))
    pending = []
    for t in range(n_tasks):
        res = {"CPU": float(cpu[t])}
        if mem[t]:
            res["memory"] = float(mem[t])
        if gpu[t]:
            res["GPU"] = float(gpu[t])
        cols = np.flatnonzero(has[t])
        pending.append(PendingRequest(
            req_id=t + 1, scheduling_class=0, resources=res,
            locality=dict(zip((ids[c] for c in cols),
                              nbytes[t, cols].tolist())),
            deps_ready=bool(deps[t])))
    return pending, nodes


def sched_scan_arrays(seed, tb=16, nb=8, rb=8, n_tasks=11, n_nodes=6,
                      local=True) -> tuple:
    """The scan's inputs built by hand (numpy, slot-ordered as
    ``scan_reference`` takes them), where fp32 rounding decides:
    demands and availability on a 0.05 grid and totals from {0, 3.5, 7,
    14}, so the same fractions of different totals round differently
    and utilisations tie or split by one unit of 2^-20 (utilisation as
    used / totals in place of used * (1 / totals) moves thousands of
    these decisions); locality over the whole int32 range, padding
    positions and nodes, a shuffled perm; node 2 local, or none."""
    rng = np.random.default_rng(seed)
    demands = (rng.integers(0, 6, (tb, rb)) * 0.05).astype(np.float32)
    demands[:, rb // 2:] = 0
    locality = np.where(rng.random((tb, nb)) < 0.5,
                        rng.integers(0, 2**31 - 1, (tb, nb)),
                        0).astype(np.int32)
    dep_ready = rng.random(tb) < 0.7
    perm = rng.permutation(tb).astype(np.int32)
    totals = rng.choice([0.0, 3.5, 7.0, 14.0], (nb, rb))
    totals[:, rb // 2:] = 0
    avail = np.floor(totals * rng.random((nb, rb)) / 0.05) * 0.05
    is_local = np.zeros(nb, bool)
    is_local[2] = local
    valid_task = np.arange(tb) < n_tasks
    valid_node = np.arange(nb) < n_nodes
    return (demands, locality, dep_ready, perm, totals.astype(np.float32),
            avail.astype(np.float32), is_local, valid_task, valid_node)


def sched_signed_arrays(seed, tb=16, nb=8, rb=8, n_tasks=11, n_nodes=6,
                        local=True, negative=0.1, zero=0.1) -> tuple:
    """``sched_scan_arrays`` with a ``zero`` share of the valid
    positions' demand rows all zeros and a ``negative`` share with a
    negative first kind (-0.05 to -0.3): a grant of those gives
    availability back, so a task not ready before it may be after."""
    arrays = list(sched_scan_arrays(seed, tb, nb, rb, n_tasks, n_nodes,
                                    local))
    rng = np.random.default_rng(seed + 1000)
    demands, perm = arrays[0], arrays[3]
    rows = perm[:n_tasks]
    pick = rng.random(n_tasks)
    demands[rows[pick < zero]] = 0
    neg = rows[pick > 1 - negative]
    demands[neg, 0] = -(rng.integers(1, 7, neg.shape[0]) * 0.05).astype(
        np.float32)
    return tuple(arrays)


def sched_late_arrays(seed, tb=1024, nb=32, rb=8, n_large=900,
                      n_tasks=1000, n_nodes=30, local=True) -> tuple:
    """``sched_scan_arrays`` where placements resume late: the first
    ``n_large`` positions ask 7 of the first kind, which the nodes with 7
    or 14 in total hold but none has free (availability of that kind is
    capped at 3), and the positions after them keep their small demands
    (at most 0.25 a kind), which place."""
    arrays = list(sched_scan_arrays(seed, tb, nb, rb, n_tasks, n_nodes,
                                    local))
    demands, perm, avail = arrays[0], arrays[3], arrays[5]
    demands[perm[:n_large]] = 0
    demands[perm[:n_large], 0] = 7.0
    avail[:, 0] = np.minimum(avail[:, 0], np.float32(3.0))
    return tuple(arrays)


def sched_dense(arrays, scale: float = 1000.0) -> tuple:
    """The same scan with totals and availability ``scale`` times the
    totals and every dependency ready: every task a node can hold
    places."""
    (demands, locality, dep_ready, perm, totals, _, is_local, valid_task,
     valid_node) = (np.asarray(a) for a in arrays)
    big = (totals * np.float32(scale)).astype(np.float32)
    return (demands, locality, np.ones_like(dep_ready), perm, big,
            big.copy(), is_local, valid_task, valid_node)


# sched_scan_arrays on the card: (seed, t_bucket, n_bucket, tasks,
# nodes, a local node, spread)
SCHED_ARRAY_CASES = [(s, 8192, 256, 8000, 250, s % 2 == 0, sp)
                     for s, sp in enumerate((0.5, 0.3, 0.5, 1.0))]
# The kernel alone on the card, beside them: negative and zero demand
# rows, placements that resume after 7,000 positions, and a node bucket
# whose state does not fit shared memory (the global route).
SCHED_SIGNED_CASE = (11, 8192, 256, 8000, 250, True, 0.5)
SCHED_LATE_CASE = (12, 8192, 256, 7000, 8000, 250, True, 0.5)
SCHED_GLOBAL_CASE = (13, 2048, 4096, 2000, 4000, True, 0.5)


def _decisions(ds) -> list:
    return [(d.req_id, d.action, d.spill_address) for d in ds]


def _sched_agree(name, kernel, host, ref, host_must_agree=True) -> bool:
    """The kernel's decisions equal scan_reference's; and the host's,
    unless the case is one where the reference departs from its host.
    Returns whether the host agreed."""
    kernel, host, ref = _decisions(kernel), _decisions(host), \
        _decisions(ref)
    assert kernel == ref, (name, "kernel != scan_reference",
                           [(a, b) for a, b in zip(kernel, ref) if a != b])
    if host_must_agree:
        assert kernel == host, (name, "kernel != HostBackend",
                                [(a, b) for a, b in zip(kernel, host)
                                 if a != b])
    return kernel == host


@contextlib.contextmanager
def _recorded_scans(log: list):
    """Keep a reference to every scan launch's inputs and actions; the
    caller copies them (``_keep_scan``) outside its timed window, before
    the next tick rewrites the resident rows."""
    real = cuda_batched._launch_sched_scan

    def recording(ins, spread_fp):
        actions = real(ins, spread_fp)
        log.append((ins, spread_fp, actions))
        return actions

    cuda_batched._launch_sched_scan = recording
    try:
        yield
    finally:
        cuda_batched._launch_sched_scan = real


def _keep_scan(entry) -> tuple:
    """One recorded launch as ``(cpu_args, cpu_actions, card_args)``:
    CPU copies for scan_reference, card copies for the timing."""
    ins, spread_fp, actions = entry
    return ([x.cpu() for x in ins] + [spread_fp], actions.cpu(),
            [x.clone() for x in ins] + [spread_fp])


def sched_bound(scan_args, n_tasks: int, n_rows: int | None = None):
    """Least time for one scan of ``n_tasks`` valid positions over the
    real nodes and resource kinds (not the buckets' padding): per task
    its demands over the kinds, its dependency flag, perm and valid_task
    entries read once and its action written once; the dense locality
    rows of ``n_rows`` tasks (default all; ``sched_ready_positions``
    counts the rows the output needs); the node table (totals,
    availability, is_local, valid_node) read once; against the
    feasibility test of every task (SCHED_FEASIBLE_OPS_PER_CELL per
    (task, node, kind)) and SCHED_FLOPS_PER_CELL fp32 operations per
    (task, node, kind) over the ``n_rows`` tasks, at the fp32 peak.
    Returns ``(ms, bound_by, bytes, operations, kinds, nodes)``."""
    demands, totals, valid_node = scan_args[0], scan_args[4], scan_args[8]
    kinds = int(((totals != 0).any(0) | (demands != 0).any(0)).sum())
    nodes = int(valid_node.sum())
    n_rows = n_tasks if n_rows is None else n_rows
    nbytes = (n_tasks * (kinds * 4 + 1 + 4 + 1 + 4) + n_rows * nodes * 4
              + nodes * (kinds * 4 * 2 + 2))
    ops = (SCHED_FEASIBLE_OPS_PER_CELL * n_tasks
           + SCHED_FLOPS_PER_CELL * n_rows) * nodes * kinds
    ms, by = _bound(ops, nbytes, torch.float32)
    return ms, by, nbytes, ops, kinds, nodes


def sched_ready_positions(scan_args, actions, block: int = 2048) -> int:
    """How many valid positions are ready on some valid node at their
    turn (feasible and ``avail + 1e-9 >= d`` in fp32 on every kind), by
    replaying ``actions`` (scan_reference's) on the scan's inputs: only
    those need their locality row, since a position ready nowhere is
    WAIT or INFEASIBLE whatever its row. Between two placements the
    availability is fixed, so the positions up to each placement are
    tested together, ``block`` at a time."""
    demands, perm, totals, avail0, valid_task, valid_node = (
        np.asarray(scan_args[i]) for i in (0, 3, 4, 5, 7, 8))
    actions = np.asarray(actions)
    eps = np.float32(1e-9)
    dem = demands[perm.astype(np.int64)]
    valid, vnode = valid_task.astype(bool), valid_node.astype(bool)
    feasible = totals + eps
    avail = avail0.copy()
    ready, start = 0, 0
    for end in [*np.flatnonzero(actions >= 0), perm.shape[0]]:
        # positions start..end see the availability before end's grant
        idx = np.arange(start, min(end + 1, perm.shape[0]))
        idx = idx[valid[idx]]
        for lo in range(0, idx.shape[0], block):
            d = dem[idx[lo:lo + block]][:, None, :]
            ready += int((vnode & np.all(feasible >= d, axis=2)
                          & np.all(avail + eps >= d, axis=2)).any(1).sum())
        if end < perm.shape[0]:
            avail[actions[end]] = avail[actions[end]] - dem[end]
        start = end + 1
    return ready


def sched_redraw(nodes, rng) -> None:
    """Between drain waves: every node's availability drawn anew (as in
    ``sched_config``), as the previous waves' tasks finish and others
    take their place."""
    for n in nodes:
        n.available = {k: float(rng.integers(0, int(v) + 1))
                       for k, v in n.total.items()}


def sched_host_split(pending, nodes, top: int = 12) -> dict:
    """cProfile of one first tick of a fresh backend (every row
    uploaded): its wall under the profiler and the functions that take
    the most time of their own. The profiler slows the Python-level
    calls, so read the shares, not the times."""
    backend = CudaBatchedBackend()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    backend.schedule(pending, nodes, SCHED_SPREAD)
    torch.cuda.synchronize()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)
    return {"profiled_wall_ms": wall_ms, "by_own_time": [
        {"fn": f"{path.rsplit('/', 1)[-1]}:{line}({name})",
         "calls": nc, "own_ms": tt * 1e3, "cum_ms": ct * 1e3}
        for (path, line, name), (_, nc, tt, ct, _) in rows[:top]]}


def _kernel_case(name, arrays, spread, shared=True, timed=False) -> dict:
    """The kernel alone on numpy ``arrays`` against scan_reference;
    asserts equal actions and the route (state in shared memory or in
    global memory). Returns the actions' tally, the walk counters and,
    ``timed``, the kernel's ms."""
    arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    spread_fp = int(spread * (1 << 20))
    want = scan_reference(*arrays, spread_fp)
    card = [a.to(DEVICE) for a in arrays]
    got = sched_scan(*card, spread_fp).cpu()
    walk = walk_counters(sched_scan.last_walk)
    assert torch.equal(got, want), (name, int((got != want).sum()))
    assert walk["shared"] == int(shared), (name, walk)
    placed = want >= 0
    out = {"placed": int(placed.sum()),
           "wait": int(((want == -1) & arrays[7]).sum()),
           "infeasible": int((want == -2).sum()),
           "placed_negative": int((arrays[0][arrays[3][placed].long()]
                                   < 0).any(1).sum()),
           "walk": walk}
    if timed:
        out["ms"] = time_ms(lambda: sched_scan(*card, spread_fp), 10)
    return out


def _walk_split(ms: float, walk: dict) -> dict:
    """One scan's event time split by the walk kernel's own global-timer
    counts: its set-up, its loop, and the rest (the pre-pass and the gap
    between the two kernels), in ms."""
    init_ms, loop_ms = walk["init_ns"] / 1e6, walk["walk_ns"] / 1e6
    return {"walk_init_ms": init_ms, "walk_loop_ms": loop_ms,
            "prepass_and_gap_ms": ms - init_ms - loop_ms}


def phase_scheduler() -> dict:
    """The cuda_batched backend against scan_reference and HostBackend
    (exact decisions) on the small cases, the 12-tick sequence and the
    reference's two quirks; the kernel alone on fractional, signed
    (negative and zero demands), late-resuming and global-route arrays;
    then the `sched` configuration: a first tick of SCHED_TASKS pending
    over SCHED_NODES nodes and SCHED_WAVES drain waves (granted and
    spilled requests leave, no request arrives, every node's
    availability is drawn anew before each wave), with the scan's
    launches counted over that run; then the first tick's scan with
    every task placing (the dense case). Returns the kernels-line
    row."""
    t_phase = time.perf_counter()
    host = HostBackend()

    def three_ways(name, pending, nodes, spread, host_must_agree=True):
        return _sched_agree(
            name, CudaBatchedBackend().schedule(pending, nodes, spread),
            host.schedule(pending, nodes, spread),
            CudaBatchedBackend(device="cpu").schedule(pending, nodes, spread),
            host_must_agree)

    for case in sched_cases():
        three_ways(*case)
    quirks = {case[0]: {"host_agrees": three_ways(*case, False)}
              for case in sched_quirk_cases()}
    # the kernel alone on fractional arrays against scan_reference
    array_actions = {}
    for seed, tb, nb, n_tasks, n_nodes, local, spread in SCHED_ARRAY_CASES:
        array_actions[seed] = _kernel_case(seed, sched_scan_arrays(
            seed, tb, nb, 8, n_tasks, n_nodes, local), spread)
    seed, tb, nb, n_tasks, n_nodes, local, spread = SCHED_SIGNED_CASE
    array_actions["signed"] = _kernel_case("signed", sched_signed_arrays(
        seed, tb, nb, 8, n_tasks, n_nodes, local), spread)
    # grants of negative demands gave availability back
    assert array_actions["signed"]["placed_negative"] > 0, array_actions
    seed, tb, nb, n_large, n_tasks, n_nodes, local, spread = SCHED_LATE_CASE
    array_actions["late"] = _kernel_case("late", sched_late_arrays(
        seed, tb, nb, 8, n_large, n_tasks, n_nodes, local), spread,
        timed=True)
    seed, tb, nb, n_tasks, n_nodes, local, spread = SCHED_GLOBAL_CASE
    array_actions["global"] = _kernel_case("global", sched_scan_arrays(
        seed, tb, nb, 8, n_tasks, n_nodes, local), spread, shared=False)
    seq_kernel, seq_cpu = CudaBatchedBackend(), CudaBatchedBackend("cpu")

    def check(tick, outs):
        _sched_agree(f"sequence tick {tick}", *outs)

    sched_sequence([seq_kernel, host, seq_cpu], check)
    assert seq_kernel.num_row_uploads == seq_cpu.num_row_uploads > 30, (
        seq_kernel.num_row_uploads, seq_cpu.num_row_uploads)
    assert seq_kernel.num_rebuilds == seq_cpu.num_rebuilds
    small_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    pending, nodes = sched_config(SCHED_TASKS, SCHED_NODES)
    gen_s = time.perf_counter() - t0
    # a 10,000-pending tick of the same cluster against the host oracle
    sub = pending[:SCHED_HOST_TASKS]
    t0 = time.perf_counter()
    want = HostBackend().schedule(sub, nodes, SCHED_SPREAD)
    host_tick_ms = (time.perf_counter() - t0) * 1e3
    got = CudaBatchedBackend().schedule(sub, nodes, SCHED_SPREAD)
    assert _decisions(got) == _decisions(want), "10k tick != HostBackend"

    backend = CudaBatchedBackend()
    first_pending = pending
    redraw = np.random.default_rng(SEED + 1)
    scans, ticks = [], []
    torch.cuda.synchronize()
    sched_scan.launches = 0
    with _recorded_scans(scans):
        for wave in range(1 + SCHED_WAVES):
            if wave:
                sched_redraw(nodes, redraw)
            uploads = backend.num_row_uploads
            t0 = time.perf_counter()
            decisions = backend.schedule(pending, nodes, SCHED_SPREAD)
            wall_ms = (time.perf_counter() - t0) * 1e3
            scans[-1] = _keep_scan(scans[-1])
            placed = {d.req_id for d in decisions
                      if d.action in ("grant", "spill")}
            ticks.append({"pending": len(pending), "placed": len(placed),
                          "row_uploads": backend.num_row_uploads - uploads,
                          "wall_ms": wall_ms,
                          "walk": walk_counters(sched_scan.last_walk)})
            pending = [r for r in pending if r.req_id not in placed]
    launches = sched_scan.launches
    assert launches == len(scans) == 1 + SCHED_WAVES, (launches, len(scans))
    assert backend.num_row_uploads == SCHED_TASKS, backend.num_row_uploads
    assert all(t["placed"] == t["walk"]["placements"] > 0
               and t["walk"]["shared"] == 1 for t in ticks), ticks
    host_split = sched_host_split(first_pending, nodes)

    # every tick's scan against scan_reference on the same inputs
    plain_s, max_err, refs = [], 0, []
    for (cpu_args, actions, _), tick in zip(scans, ticks):
        t0 = time.perf_counter()
        ref = scan_reference(*cpu_args)
        plain_s.append(time.perf_counter() - t0)
        refs.append(ref)
        max_err = max(max_err, int((actions - ref).abs().max()))
        assert torch.equal(actions, ref), (
            tick, int((actions != ref).sum()))
    first_args, first_tasks = scans[0][2], ticks[0]["pending"]
    inc_args, inc_tasks = scans[1][2], ticks[1]["pending"]
    # the first tick's scan with every task placing: nothing to skip
    dense_cpu = [torch.from_numpy(a) for a in sched_dense(
        [x.numpy() for x in scans[0][0][:9]])] + [scans[0][0][9]]
    dense_args = [x.to(DEVICE) for x in dense_cpu[:9]] + [dense_cpu[9]]
    dense_ref = scan_reference(*dense_cpu)
    assert int((dense_ref >= 0).sum()) == first_tasks, "dense: not all place"
    for args, ref, name in ((first_args, refs[0], "first"),
                            (inc_args, refs[1], "incremental"),
                            (dense_args, dense_ref, "dense")):
        got = sched_scan(*args).cpu()
        assert torch.equal(got, ref), (name, int((got != ref).sum()))
    # CUDA events bracket back-to-back launches of a few ms or more, so
    # they time the device (a profiler window over this scan, late in the
    # script, has recorded no device event on an H100); the walk kernel's
    # own counts, of the last timed launch, split that time
    first_ms = time_ms(lambda: sched_scan(*first_args), 10)
    first_split = _walk_split(first_ms, walk_counters(sched_scan.last_walk))
    inc_ms = time_ms(lambda: sched_scan(*inc_args), 10)
    inc_split = _walk_split(inc_ms, walk_counters(sched_scan.last_walk))
    dense_ms = time_ms(lambda: sched_scan(*dense_args), 3)
    dense_walk = walk_counters(sched_scan.last_walk)
    dense_split = _walk_split(dense_ms, dense_walk)
    assert dense_walk["placements"] == first_tasks, dense_walk
    first_walk = ticks[0]["walk"]
    # the old bound reads every valid task's locality row; the output
    # needs those of the positions ready on some node at their turn
    bound_all_ms, _, nbytes_all, _, kinds, real_nodes = sched_bound(
        first_args, first_tasks)
    rows = sched_ready_positions(scans[0][0], refs[0])
    bound_ms, bound_by, nbytes, ops, _, _ = sched_bound(
        first_args, first_tasks, rows)
    row = {"phase": "scheduler", "cases": len(sched_cases()),
           "sequence_ticks": 12, "quirks": quirks,
           "array_cases": array_actions,
           "sequence_row_uploads": seq_kernel.num_row_uploads,
           "config": {"tasks": SCHED_TASKS, "nodes": SCHED_NODES,
                      "resource_kinds": kinds, "spread": SCHED_SPREAD,
                      "t_bucket": first_args[3].shape[0],
                      "n_bucket": first_args[4].shape[0],
                      "r_bucket": first_args[4].shape[1],
                      "chunk": cuda_batched.SCAN_CHUNK},
           "ticks": ticks, "launches": launches,
           "row_uploads": backend.num_row_uploads,
           "rebuilds": backend.num_rebuilds,
           "kernel_ms_first": first_ms, "kernel_ms_incremental": inc_ms,
           "us_per_task_first": first_ms * 1e3 / first_tasks,
           "us_per_task_incremental": inc_ms * 1e3 / inc_tasks,
           "us_per_placement_first": first_ms * 1e3
           / first_walk["placements"],
           "walk_loop_us_per_placement_first": first_split["walk_loop_ms"]
           * 1e3 / first_walk["placements"],
           "split_first": first_split, "split_incremental": inc_split,
           "dense_ms": dense_ms, "dense_us_per_task": dense_ms * 1e3
           / first_tasks, "dense_split": dense_split,
           "dense_walk": dense_walk,
           "tick_wall_ms_first": ticks[0]["wall_ms"],
           "tick_wall_ms_incremental": [t["wall_ms"] for t in ticks[1:]],
           "plain_ms": [x * 1e3 for x in plain_s],
           "bound_bytes": nbytes, "bound_operations": ops,
           "bound_rows": rows,
           "bound_kinds": kinds, "bound_nodes": real_nodes,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_ms_all_rows": bound_all_ms,
           "bound_bytes_all_rows": nbytes_all,
           "serial_chain": first_walk["placements"],
           "host_split_first_tick": host_split,
           "host_tick_ms_10k": host_tick_ms, "config_gen_s": gen_s,
           "small_cases_s": small_s,
           "phase_s": time.perf_counter() - t_phase, "card": card_line()}
    emit(row)
    return {"name": "sched_scan", "route": "cuda", "source": SCHED_SOURCE,
            "replaces": "ray_tpu/_private/scheduler/tpu_batched.py:124",
            "replaces_kind": "XLA scan (lax.scan), not a Pallas kernel",
            "launches": launches, "max_abs_err": max_err, "ms": first_ms,
            "device_kernels": ["sched_prepass_kernel", "sched_walk_kernel"],
            "incremental_ms": inc_ms, "dense_ms": dense_ms,
            "plain_ms": row["plain_ms"][0],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_all_rows": bound_all_ms,
            "serial_chain": first_walk["placements"], "library_ms": None,
            "shape": [first_tasks, real_nodes, kinds]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    phase_env(card)
    phase_build()
    k1 = phase_kernel()
    serve_launches, serve_routes = phase_serve()
    phase_exact()
    bwd = phase_kernel_bwd()
    train = phase_train()
    phase_train_exact()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp, \
            process_group(0, 1, device=DEVICE,
                          init_method=f"file://{tmp}/store", timeout_s=600):
        mesh_launches = phase_train(_mesh(), oracle=train)["launches"]
        phase_mesh_exact()
    entry_launches = phase_entry()
    sched_row = phase_scheduler()
    train_launches, train_routes = train["launches"], train["routes"]
    # K2 and K3 at the training shape on each route: bf16 (the train
    # path) on sm90, fp32 on the scalar kernels
    by_route = {"sm90": bwd[TRAIN_CASE], "scalar": bwd[TRAIN_CASE_FP32]}

    def bwd_numbers(row, kernel, outs):
        # SDPA's backward computes dQ, dK and dV in one call: both K2's
        # and K3's library_ms are that call's device time
        # (library_computes says so)
        return {"max_abs_err": max(row["max_abs_err_by"][o] for o in outs),
                "ms": row[f"{kernel}_ms"],
                "plain_ms": row[f"{kernel}_plain_ms"],
                "bound_ms": row[f"{kernel}_bound_ms"],
                "bound_by": row[f"{kernel}_bound_by"],
                "library_ms": row["library_bwd_ms"],
                "library_computes": "dq, dk, dv"}

    def k1_numbers(row):
        return {key: row[key] for key in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}

    # K1 at the prefill width on each route: bf16 (the serve path) on
    # sm90, fp32 on the scalar kernel; and at the training shape
    k1_by_route = {"sm90": k1[PREFILL_CASE], "scalar": k1[PREFILL_CASE_FP32]}
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": FWD_SOURCES["sm90"],
         "replaces": "ray_tpu/ops/attention.py:57",
         "launches": serve_launches,
         "launches_by_path": {"serve": serve_launches,
                              "train": train_launches["flash_fwd"],
                              "mesh_train": mesh_launches["flash_fwd"],
                              "entry": entry_launches},
         # over both paths
         "launches_by_route": {r: serve_routes[r] + train_routes["fwd"][r]
                               for r in serve_routes},
         **k1_numbers(k1_by_route["sm90"]),
         "train_shape": k1_numbers(k1[TRAIN_CASE]),
         "routes": {route: {"source": FWD_SOURCES[route],
                            "dtype": row["dtype"], **k1_numbers(row)}
                    for route, row in k1_by_route.items()}},
        *({"name": f"flash_bwd_{kernel}", "route": "cuda",
           "source": BWD_SOURCES["sm90"],
           "replaces": f"ray_tpu/ops/attention.py:{line}",
           "launches": train_launches[f"flash_bwd_{kernel}"],
           "launches_by_path": {
               "train": train_launches[f"flash_bwd_{kernel}"],
               "mesh_train": mesh_launches[f"flash_bwd_{kernel}"]},
           "launches_by_route": train_routes[kernel],
           **bwd_numbers(by_route["sm90"], kernel, outs),
           "routes": {route: {"source": BWD_SOURCES[route],
                              "dtype": row["dtype"],
                              **bwd_numbers(row, kernel, outs)}
                      for route, row in by_route.items()}}
          for kernel, line, outs in (("dkv", 190, ("dk", "dv")),
                                     ("dq", 224, ("dq",)))),
        sched_row]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
