#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each, in order:

1. ``env``: torch and nvcc versions, the card's name and power limit.
2. ``build``: compiles every kernel in ``ray_tpu_torch/csrc`` from the
   checkout (one nvcc per source, all at once) and reports the seconds.
3. ``kernel``: K1 (``csrc/flash_fwd.cu``) against its plain version
   ``flash_attention_reference`` on the card, O and lse, at the serving
   prefill shape and around it; kernel, plain and
   ``scaled_dot_product_attention`` (a yardstick only; the port never
   calls it) timed with CUDA events beside the least time the card
   could take.
4. ``serve``: the full-width decoder (vocab 32768, d_model 1024, 16
   heads, 8 layers, d_ff 4096, bf16; depth as in the model bench) behind
   ``DecodeScheduler`` + ``TorchSlotEngine`` (16 slots, max_len 1024)
   answering 32 concurrent requests with ragged prompts and lengths.
   K1's launch count is reset just before and read just after.
5. ``exact``: the same widths in fp32 at 2 layers; greedy tokens
   through the slot engine (a slot freed and reused mid-flight) equal
   the whole-batch ``generate`` exactly, and each first token equals
   the argmax of ``forward`` on the prompt.

Then the ``kernels`` line, the ``nvidia-smi`` card line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero; without
CUDA it exits 1 before printing a result.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private import kernels
from ray_tpu_torch.models import decode
from ray_tpu_torch.models.transformer import (TransformerConfig, forward,
                                              init_params)
from ray_tpu_torch.ops.attention import (flash_attention,
                                         flash_attention_reference,
                                         flash_forward)
from ray_tpu_torch.serve.decode_scheduler import (DecodeScheduler,
                                                  TorchSlotEngine)

SEED = 0
DEVICE = "cuda"
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# O and lse tolerances of K1 against its plain version: fp32 differs
# only in summation order; bf16 O may round one ulp apart.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 1e-2)}
PREFILL_CASE = (1, 512, 16, 64, torch.bfloat16, True)
KERNEL_CASES = [
    PREFILL_CASE,
    (1, 512, 16, 64, torch.float32, True),
    (16, 512, 16, 64, torch.bfloat16, True),
    (16, 512, 16, 64, torch.float32, True),
    (1, 300, 16, 64, torch.bfloat16, True),    # ragged tail of T
    (1, 300, 16, 64, torch.float32, True),
    (1, 512, 16, 64, torch.bfloat16, False),
    (2, 256, 8, 128, torch.bfloat16, True),    # head_dim 128
    (2, 256, 8, 128, torch.float32, True),
]
SERVE_WIDTHS = dict(vocab=32768, d_model=1024, n_heads=16, d_ff=4096,
                    max_seq=1024)


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
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
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


def k1_bound(B, T, H, D, dtype, causal):
    """Least time for K1's work: 2 matmuls of 2 flops per (q, k) pair the
    mask keeps, against q, k, v read once and O, lse written once."""
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = 4 * B * H * D * pairs
    nbytes = 4 * B * T * H * D * torch.finfo(dtype).bits // 8 + B * H * T * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def phase_kernel() -> dict:
    rows, failures = {}, []
    for i, case in enumerate(KERNEL_CASES):
        B, T, H, D, dtype, causal = case
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + i)
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device=DEVICE)
                   .to(dtype) for _ in range(3))
        out, lse = flash_forward(q, k, v, causal=causal)
        ref, ref_lse = flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol_o, tol_lse = TOL[dtype]
        err_o = float((out.float() - ref.float()).abs().max())
        err_lse = float((lse - ref_lse).abs().max())
        ok = (torch.allclose(out.float(), ref.float(), atol=tol_o,
                             rtol=tol_o)
              and torch.allclose(lse, ref_lse, atol=tol_lse, rtol=tol_lse))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        iters = 20 if B * T * H > 2 ** 15 else 100
        bound_ms, bound_by = k1_bound(*case)
        row = {"phase": "kernel", "shape": [B, T, H, D],
               "dtype": str(dtype).removeprefix("torch."), "causal": causal,
               "max_abs_err": err_o, "max_abs_err_lse": err_lse,
               "tol": [tol_o, tol_lse], "ok": ok,
               "ms": time_ms(lambda: flash_forward(q, k, v, causal=causal),
                             iters),
               "plain_ms": time_ms(lambda: flash_attention_reference(
                   q, k, v, causal=causal), iters),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal), iters),
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        rows[case] = row
        if not ok:
            failures.append(case)
    if failures:
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"{failures}")
    return rows[PREFILL_CASE]


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


def phase_serve() -> int:
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
    flash_attention.launches = 0
    t0 = time.perf_counter()
    outs, stats = asyncio.run(serve_all(engine, prompts, max_tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches

    for toks, n in zip(outs, max_tokens):
        assert len(toks) == n, (len(toks), n)
        assert all(0 <= t < cfg.vocab for t in toks)
    assert engine.prefills == len(prompts), engine.prefills
    assert launches == cfg.n_layers * engine.prefills, (
        launches, engine.prefills)
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
          "prefills": engine.prefills, "flash_launches": launches})
    phase_profile(engine.engine, prompts[0][:512])
    return launches


def _profile(fn, label: str) -> None:
    """Device time by kernel over one call of ``fn`` (after a warm-up
    call): wall, summed kernel time and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's entry repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "profile", "window": label, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
          "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                  for e in top]})


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
    launches = phase_serve()
    phase_exact()
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:57",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
