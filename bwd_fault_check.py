#!/usr/bin/env python3
"""Show that ``chip_smoke.py``'s K1, K2/K3 and scheduler checks reject a
wrong kernel.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 bwd_fault_check.py WORKDIR

For each planted fault it copies ``ray_tpu_torch/`` and
``chip_smoke.py`` into ``WORKDIR/<fault>/``, edits the copy of one
kernel source (the checkout is never touched), and runs the check of
the kernel it planted the fault in, at the training shape (16 x 1024 x
16 x 64, causal), once under chip_smoke's tolerance and once under a
looser one:

* K1 faults, in ``csrc/flash_fwd_sm90.cu``: ``chip_smoke``'s ``kernel``
  phase in bf16 under ``chip_smoke.TOL`` (two bf16 ulps on O, 1e-5 on
  lse), and under the (3e-2, 1e-2) that check held before.
* K2/K3 faults, in ``csrc/flash_bwd_sm90.cu`` and the ``csrc/sm90.cuh``
  helpers it shares with K1 (the bf16 route) and in
  ``csrc/flash_bwd.cu`` (the scalar route, run in fp32): the
  ``kernel_bwd`` phase under ``chip_smoke.BWD_TOL``, and under the 1e-1
  of ``tests/test_ops.py``.
* ``sched_scan`` faults, in ``csrc/sched_scan.cu``: the whole
  ``scheduler`` phase, whose decisions must equal ``scan_reference``'s
  and ``HostBackend``'s exactly (there is no looser check). Four break
  the scan's arithmetic or rules; one breaks the walk's exit test.

A ``control`` copy with no fault must pass every check. At most six
copies run at once. Prints one JSON line per copy (each check's verdicts
and the worst shares of its allowance) and exits 0 only if the control
passes and every fault is rejected under chip_smoke's tolerance.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

K1_SM90 = "ray_tpu_torch/csrc/flash_fwd_sm90.cu"
SM90 = "ray_tpu_torch/csrc/flash_bwd_sm90.cu"
SM90_HELPERS = "ray_tpu_torch/csrc/sm90.cuh"
SCALAR = "ray_tpu_torch/csrc/flash_bwd.cu"
SCHED = "ray_tpu_torch/csrc/sched_scan.cu"
# check -> chip_smoke's phase and case: K1 in bf16, K2/K3 on each route,
# the scheduler phase whole
CHECKS = {"k1": ("kernel", "TRAIN_CASE"),
          "bf16": ("kernel_bwd", "TRAIN_CASE"),
          "fp32": ("kernel_bwd", "TRAIN_CASE_FP32"),
          "sched": ("scheduler", None)}
# fault -> (source, its text, the replacement), the checks it runs
FAULTS = {
    "control": (None, ("k1", "bf16", "fp32", "sched")),
    # K1's causal k-loop ends one k-tile early: the diagonal tile is lost
    "k1_causal_end_one_tile_early": ((
        K1_SM90, "const int n_k = (k_end + kBlock - 1) / kBlock;",
        "const int n_k = (k_end + kBlock - 1) / kBlock - a.causal;"),
        ("k1",)),
    # P goes to P.V as one bf16 rounding (hi only), as FlashAttention-2/3
    # do: the lo half of the split is dropped
    "k1_drop_lo_half": ((
        K1_SM90, "wgmma_rs(o_acc[x], p_lo[kk], mnmajor(vs, x, kk));",
        ""), ("k1",)),
    # O is not rescaled by alpha when a row's max moves
    "k1_no_alpha_rescale": ((
        K1_SM90,
        "for (int i = 0; i < 32; ++i) o_acc[x][i] *= alpha[(i % 4) / 2];",
        "for (int i = 0; i < 32; ++i) {}"), ("k1",)),
    # lse written as m without log(l)
    "k1_lse_without_log_l": ((
        K1_SM90, "a.lse[row0 + t] = m[r] * a.sm_scale + logf(li[r]);",
        "a.lse[row0 + t] = m[r] * a.sm_scale;"), ("k1",)),
    # K2 skips the q-tile on the causal diagonal: dK, dV lose its terms
    "k2_causal_start_one_tile_late": ((
        SM90, "const int qt0 = in.causal ? kt : 0;",
        "const int qt0 = in.causal ? kt + 1 : 0;"), ("bf16",)),
    # K2 writes zeros for the second k-tile's dK
    "k2_zero_dk_tile": ((
        SM90, "store_acc<D>(dk_acc[x], dkh, sdk.t, k0, x, seq);",
        "if (blockIdx.y == 1)\n      for (int i = 0; i < 32; ++i) "
        "dk_acc[x][i] = 0.f;\n    "
        "store_acc<D>(dk_acc[x], dkh, sdk.t, k0, x, seq);"), ("bf16",)),
    # K3 stops before the k-tile on the causal diagonal
    "k3_causal_end_one_tile_early": ((
        SM90, "const int n_k = in.causal ? qt + 1 :",
        "const int n_k = in.causal ? qt :"), ("bf16",)),
    # p and ds go to the products as one bf16 rounding (hi only): the lo
    # half of the shared split helper is dropped (K1's too, whose O and
    # lse the check feeds both K2/K3 and their plain version)
    "sm90_drop_lo_half": ((
        SM90_HELPERS, "lo = bf16x2(x0 - hf.x, x1 - hf.y);",
        "lo = bf16x2(0.f, 0.f);"), ("bf16",)),
    # the same three K2/K3 faults in the scalar route, held at fp32
    "scalar_k2_causal_start_one_tile_late": ((
        SCALAR, "for (int qt = in.causal ? k0 / kBlock : 0;",
        "for (int qt = in.causal ? k0 / kBlock + 1 : 0;"), ("fp32",)),
    "scalar_k2_zero_dk_tile": ((
        SCALAR, "dkrow[tx + 16 * c] = from_float<T>(dk_acc[i][c]);",
        "dkrow[tx + 16 * c] = from_float<T>(blockIdx.x == 1 ? 0.f "
        ": dk_acc[i][c]);"), ("fp32",)),
    "scalar_k3_causal_end_one_tile_early": ((
        SCALAR,
        "const int k_end = in.causal ? min(seq, q0 + kBlock) : seq;",
        "const int k_end = in.causal ? min(seq, q0) : seq;"), ("fp32",)),
    # utilisation as used / totals, not used * (1 / totals): one rounding
    # apart, which moves a ceil at the spread threshold
    "sched_divide_not_reciprocal": ((
        SCHED, "__fmul_rn(__fadd_rn(c.base[i], dr), c.inv[i])",
        "__fdiv_rn(__fadd_rn(c.base[i], dr), c.tot[i])"), ("sched",)),
    # a grant does not take its demand from the chosen node
    "sched_no_consumption": ((
        SCHED, "__fsub_rn(c.av[i], d[c.kinds[k]])", "c.av[i]"), ("sched",)),
    # the frontier gate ignores dependencies
    "sched_no_frontier_gate": ((
        SCHED,
        "const bool blocked = chosen == c.local_idx && !(hf & kDepReady);",
        "const bool blocked = false;"), ("sched",)),
    # the key drops the locality term
    "sched_key_without_locality": ((
        SCHED, "const int anti = (1 << 20) - min(l >> 10, kLocMax);",
        "const int anti = 1 << 20;"), ("sched",)),
    # the exit test takes the suffix minimum from the next chunk on, so
    # the demands of the position's own chunk no longer hold the walk
    "sched_exit_suffix_from_next_chunk": ((
        SCHED, "const int ch = p >> a.chunk_log2;",
        "const int ch = (p >> a.chunk_log2) + 1;"), ("sched",)),
}
WAVE = 6   # copies at once: each holds a few GB of reference tensors

CHILD = """
import json, sys, torch, chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
runs = {}
for check in sys.argv[1:]:
    phase, case = json.loads(check)
    runs.setdefault(phase, []).append(getattr(cs, case) if case else None)
# phase -> (its cases, its run, its tolerance, the looser one)
loose = {"kernel": {"o": (3e-2, 3e-2), "lse": (1e-2, 1e-2)},
         "kernel_bwd": (1e-1, 1e-1)}
for phase, cases in runs.items():
    if phase == "scheduler":   # exact decisions: no looser check
        print("RUN tol", flush=True)
        try:
            cs.phase_scheduler()
            result = {"tol": "passed"}
        except AssertionError:
            result = {"tol": "rejected"}
        print("RESULT " + json.dumps({phase: result}), flush=True)
        continue
    if phase == "kernel":
        cs.KERNEL_CASES, run, tol = cases, cs.phase_kernel, "TOL"
    else:
        cs.BWD_CASES, run, tol = cases, cs.phase_kernel_bwd, "BWD_TOL"
    result = {}
    for label in ("tol", "loose"):
        if label == "loose":
            setattr(cs, tol, dict.fromkeys(getattr(cs, tol), loose[phase]))
        print("RUN " + label, flush=True)
        try:
            run()
            result[label] = "passed"
        except AssertionError:
            result[label] = "rejected"
    print("RESULT " + json.dumps({phase: result}), flush=True)
"""


def plant(workdir: Path, fault: str) -> Path:
    copy = workdir / fault
    shutil.rmtree(copy, ignore_errors=True)
    copy.mkdir(parents=True)
    shutil.copytree("ray_tpu_torch", copy / "ray_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy("chip_smoke.py", copy)
    edit = FAULTS[fault][0]
    if edit is not None:
        source, old, new = edit
        text = (copy / source).read_text()
        assert text.count(old) == 1, (fault, old)
        (copy / source).write_text(text.replace(old, new))
    return copy


def report(fault: str, proc) -> bool:
    """One JSON line for a finished copy; whether it came out as it
    should (the control passes, a fault is rejected)."""
    out, _ = proc.communicate(timeout=900)
    results, shares, label = {}, {}, None
    for ln in out.splitlines():
        if ln.startswith("RUN "):
            label = ln.removeprefix("RUN ")
        elif ln.startswith("RESULT "):
            results.update(json.loads(ln.removeprefix("RESULT ")))
        elif ln.startswith('{"phase": "kernel') and label == "tol":
            row = json.loads(ln)
            shares.setdefault(row["phase"], []).append(
                {"dtype": row["dtype"],
                 **row.get("tol_share", row.get("tol_share_by", {}))})
    want = "passed" if fault == "control" else "rejected"
    phases = {CHECKS[c][0] for c in FAULTS[fault][1]}
    ok = (proc.returncode == 0 and set(results) == phases
          and all(r.get("tol") == want for r in results.values()))
    if not ok:
        print(out[-4000:], file=sys.stderr)
    print(json.dumps({"fault": fault, "results": results,
                      "tol_share": shares}), flush=True)
    return ok


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    workdir = Path(sys.argv[1]).resolve()
    faults = list(FAULTS)
    ok = True
    for i in range(0, len(faults), WAVE):
        procs = {fault: subprocess.Popen(
            [sys.executable, "-c", CHILD,
             *(json.dumps(CHECKS[c]) for c in FAULTS[fault][1])],
            cwd=plant(workdir, fault),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for fault in faults[i:i + WAVE]}
        for fault, proc in procs.items():
            ok = report(fault, proc) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
