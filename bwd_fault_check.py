#!/usr/bin/env python3
"""Show that ``chip_smoke.py``'s K2/K3 check rejects a wrong kernel.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 bwd_fault_check.py WORKDIR

For each planted fault it copies ``ray_tpu_torch/`` and
``chip_smoke.py`` into ``WORKDIR/<fault>/``, edits the copy of
``csrc/flash_bwd.cu`` (the checkout is never touched), and runs
``chip_smoke``'s ``kernel_bwd`` phase at the training shape (16 x 1024 x
16 x 64 bf16 causal) in that copy, once under ``chip_smoke.BWD_TOL`` and
once under the looser tolerance of ``tests/test_ops.py`` (1e-1). A
``control`` copy with no fault must pass. Prints one JSON line per copy
and exits 0 only if the control passes and every fault is rejected under
``chip_smoke.BWD_TOL``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

SOURCE = Path("ray_tpu_torch/csrc/flash_bwd.cu")
# fault -> (text of flash_bwd.cu, its replacement)
FAULTS = {
    "control": None,
    # K2 skips the q-tile on the causal diagonal: dK, dV lose its terms
    "k2_causal_start_one_tile_late": (
        "for (int qt = in.causal ? k0 / kBlock : 0;",
        "for (int qt = in.causal ? k0 / kBlock + 1 : 0;"),
    # K2 writes zeros for the second k-tile's dK
    "k2_zero_dk_tile": (
        "dkrow[tx + 16 * c] = from_float<T>(dk_acc[i][c]);",
        "dkrow[tx + 16 * c] = from_float<T>(blockIdx.x == 1 ? 0.f "
        ": dk_acc[i][c]);"),
    # K3 stops before the k-tile on the causal diagonal
    "k3_causal_end_one_tile_early": (
        "const int k_end = in.causal ? min(seq, q0 + kBlock) : seq;",
        "const int k_end = in.causal ? min(seq, q0) : seq;"),
}

CHILD = """
import json, torch, chip_smoke as cs
cs.BWD_CASES = [cs.TRAIN_CASE]
torch.backends.cuda.matmul.allow_tf32 = False
result = {}
for label, tol in (("tol", None), ("tol_1e-1", (1e-1, 1e-1))):
    if tol is not None:
        cs.BWD_TOL[torch.bfloat16] = tol
    try:
        cs.phase_kernel_bwd()
        result[label] = "passed"
    except AssertionError:
        result[label] = "rejected"
print("RESULT " + json.dumps(result), flush=True)
"""


def plant(workdir: Path, fault: str) -> Path:
    copy = workdir / fault
    shutil.rmtree(copy, ignore_errors=True)
    copy.mkdir(parents=True)
    shutil.copytree("ray_tpu_torch", copy / "ray_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy("chip_smoke.py", copy)
    if FAULTS[fault] is not None:
        old, new = FAULTS[fault]
        text = (copy / SOURCE).read_text()
        assert text.count(old) == 1, (fault, old)
        (copy / SOURCE).write_text(text.replace(old, new))
    return copy


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    workdir = Path(sys.argv[1]).resolve()
    procs = {fault: subprocess.Popen(
        [sys.executable, "-c", CHILD], cwd=plant(workdir, fault),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for fault in FAULTS}
    ok = True
    for fault, proc in procs.items():
        out, _ = proc.communicate(timeout=900)
        rows = [json.loads(ln) for ln in out.splitlines()
                if ln.startswith('{"phase": "kernel_bwd"')]
        result = [json.loads(ln.removeprefix("RESULT "))
                  for ln in out.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not result:
            print(out[-4000:], file=sys.stderr)
            ok = False
            result = [{}]
        want = "passed" if fault == "control" else "rejected"
        ok = ok and result[0].get("tol") == want
        print(json.dumps({
            "fault": fault, **result[0],
            "max_abs_err_by": [r["max_abs_err_by"] for r in rows],
            "tol_share_by": [r["tol_share_by"] for r in rows]}),
            flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
