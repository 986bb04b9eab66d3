#!/usr/bin/env python3
"""Show that ``chip_smoke.py``'s K2/K3 check rejects a wrong kernel.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 bwd_fault_check.py WORKDIR

For each planted fault it copies ``ray_tpu_torch/`` and
``chip_smoke.py`` into ``WORKDIR/<fault>/``, edits the copy of one
kernel source (the checkout is never touched), and runs
``chip_smoke``'s ``kernel_bwd`` phase in that copy, once under
``chip_smoke.BWD_TOL`` and once under the looser tolerance of
``tests/test_ops.py`` (1e-1). Faults in ``csrc/flash_bwd_sm90.cu`` (the
bf16 route) run at the training shape in bf16, 16 x 1024 x 16 x 64
causal; faults in ``csrc/flash_bwd.cu`` (the scalar route) at the same
shape in fp32. A ``control`` copy with no fault must pass both. Prints
one JSON line per copy and exits 0 only if the control passes and every
fault is rejected under ``chip_smoke.BWD_TOL``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

SM90 = "ray_tpu_torch/csrc/flash_bwd_sm90.cu"
SCALAR = "ray_tpu_torch/csrc/flash_bwd.cu"
# chip_smoke's cases, by the dtype of the route they run
CASES = {"bf16": "TRAIN_CASE", "fp32": "TRAIN_CASE_FP32"}
# fault -> (source, its text, the replacement), the case it runs
FAULTS = {
    "control": (None, ("bf16", "fp32")),
    # K2 skips the q-tile on the causal diagonal: dK, dV lose its terms
    "k2_causal_start_one_tile_late": ((
        SM90, "const int qt0 = in.causal ? kt : 0;",
        "const int qt0 = in.causal ? kt + 1 : 0;"), ("bf16",)),
    # K2 writes zeros for the second k-tile's dK
    "k2_zero_dk_tile": ((
        SM90, "store_acc(dk_acc[x], dkh, sdk.t, k0, x, seq);",
        "if (blockIdx.y == 1)\n      for (int i = 0; i < 32; ++i) "
        "dk_acc[x][i] = 0.f;\n    "
        "store_acc(dk_acc[x], dkh, sdk.t, k0, x, seq);"), ("bf16",)),
    # K3 stops before the k-tile on the causal diagonal
    "k3_causal_end_one_tile_early": ((
        SM90, "const int n_k = in.causal ? qt + 1 :",
        "const int n_k = in.causal ? qt :"), ("bf16",)),
    # p and ds go to the products as one bf16 rounding (hi only), as
    # FlashAttention-2/3 do: the lo half of the split is dropped
    "sm90_drop_lo_half": ((
        SM90, "lo = bf16x2(x0 - hf.x, x1 - hf.y);",
        "lo = bf16x2(0.f, 0.f);"), ("bf16",)),
    # the same three faults in the scalar route, held at fp32
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
}

CHILD = """
import json, sys, torch, chip_smoke as cs
cs.BWD_CASES = [getattr(cs, name) for name in sys.argv[1:]]
torch.backends.cuda.matmul.allow_tf32 = False
result = {}
for label, tol in (("tol", None), ("tol_1e-1", (1e-1, 1e-1))):
    if tol is not None:
        cs.BWD_TOL = dict.fromkeys(cs.BWD_TOL, tol)
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
    edit = FAULTS[fault][0]
    if edit is not None:
        source, old, new = edit
        text = (copy / source).read_text()
        assert text.count(old) == 1, (fault, old)
        (copy / source).write_text(text.replace(old, new))
    return copy


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    workdir = Path(sys.argv[1]).resolve()
    procs = {fault: subprocess.Popen(
        [sys.executable, "-c", CHILD, *(CASES[c] for c in cases)],
        cwd=plant(workdir, fault),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for fault, (_, cases) in FAULTS.items()}
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
