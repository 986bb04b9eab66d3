"""One run of one cell: resolve the cell's files by name, run it, read
its metrics, decide ``correct``, build the result line.

Everything a cell needs is found by the names in ``BENCHMARK.json``
and in the files they name: the configuration's ``file`` (whose
``reference`` names its plain reference, ``reference/<name>.py``), the
mix ``traffic/<traffic>.json`` (whose ``kind`` names the module that
runs it, ``kinds/<kind>.py``), the limits ``limits/<workload>.json`` and
one reader ``metrics/<metric>.py`` per metric. Nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ray_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(spec: dict, workload: str) -> dict:
    """The cell's entry, configuration, mix, limits and metric entries
    (end-to-end and per-layer) from ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])

    def for_cell(entries):
        return [m for m in entries
                if "workloads" not in m or workload in m["workloads"]]

    return {"cell": cell, "config": config,
            "mix": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{workload}.json"),
            "end_to_end": for_cell(spec["end_to_end"]),
            "per_layer": for_cell(spec["per_layer"])}


def kind_module(kind: str):
    """The module that runs mixes of ``kind``: ``kinds/<kind>.py``, with
    ``run``, ``check``, ``attempted``, ``failed`` and, where it has
    more to say about a run, ``extra``."""
    return importlib.import_module(f"perfbench.kinds.{kind}")


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, rec: dict) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(compared: dict, limits: dict) -> tuple:
    """Each number compared beside its limit; correct when every number
    is at or under its limit."""
    rows, ok = {}, True
    for name, lim in limits.items():
        value = compared.get(name)
        limit = float(lim["limit"])
        rows[name] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, rows


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def device_info(device, rec: dict, trace: bool) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace:
        from perfbench.windows import timeline

        tl = timeline(rec)
        if tl is not None:
            info["busy_s"] = tl.busy_s()
            info["window_s"] = tl.window_s
    return info


def run(resolved: dict, seed: int, seconds: float, trace: bool, device,
        t_start_ns: int, control: bool = False) -> dict:
    """One run; returns the result (``compared`` last) and, under
    ``"record"``, the run's record for tests."""
    mix, config = resolved["mix"], resolved["config"]
    runner = kind_module(mix["kind"])
    tracer = None
    if trace:
        from perfbench.devtrace import Trace

        tracer = Trace()
    rec, state = runner.run(config, mix, seed, seconds, device, trace=tracer)
    rec["setup_s"] = (rec["t0"] - t_start_ns) / 1e9
    entries = resolved["per_layer"] if trace else resolved["end_to_end"]
    metrics = read_metrics(entries, rec)
    dev = device_info(device, rec, trace)
    t_check = time.perf_counter()
    compared = runner.check(config, mix, seed, rec, state, device,
                            control=control)
    check_s = time.perf_counter() - t_check
    correct, rows = judge(compared, resolved["limits"])
    result = {"correct": correct, "attempted": runner.attempted(rec),
              "failed": runner.failed(rec), "metrics": metrics,
              "device": dev}
    # what a reader of the run wants beside the result: the check's
    # sample, where the time went, how well the trace's clock was mapped
    extra = {k: v for k, v in compared.items() if k not in rows}
    if hasattr(runner, "extra"):
        extra.update(runner.extra(rec))
    extra.update(window_s=(rec["t1"] - rec["t0"]) / 1e9, check_s=check_s,
                 trace_stop_s=rec.get("trace_stop_s"),
                 setup_marks_s={k: (t - t_start_ns) / 1e9
                                for k, t in rec.get("marks", [])})
    if trace:
        from perfbench.windows import timeline

        tl = timeline(rec)
        if tl is not None:
            result["breakdown"] = {"device_ops": tl.top_ops(10),
                                   "idle_gaps": tl.idle_by_host(10)}
            extra.update(device_work_in_spans=tl.share_in_spans(),
                         device_s_by_class=tl.by_class())
    result["compared"] = rows
    return {"result": result, "record": rec, "extra": extra}


def main(args, t_start_ns: int) -> int:
    """The command: resolve, check the card, run, check the imports,
    print. Returns the exit code."""
    spec = load_json(ROOT / "BENCHMARK.json")
    resolved = resolve(spec, args.workload)
    import ray_tpu_torch

    where = Path(ray_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        print(f"perfbench: ray_tpu_torch was imported from {where}, not "
              f"from this checkout", file=sys.stderr)
        return 2
    chips = int(resolved["cell"]["chips"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); found "
              f"{cards}", file=sys.stderr)
        return 2
    out = run(resolved, args.seed, args.seconds, bool(args.trace), "cuda",
              t_start_ns)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    result = out["result"]
    info = {"power_limit_w": power_limit(), "extra": out["extra"]}
    print(f"perfbench: {args.workload} seed {args.seed}: "
          f"{json.dumps(info)}", file=sys.stderr)
    for name, row in result["compared"].items():
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def power_limit():
    """The card's power limit in W, from nvidia-smi, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None
