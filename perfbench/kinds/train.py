"""Training cells: the step that the port's ``make_train_step`` returns,
with its ``AdamW``, driven back to back as a training loop drives it,
and the check of what it computed.

Set-up builds one step object with its parameters and optimizer state,
and drives it through the mix's ``checked_steps`` first steps on the
first batches of the pool (the window's own call and feed); it keeps
each step's loss, each leaf's first gradient as the optimizer got it
(from AdamW's first moment after one step) and the norm of each leaf's
change after the last checked step. The same object then runs the
window: steps dispatched without a sync, the window closed by
``torch.cuda.synchronize()``. The reference follows the checked steps.
"""

from __future__ import annotations

import math
import statistics
import time

from torch.profiler import record_function

from perfbench import devtrace, loadgen, weights
from perfbench.model import (draw_weights, free_device_memory, port_config,
                             reference_of, shape_of, sync)

# A leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: its change is not compared.
STILL_LEAF = 1e-3


def _step_object(config: dict, mix: dict):
    from ray_tpu_torch.models.transformer import (AdamW, ParallelConfig,
                                                  make_train_step)

    pcfg = ParallelConfig(remat=bool(mix["remat"]),
                          remat_policy=mix["remat_policy"])
    return make_train_step(port_config(config), pcfg,
                           optimizer=AdamW(lr=float(mix["optimizer"]["lr"])))


def _first_moment_norm(opt_state, leaf) -> float:
    """The norm of AdamW's first moment of a leaf (0 where the step left
    the optimizer without one)."""
    m = opt_state.state.get(leaf, {}).get("exp_avg")
    return 0.0 if m is None else float(m.float().norm())


def run(config: dict, mix: dict, seed: int, seconds: float, device,
        trace=None) -> tuple:
    marks = [("entered", time.perf_counter_ns())]
    shape = shape_of(config)
    params = draw_weights(config, seed, device)
    sync(device)
    marks.append(("weights", time.perf_counter_ns()))
    named = weights.leaves(params)
    start = [t.detach().clone() for _, t in named]
    step, optimizer = _step_object(config, mix)
    opt_state = optimizer.init(params)
    beta1 = opt_state.param_groups[0]["betas"][0]
    batches = loadgen.train_batches(mix, seed, shape.vocab, device)
    n_checked = int(mix["checked_steps"])
    losses, grad_norms = [], None
    for i in range(n_checked):
        _, _, loss = step(params, opt_state, batches[i % len(batches)])
        losses.append(loss)
        if i == 0:
            grad_norms = {name: _first_moment_norm(opt_state, t) / (1 - beta1)
                          for name, t in named}
    change = {name: float((t.detach().float() - t0.float()).norm())
              for (name, t), t0 in zip(named, start)}
    marks.append(("checked_steps", time.perf_counter_ns()))
    checked = {"losses": [float(x) for x in losses],
               "grad_norms": grad_norms, "change_norms": change}
    del start, losses
    if trace is not None:
        trace.start()
    sync(device)
    spans = []
    t0 = time.perf_counter_ns()
    n = 0
    while time.perf_counter_ns() - t0 < seconds * 1e9:
        a = time.perf_counter_ns()
        with record_function("train.step"):
            _, _, loss = step(params, opt_state,
                              batches[(n_checked + n) % len(batches)])
        spans.append(("train.step", a, time.perf_counter_ns()))
        n += 1
    a = time.perf_counter_ns()
    with record_function("host.sync"):
        sync(device)
    t1 = time.perf_counter_ns()
    spans.append(("host.sync", a, t1))
    last_loss = float(loss)
    work, stop_s = devtrace.stop(trace)
    rec = {"kind": "train", "shape": shape, "t0": t0, "t1": t1, "steps": n,
           "tokens_per_step": int(mix["batch"]) * int(mix["seq_len"]),
           "batch": int(mix["batch"]), "seq_len": int(mix["seq_len"]),
           "n_params": sum(t.numel() for _, t in named), "spans": spans,
           "last_loss": last_loss,
           "device_work": work, "trace_stop_s": stop_s, "marks": marks}
    state = {"params": params, "opt_state": opt_state, "step": step,
             "batches": batches, "checked": checked}
    return rec, state


def failed(rec: dict) -> int:
    return 0 if math.isfinite(rec["last_loss"]) else 1


def attempted(rec: dict) -> int:
    return rec["steps"]


def norm_gaps(prog: dict, ref: dict, names) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's."""
    median = statistics.median(ref[n] for n in names)
    worst = 0.0
    for n in names:
        scale = max(ref[n], median)
        if scale > 0:
            worst = max(worst, abs(prog[n] - ref[n]) / scale)
        elif prog[n] != ref[n]:
            worst = float("inf")
    return worst


def compare(checked: dict, ref: dict) -> dict:
    names = list(ref["grad_norms"])
    gmed = statistics.median(ref["grad_norms"].values())
    moving = [n for n in names if ref["grad_norms"][n] >= STILL_LEAF * gmed]
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(checked["losses"],
                                                   ref["losses"])),
        "grad_norm_gap": norm_gaps(checked["grad_norms"], ref["grad_norms"],
                                   names),
        "update_norm_gap": norm_gaps(checked["change_norms"],
                                     ref["change_norms"], moving),
    }


def reference(config: dict, mix: dict, seed: int, device, quant=None,
              rows=None) -> dict:
    """The reference's checked steps from the seed's weights and
    batches, drawn again."""
    refmod = reference_of(config)
    refmod.fp32_only()
    params = draw_weights(config, seed, device)
    batches = loadgen.train_batches(mix, seed, shape_of(config).vocab, device)
    return refmod.train_steps(config["port"], params, batches,
                              mix["optimizer"], int(mix["checked_steps"]),
                              quant=quant, rows=rows)


def check(config: dict, mix: dict, seed: int, rec: dict, state: dict,
          device, control: bool = False) -> dict:
    """Frees the program's state, then compares the checked steps with
    the reference's. (Training's controls run apart, in ``control``.)"""
    checked = state["checked"]
    state.clear()
    free_device_memory(device)
    out = compare(checked, reference(config, mix, seed, device))
    out["failed_steps"] = failed(rec)
    return out


def control(config: dict, mix: dict, seed: int, device) -> dict:
    """The readings that set the upper end of each limit: the reference
    put in the program's place in fp8 (``control``), and with half of
    each batch left out (``half_batch``), each against the fp32
    reference."""
    fp8 = reference_of(config).fp8
    ref = reference(config, mix, seed, device)
    out = {"control": compare(reference(config, mix, seed, device, quant=fp8),
                              ref)}
    out["half_batch"] = compare(
        reference(config, mix, seed, device, rows=int(mix["batch"]) // 2),
        ref)
    return out
