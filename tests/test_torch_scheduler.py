"""Parity of the port's scheduling backends with the JAX package's.

The same requests and nodes go through the JAX package's
``TpuBatchedBackend`` (its jitted scan, on the CPU) and the port's
``CudaBatchedBackend(device="cpu")``, whose CPU path is
``scan_reference``, the plain version of the port's CUDA kernel
(``csrc/sched_scan.cu``, which runs only on the card: ``chip_smoke.py``
holds it to ``scan_reference`` and ``HostBackend`` there). Decisions
must be identical: the cases of tests/test_scheduler_diff.py, its
12-tick incremental sequence and 10k stress case, and the two cases
where the reference's kernel departs from its host oracle, where the
port follows the kernel. The port's ``HostBackend`` is a copy and must
equal the JAX package's.

``walk_emulation`` is the CUDA kernel's control flow in plain numpy
(its pre-pass defaults, one position at a time, the suffix-minimum exit
over chunks of positions) and its arithmetic (inert kinds left out, one
ceil per node); it must equal ``scan_reference`` exactly at every chunk
size, on every case here and the kinds of case ``chip_smoke.py`` holds
the kernel to on the card.
"""

import ast
import ctypes
import importlib
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from ray_tpu._private.scheduler import NodeView as JNodeView
from ray_tpu._private.scheduler import PendingRequest as JPendingRequest
from ray_tpu._private.scheduler.host_backend import HostBackend as JHost
from ray_tpu._private.scheduler.tpu_batched import (TpuBatchedBackend,
                                                    _compiled_kernel)
from ray_tpu_torch._private.scheduler import (NodeView, PendingRequest,
                                              make_backend)
from ray_tpu_torch._private.scheduler.host_backend import HostBackend
from ray_tpu_torch._private.scheduler.scoring import (HI_LOC_SHIFT,
                                                      LO_LOC_MASK, LOC_MAX,
                                                      UTIL_MAX, UTIL_SCALE)

cb = importlib.import_module("ray_tpu_torch._private.scheduler.cuda_batched")

CASES = {name: (pending, nodes, spread)
         for name, pending, nodes, spread in chip_smoke.sched_cases()}
QUIRKS = {name: (pending, nodes, spread)
          for name, pending, nodes, spread in chip_smoke.sched_quirk_cases()}


def _decisions(ds):
    return [(d.req_id, d.action, d.spill_address) for d in ds]


def _to_jax(pending, nodes):
    """The same requests and nodes as the JAX package's dataclasses."""
    jp = [JPendingRequest(req_id=r.req_id, scheduling_class=0,
                          resources=dict(r.resources),
                          locality=dict(r.locality),
                          deps_ready=r.deps_ready) for r in pending]
    jn = [JNodeView(node_id=n.node_id, address=n.address,
                    total=dict(n.total), available=dict(n.available),
                    is_local=n.is_local) for n in nodes]
    return jp, jn


def _jax_batched():
    backend = TpuBatchedBackend()
    assert backend.wait_ready(), "JAX kernel backend failed to init"
    return backend


@pytest.mark.parametrize("name", sorted(CASES) + sorted(QUIRKS))
def test_host_backend_matches_jax_host(name):
    pending, nodes, spread = {**CASES, **QUIRKS}[name]
    want = JHost().schedule(*_to_jax(pending, nodes), spread)
    assert _decisions(HostBackend().schedule(pending, nodes, spread)) == \
        _decisions(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_batched_matches_jax_batched(name):
    pending, nodes, spread = CASES[name]
    want = _jax_batched().schedule(*_to_jax(pending, nodes), spread)
    got = cb.CudaBatchedBackend(device="cpu").schedule(pending, nodes,
                                                       spread)
    assert _decisions(got) == _decisions(want)
    # and, on these integer-unit cases, the host oracle's
    assert _decisions(got) == _decisions(
        HostBackend().schedule(pending, nodes, spread))


@pytest.mark.parametrize("name", sorted(QUIRKS))
def test_quirks_follow_the_jax_kernel_not_the_host(name):
    pending, nodes, spread = QUIRKS[name]
    jp, jn = _to_jax(pending, nodes)
    want = _decisions(_jax_batched().schedule(jp, jn, spread))
    host = _decisions(JHost().schedule(jp, jn, spread))
    got = _decisions(cb.CudaBatchedBackend(device="cpu").schedule(
        pending, nodes, spread))
    assert got == want
    assert got != host
    if name == "no_local_node":
        assert want == [(1, "spill", "tcp://a"), (2, "wait", "")]
        assert host == [(1, "spill", "tcp://b"), (2, "spill", "tcp://a")]
    else:
        diff = {h[0]: (h[1], g[1]) for h, g in zip(host, got) if h != g}
        assert diff == {15: ("spill", "grant"), 29: ("grant", "spill")}


def test_incremental_sequence_matches_jax_batched():
    """The 12 ticks of test_resident_state_incremental_across_ticks: the
    JAX backend sees its own copy of each tick's requests and nodes."""
    jax_backend, port = _jax_batched(), cb.CudaBatchedBackend(device="cpu")
    launches = cb.sched_scan.launches

    class Jax:
        def schedule(self, pending, nodes, spread):
            return jax_backend.schedule(*_to_jax(pending, nodes), spread)

    def check(tick, outs):
        got, want, host = map(_decisions, outs)
        assert got == want == host, tick

    chip_smoke.sched_sequence([port, Jax(), HostBackend()], check)
    assert port.num_row_uploads == jax_backend.num_row_uploads > 30
    assert port.num_rebuilds == jax_backend.num_rebuilds
    assert cb.sched_scan.launches == launches   # the CPU launches nothing


def test_10k_pending_stress_matches_jax_batched():
    """test_resident_kernel_10k_pending_stress: one tick of 10,000
    pending on 8 nodes, then three drain waves that upload nothing."""
    def state():
        nodes = [NodeView(node_id=bytes([i]) * 28, address=f"tcp://n{i}",
                          total={"CPU": 16.0}, available={"CPU": 16.0},
                          is_local=(i == 0)) for i in range(8)]
        pending = [PendingRequest(req_id=t + 1, scheduling_class=0,
                                  resources={"CPU": 1.0})
                   for t in range(10_000)]
        return pending, nodes

    pending, nodes = state()
    jp, jn = _to_jax(pending, nodes)
    port, jax_backend = cb.CudaBatchedBackend(device="cpu"), _jax_batched()
    for wave in range(4):
        got = _decisions(port.schedule(pending, nodes, 0.5))
        want = _decisions(jax_backend.schedule(jp, jn, 0.5))
        assert got == want, wave
        assert sum(1 for d in got if d[1] in ("grant", "spill")) == 128
        placed = {d[0] for d in got if d[1] in ("grant", "spill")}
        pending = [r for r in pending if r.req_id not in placed]
        jp = [r for r in jp if r.req_id not in placed]
    assert port.num_row_uploads == jax_backend.num_row_uploads == 10_000
    assert port.num_rebuilds == jax_backend.num_rebuilds == 1


@pytest.mark.parametrize("seed,local,spread", [
    (0, True, 0.5), (1, True, 0.0), (2, False, 0.5), (3, True, 1.0),
    (4, False, 2.0), (5, True, 0.3)])
def test_scan_reference_matches_jax_compiled_kernel(seed, local, spread):
    # 500 tasks over 30 nodes: at seeds 0, 2 and 3 utilisation as
    # used / totals in place of used * (1 / totals) moves 7-52 actions,
    # so these hold fp32 rounding points, not only the algorithm
    arrays = chip_smoke.sched_scan_arrays(seed, tb=512, nb=32, n_tasks=500,
                                          n_nodes=30, local=local)
    tb, rb = arrays[0].shape
    nb = arrays[4].shape[0]
    spread_fp = int(spread * (1 << 20))
    want = np.asarray(_compiled_kernel(tb, nb, rb)(
        *arrays, np.int32(spread_fp)))
    got = cb.scan_reference(*(torch.from_numpy(a) for a in arrays),
                            spread_fp)
    assert got.dtype == torch.int32 and got.shape == (tb,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version on CPU tensors, launching
    # nothing
    launches = cb.sched_scan.launches
    again = cb.sched_scan(*(torch.from_numpy(a) for a in arrays), spread_fp)
    assert torch.equal(again, got) and cb.sched_scan.launches == launches


def test_sched_scan_launch_path(monkeypatch):
    """The launch path on CPU tensors with the C call replaced: the
    arguments in the C entry point's order and types, the scratch and
    output it allocates, the launch counter, the walk counters it
    exposes, and its refusals."""
    calls = []
    monkeypatch.setattr(cb, "_launch", lambda device, *args: calls.append(
        (device, args)))
    monkeypatch.setattr(cb.sched_scan, "launches", 0)
    monkeypatch.setattr(cb.sched_scan, "last_walk", None)
    ins = tuple(torch.from_numpy(a) for a in chip_smoke.sched_scan_arrays(0))
    actions = cb._launch_sched_scan(ins, 12345)
    [(device, args)] = calls
    assert device == ins[4].device
    assert len(args) + 1 == len(cb._SCAN_ARGS)   # + the stream
    assert cb._SCAN_ARGS[:16] == [ctypes.c_void_p] * 16
    assert cb._SCAN_ARGS[16:21] == [ctypes.c_int] * 5
    assert args[:9] == tuple(x.data_ptr() for x in ins)
    # scratch: demand rows [16, 8], headers [16, 4], chunk minima [1 + 1,
    # 8], chunk flags [1, 8], the global route's state [6, 8, 8] and the
    # walk counters, each 16-byte aligned, one after another
    sizes = [16 * 8, 16 * 4, 2 * 8, 8, 6 * 8 * 8]
    assert [b - a for a, b in zip(args[9:14], args[10:15])] == [
        4 * n for n in sizes]
    assert all(ptr % 16 == 0 for ptr in args[9:15])
    assert cb.sched_scan.last_walk.data_ptr() == args[14]
    assert cb.sched_scan.last_walk.dtype == torch.int32
    assert cb.sched_scan.last_walk.shape == (len(cb.WALK_COUNTERS),)
    assert args[15] == actions.data_ptr()
    # spread_fp, positions, nb, rb, the chunk
    assert args[16:] == (12345, 16, 8, 8, cb.SCAN_CHUNK)
    assert actions.dtype == torch.int32 and actions.shape == (16,)
    assert cb.sched_scan.launches == 1
    cb.sched_scan.last_walk.copy_(torch.arange(6, dtype=torch.int32))
    assert cb.walk_counters(cb.sched_scan.last_walk) == {
        "scored": 0, "exit": 1, "placements": 2, "shared": 3,
        "init_ns": 4, "walk_ns": 5}
    bad = list(ins)
    bad[0] = ins[0].double()
    with pytest.raises(TypeError, match="demands"):
        cb._launch_sched_scan(tuple(bad), 0)
    bad = list(ins)
    bad[1] = ins[1].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        cb._launch_sched_scan(tuple(bad), 0)
    bad = list(ins)
    bad[5] = ins[5][:4]
    with pytest.raises(ValueError, match="avail"):
        cb._launch_sched_scan(tuple(bad), 0)
    big = tuple(torch.from_numpy(a) for a in chip_smoke.sched_scan_arrays(
        0, tb=8, nb=cb.MAX_NODE_BUCKET * 2, rb=2, n_tasks=1, n_nodes=1))
    with pytest.raises(ValueError, match="32768"):
        cb._launch_sched_scan(big, 0)
    assert len(calls) == 1 and cb.sched_scan.launches == 1


def test_make_backend_names():
    assert isinstance(make_backend("host"), HostBackend)
    backend = make_backend("cuda_batched", device="cpu")
    assert isinstance(backend, cb.CudaBatchedBackend)
    assert backend.device == torch.device("cpu") and backend.wait_ready()
    # the reference falls back to the host backend for any other name;
    # the port refuses it, its own former name included
    for name in ("tpu_batched", "cuda-batched", ""):
        with pytest.raises(ValueError, match="unknown scheduler backend"):
            make_backend(name)


def test_cuda_batched_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cb.CudaBatchedBackend()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_backend("cuda_batched")


def test_cuda_tensors_take_the_launch_path_only(monkeypatch):
    """The wrapper routes by the tensors' device: CUDA goes to the
    kernel's launch path, never to scan_reference; and the backend's
    module has no host decision path to fall back on (the reference
    serves ticks from its host backend while its kernel comes up)."""
    def refuse(*args):
        raise AssertionError("a CUDA tensor reached scan_reference")

    launched = []
    monkeypatch.setattr(cb, "scan_reference", refuse)
    monkeypatch.setattr(cb, "_launch_sched_scan", lambda ins, spread_fp: (
        launched.append((ins, spread_fp)) or "actions"))
    args = [object()] * 4 + [types.SimpleNamespace(
        device=torch.device("cuda"))] + [object()] * 4
    assert cb.sched_scan(*args, 7) == "actions"
    assert launched == [(tuple(args), 7)]
    imported = [n.module for n in ast.walk(ast.parse(Path(
        cb.__file__).read_text())) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in imported if "host_backend" in m], imported


# ------------------------------------------------ the kernel's walk, emulated

def walk_emulation(demands, locality, dep_ready, perm, totals, avail0,
                   is_local, valid_task, valid_node, spread_fp,
                   chunk=cb.SCAN_CHUNK):
    """``csrc/sched_scan.cu``'s control flow and arithmetic on numpy
    arrays, fp32 with the kernel's rounding points: ``(actions,
    counters)`` with the kernel's ``WALK_COUNTERS`` up to ``shared``.

    Pre-pass: every valid position INFEASIBLE where no valid node's
    totals hold its demand, else WAIT; the minimum demand per kind of
    each chunk of ``chunk`` positions, combined in reverse. State: the
    active kinds only (a kind whose valid demands are all 0 and whose
    valid nodes hold no totals of it and are feasible and ready for 0 is
    left out), with availability + 1e-9 and totals - availability kept
    beside it. Walk: one position at a time, the utilisation taken once
    per node on the largest used * (1 / totals), a placement committed
    before the next position; before each position, the walk stops if
    no valid node is ready for the suffix minimum from its chunk."""
    f32, eps = np.float32, np.float32(1e-9)
    positions = perm.shape[0]
    dem = demands[perm]
    valid = valid_task.astype(bool)
    vnode = valid_node.astype(bool)
    feasible_any = (vnode[None] & np.all(
        totals[None] + eps >= dem[:, None, :], axis=2)).any(1)
    actions = np.where(valid & ~feasible_any, cb.ACTION_INFEASIBLE,
                       cb.ACTION_WAIT).astype(np.int32)
    n_chunks = -(-positions // chunk)
    cmin = np.full((n_chunks + 1, totals.shape[1]), np.inf, f32)
    for c in range(n_chunks):
        rows = dem[c * chunk:(c + 1) * chunk][valid[c * chunk:(c + 1) * chunk]]
        cmin[c] = np.fmin.reduce(rows, axis=0, initial=np.inf)
    for c in range(n_chunks - 1, -1, -1):
        cmin[c] = np.fmin(cmin[c], cmin[c + 1])
    active = (dem[valid] != 0).any(0) | (
        (totals > 0) | ~(totals + eps >= 0) | ~(avail0 + eps >= 0))[
            vnode].any(0)
    kinds = np.flatnonzero(active)
    tot, avail = totals[:, kinds], avail0[:, kinds].copy()
    totp, avp, base = tot + eps, avail + eps, tot - avail
    inv = np.where(tot > 0, f32(1) / np.maximum(tot, eps), f32(0))
    cmin, dem_k = cmin[:, kinds], dem[:, kinds]
    local_idx = int(np.argmax(is_local))
    node_idx = np.arange(totals.shape[0], dtype=np.int64)
    remote = (~is_local.astype(bool)).astype(np.int64)
    p = scored = placements = 0
    while p < positions:
        if not (vnode & np.all(avp >= cmin[p // chunk], axis=1)).any():
            break   # nothing from p on can place
        if valid[p]:
            d = dem_k[p]
            ready = vnode & np.all(totp >= d, axis=1) & np.all(avp >= d,
                                                               axis=1)
            y = np.fmax.reduce((base + d) * inv, axis=1, initial=0)
            util = np.fmin(np.ceil(y * f32(UTIL_SCALE)), UTIL_MAX).astype(
                np.int64)
            anti = (1 << 20) - np.minimum(
                locality[perm[p]].astype(np.int64) >> 10, LOC_MAX)
            key = (((util << 10) | (anti >> HI_LOC_SHIFT)) << 32) | (
                ((anti & LO_LOC_MASK) << 16) | (remote << 15) | node_idx)
            best = int(np.where(ready, key, np.iinfo(np.int64).max).min()
                       & 0x7FFF)
            local_ok = ready[local_idx] and util[local_idx] <= spread_fp
            chosen = local_idx if local_ok else best
            blocked = chosen == local_idx and not dep_ready[perm[p]]
            scored += 1
            if ready.any() and not blocked:
                actions[p] = chosen
                avail[chosen] = avail[chosen] - d
                avp[chosen] = avail[chosen] + eps
                base[chosen] = tot[chosen] - avail[chosen]
                placements += 1
        p += 1
    counters = {"scored": scored, "exit": min(p, positions),
                "placements": placements}
    return actions, counters


def _scan_inputs(monkeypatch, pending, nodes, spread):
    """The scan's inputs and spread_fp for one tick of the backend on
    the CPU, as numpy arrays."""
    calls = []
    real = cb.sched_scan
    monkeypatch.setattr(cb, "sched_scan",
                        lambda *args: calls.append(args) or real(*args))
    cb.CudaBatchedBackend(device="cpu").schedule(pending, nodes, spread)
    [args] = calls
    return [a.numpy() for a in args[:9]], args[9]


def _reference(arrays, spread_fp):
    return cb.scan_reference(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in arrays), spread_fp).numpy()


_ARRAY_CASES = {
    # the fractional arrays of the chip's array cases, smaller
    **{f"fractional_{seed}": (lambda seed=seed: chip_smoke.sched_scan_arrays(
        seed, tb=512, nb=32, n_tasks=500, n_nodes=30, local=seed % 2 == 0),
        spread) for seed, spread in ((0, 0.5), (1, 0.3), (3, 1.0))},
    "zero_rows": (lambda: chip_smoke.sched_signed_arrays(
        4, tb=512, nb=32, n_tasks=480, n_nodes=30, negative=0, zero=0.3),
        0.5),
    # a grant of a negative demand gives availability back
    "negative_rows": (lambda: chip_smoke.sched_signed_arrays(
        7, tb=1024, nb=32, n_tasks=1000, n_nodes=30), 0.5),
    "negative_rows_no_local": (lambda: chip_smoke.sched_signed_arrays(
        6, tb=256, nb=16, n_tasks=250, n_nodes=12, local=False,
        negative=0.3), 0.3),
    "dense": (lambda: chip_smoke.sched_dense(chip_smoke.sched_scan_arrays(
        7, tb=512, nb=32, n_tasks=400, n_nodes=30)), 0.5),
    "late": (lambda: chip_smoke.sched_late_arrays(8, tb=1024, nb=32,
                                                  n_large=900, n_tasks=1000,
                                                  n_nodes=30), 0.5),
}


@pytest.fixture(scope="module")
def walk_cases():
    """name -> (arrays, spread_fp, scan_reference's actions), built once
    for the module."""
    cases = {}
    for name, (make, spread) in _ARRAY_CASES.items():
        arrays, spread_fp = make(), int(spread * (1 << 20))
        cases[name] = (arrays, spread_fp, _reference(arrays, spread_fp))
    return cases


# chunk sizes of the exit test's suffix minimum: exact (1), finer than
# the kernel's and the kernel's own
CHUNKS = [1, 16, cb.SCAN_CHUNK]


def _check_counters(arrays, want, counters):
    """The walk placed what scan_reference placed, stopped after the last
    placement, and scored the valid positions before it stopped."""
    placed = np.flatnonzero(want >= 0)
    assert counters["placements"] == placed.size
    if placed.size:
        assert counters["exit"] > placed[-1], (placed[-1], counters)
    assert counters["scored"] == int(arrays[7][:counters["exit"]].sum())


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", sorted(_ARRAY_CASES))
def test_walk_emulation_matches_scan_reference(walk_cases, name, chunk):
    arrays, spread_fp, want = walk_cases[name]
    got, counters = walk_emulation(*arrays, spread_fp, chunk)
    np.testing.assert_array_equal(got, want)
    _check_counters(arrays, want, counters)
    n_valid = int(arrays[7].sum())
    if name == "dense":   # every task places
        assert counters["placements"] == n_valid == 400
    if name == "late":   # placements resume after 900 positions
        assert int((want[:900] >= 0).sum()) == 0
        assert int((want[900:] >= 0).sum()) > 50
    if name.startswith("negative"):   # negative demands were granted
        granted = want[:n_valid] >= 0
        rows = arrays[3][:n_valid][granted]
        assert (arrays[0][rows, 0] < 0).sum() > 5


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", sorted(CASES) + sorted(QUIRKS))
def test_walk_emulation_matches_on_scheduler_cases(monkeypatch, name,
                                                   chunk):
    arrays, spread_fp = _scan_inputs(monkeypatch, *{**CASES, **QUIRKS}[name])
    want = _reference(arrays, spread_fp)
    got, counters = walk_emulation(*arrays, spread_fp, chunk)
    np.testing.assert_array_equal(got, want)
    _check_counters(arrays, want, counters)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_walk_emulation_matches_on_sched_config_prefix(monkeypatch, chunk):
    """The first 1,500 requests of the `sched` configuration over 64
    nodes: the walk stops after the last placement, short of the end."""
    pending, nodes = chip_smoke.sched_config(1500, 64)
    arrays, spread_fp = _scan_inputs(monkeypatch, pending, nodes,
                                     chip_smoke.SCHED_SPREAD)
    want = _reference(arrays, spread_fp)
    got, counters = walk_emulation(*arrays, spread_fp, chunk)
    np.testing.assert_array_equal(got, want)
    _check_counters(arrays, want, counters)
    assert counters["exit"] < 1500, counters
