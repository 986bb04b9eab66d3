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
"""

import ast
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
    output it allocates, the launch counter, and its refusals."""
    calls = []
    monkeypatch.setattr(cb, "_launch", lambda device, *args: calls.append(
        (device, args)))
    monkeypatch.setattr(cb.sched_scan, "launches", 0)
    ins = tuple(torch.from_numpy(a) for a in chip_smoke.sched_scan_arrays(0))
    actions = cb._launch_sched_scan(ins, 12345)
    [(device, args)] = calls
    assert device == ins[4].device
    assert len(args) + 1 == len(cb._SCAN_ARGS)   # + the stream
    assert args[:9] == tuple(x.data_ptr() for x in ins)
    assert args[11] == actions.data_ptr()
    assert args[12:] == (12345, 16, 8, 8)   # spread_fp, positions, nb, rb
    assert actions.dtype == torch.int32 and actions.shape == (16,)
    assert cb.sched_scan.launches == 1
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
