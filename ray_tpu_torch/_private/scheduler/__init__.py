"""Scheduling backends behind one seam.

Counterpart of ``ray_tpu/_private/scheduler/__init__.py``: the request,
node and decision types and the ``SchedulingBackend`` seam are copies.
The raylet delegates every scheduling tick to a backend implementing
``SchedulingBackend``. Role parity: reference ClusterTaskManager +
ClusterResourceScheduler + HybridPolicy behind the ISchedulingPolicy /
ClusterTaskManagerInterface seams (src/ray/raylet/scheduling/
cluster_task_manager_interface.h, scheduling_policy.h). Two backends:

  * host         — dict/heap reference implementation (correctness oracle)
  * cuda_batched — the reference's ``tpu_batched``: pending lease
                   requests and the cluster resource table become
                   tensors resident on the card, and one hand-written
                   CUDA kernel (``csrc/sched_scan.cu``) scans the tasks
                   in arrival order, scoring every node per task

Both see the same inputs and must produce identical placements for
identical state (tests/test_torch_scheduler.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

GRANT = "grant"
SPILL = "spill"
WAIT = "wait"
INFEASIBLE = "infeasible"


@dataclass
class PendingRequest:
    """One queued lease request, in arrival order."""
    req_id: int
    scheduling_class: int
    resources: Dict[str, float]
    strategy: str = "DEFAULT"
    pg_id: bytes = b""
    pg_bundle: int = -1
    # Runtime-env identity for worker-pool affinity (reference:
    # worker_pool.h:135 runtime_env_hash).
    env_hash: str = ""
    # Bytes of task args already local per candidate node (locality term).
    locality: Dict[bytes, int] = field(default_factory=dict)
    # Frontier gate: False while the local dependency manager is still
    # prefetching this task's plasma args (reference: DependencyManager
    # RequestTaskDependencies -> dispatch gating). A request with pending
    # deps may still SPILL to a node that already holds them, but a local
    # GRANT waits for the pull.
    deps_ready: bool = True
    # monotonic arrival time (schedule-latency accounting)
    arrival_ts: float = 0.0
    # Sample task this lease request carries (TaskSpec.lease_summary's
    # head-of-queue task): the anchor for the raylet's task-lifecycle
    # events (PENDING_LEASE / LEASE_GRANTED / SPILLBACK).
    task_id: bytes = b""
    # monotonic time of the FIRST scheduler tick that evaluated this
    # request: arrival->first_decision is pure decision latency;
    # first_decision->grant is resource wait (the two must be reported
    # separately — on a saturated node the latter measures queue depth,
    # not the kernel).
    first_decision_ts: float = 0.0
    # Whether the sample task is retriable (max_retries != 0): the
    # granted worker inherits this as its memory-watchdog victim
    # eligibility (memory_monitor.py kills only retriable work).
    # Defaults False so a summary without the field never enables kills.
    retriable: bool = False


@dataclass
class NodeView:
    node_id: bytes
    address: str
    total: Dict[str, float]
    available: Dict[str, float]
    is_local: bool = False


@dataclass
class Decision:
    req_id: int
    action: str                     # GRANT | SPILL | WAIT | INFEASIBLE
    spill_address: str = ""


class SchedulingBackend:
    def schedule(self, pending: List[PendingRequest],
                 nodes: List[NodeView],
                 spread_threshold: float) -> List[Decision]:
        raise NotImplementedError


BACKENDS = ("host", "cuda_batched")


def make_backend(name: str, device=None) -> SchedulingBackend:
    """``"host"`` -> ``HostBackend``; ``"cuda_batched"`` ->
    ``CudaBatchedBackend(device)`` (``device=None``: CUDA, raising
    without it). Any other name raises ``ValueError``: the reference
    falls back to the host backend, so a misspelled name would run on
    the host unnoticed."""
    if name == "cuda_batched":
        from ray_tpu_torch._private.scheduler.cuda_batched import (
            CudaBatchedBackend)
        return CudaBatchedBackend(device)
    if name == "host":
        from ray_tpu_torch._private.scheduler.host_backend import HostBackend
        return HostBackend()
    raise ValueError(f"unknown scheduler backend {name!r}; expected one of "
                     f"{BACKENDS}")
