"""Host (dict/heap) scheduling backend — the correctness oracle.

A copy of ``ray_tpu/_private/scheduler/host_backend.py``.

Implements the reference's hybrid policy semantics (reference:
src/ray/raylet/scheduling/scheduling_policy.h HybridPolicy) in plain
Python, using the shared fixed-point score (scheduler/scoring.py) so the
cuda_batched backend can be differentially tested against it: FIFO order per
arrival; prefer the local node while its post-placement critical-resource
utilization stays under the spread threshold; otherwise the globally
lowest-key node (key = utilization, then locality, then local-first, then
stable node index). INFEASIBLE if no node's totals fit; WAIT if totals fit
but nothing is currently available.
"""

from __future__ import annotations

from typing import Dict, List

from ray_tpu_torch._private.scheduler import (
    GRANT, INFEASIBLE, SPILL, WAIT, Decision, NodeView, PendingRequest,
    SchedulingBackend,
)
from ray_tpu_torch._private.scheduler.scoring import (
    anti_locality, pack_key, spread_threshold_fp, util_fixed_point,
)


def _feasible(total: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(total.get(k, 0.0) + 1e-9 >= v for k, v in demand.items() if v > 0)


def _available(avail: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in demand.items() if v > 0)


def _util_fp_after(node: NodeView, avail: Dict[str, float],
                   demand: Dict[str, float]) -> int:
    fp = 0
    for k, cap in node.total.items():
        if cap <= 0:
            continue
        used = cap - avail.get(k, 0.0) + demand.get(k, 0.0)
        fp = max(fp, util_fixed_point(used, cap))
    return fp


class HostBackend(SchedulingBackend):
    def schedule(self, pending: List[PendingRequest],
                 nodes: List[NodeView],
                 spread_threshold: float) -> List[Decision]:
        avail = {n.node_id: dict(n.available) for n in nodes}
        local = next((n for n in nodes if n.is_local), None)
        spread_fp = spread_threshold_fp(spread_threshold)
        decisions: List[Decision] = []
        for req in pending:
            demand = req.resources
            feasible_idx = [i for i, n in enumerate(nodes)
                            if _feasible(n.total, demand)]
            if not feasible_idx:
                decisions.append(Decision(req.req_id, INFEASIBLE))
                continue
            ready_idx = [i for i in feasible_idx
                         if _available(avail[nodes[i].node_id], demand)]
            if not ready_idx:
                decisions.append(Decision(req.req_id, WAIT))
                continue
            best_i = None
            # Hybrid rule: local node wins outright under the threshold.
            if local is not None:
                li = nodes.index(local)
                if li in ready_idx and _util_fp_after(
                        local, avail[local.node_id], demand) <= spread_fp:
                    best_i = li
            if best_i is None:
                best_key = None
                for i in ready_idx:
                    n = nodes[i]
                    key = pack_key(
                        _util_fp_after(n, avail[n.node_id], demand),
                        anti_locality(req.locality.get(n.node_id, 0)),
                        n.is_local, i)
                    if best_key is None or key < best_key:
                        best_key = key
                        best_i = i
            best = nodes[best_i]
            if local is not None and best.node_id == local.node_id \
                    and not req.deps_ready:
                # Frontier gate: the chosen node is THIS node but its args
                # are still being prefetched — hold the grant (no resource
                # consumption) until the dependency manager reports ready.
                decisions.append(Decision(req.req_id, WAIT))
                continue
            a = avail[best.node_id]
            for k, v in demand.items():
                a[k] = a.get(k, 0.0) - v
            if local is not None and best.node_id == local.node_id:
                decisions.append(Decision(req.req_id, GRANT))
            else:
                decisions.append(Decision(req.req_id, SPILL,
                                          spill_address=best.address))
        return decisions
