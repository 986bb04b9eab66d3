"""SPMD pipeline parallelism, a GPipe schedule over a mesh axis
(counterpart of ``ray_tpu/parallel/pipeline.py``).

Each ``pp`` rank holds one stage's params (the stacked-stage leading dim
sharded over ``pp``); microbatch activations hop between neighbor ranks
with ``ppermute`` in a Python loop of ``M + n - 1`` steps that every rank
runs alike, with the bubble cost ``(n_stages - 1) / n_microbatches``.
Autograd through the loop yields the reverse (backward) schedule.

Call inside ``shard_map`` over the ``pp`` axis.

Gradient note, as the reference's: the transpose of ``psum`` SUMS
cotangents across ranks, so per-rank grads equal ∂(Σ_ranks loss_r)/∂
(local params). The final psum-broadcast below hands every pp rank an
identical copy of the output; if every rank then computes the same
loss, stage-param grads come out n_pp-fold inflated. Callers divide
their per-rank loss (or the resulting grads) by the pp axis size, as
the model's train step does (``models/transformer.py``
``make_train_step``).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.collectives import (axis_index, axis_size,
                                                ppermute, psum)


def pipeline_spmd(stage_fn, stage_params, x, *, axis: str = "pp",
                  num_microbatches: int | None = None):
    """Run ``stage_fn(stage_params, mb)`` as a pipeline.

    x: [B, ...] full (pp-replicated) batch; returns [B, ...] outputs,
    valid on every rank (last stage's results are psum-broadcast).
    ``stage_fn`` keeps its input's shape and dtype. num_microbatches
    defaults to the pipeline depth.
    """
    n = axis_size(axis)
    rank = axis_index(axis)
    B = x.shape[0]
    M = num_microbatches or n
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    xs = x.reshape((M, B // M) + tuple(x.shape[1:]))
    perm = [(r, (r + 1) % n) for r in range(n)]
    # masks as tensors, so every rank builds the same autograd graph and
    # issues its backward collectives in the same order (filled on the
    # device, with no host-to-device copy)
    first = torch.full((), rank == 0, device=x.device)
    last = torch.full((), rank == n - 1, device=x.device)

    recv = torch.zeros_like(xs[0])
    out_buf = [None] * M
    for t in range(M + n - 1):
        # stage 0 reads microbatch t (clamped; its output is never
        # collected when t >= M)
        feed = xs[min(t, M - 1)]
        out = stage_fn(stage_params, torch.where(first, feed, recv))
        # the last rank finished microbatch t-(n-1) at this step
        if t >= n - 1:
            out_buf[t - (n - 1)] = out
        recv = ppermute(out, axis, perm)
    out_buf = torch.stack(out_buf)
    # broadcast the last rank's results to all pp ranks
    out_buf = psum(torch.where(last, out_buf, torch.zeros_like(out_buf)),
                   axis)
    return out_buf.reshape((B,) + tuple(out_buf.shape[2:]))
