"""Named-axis collectives (counterpart of
``ray_tpu/parallel/collectives.py``).

Each collective takes a mesh **axis name**, as the reference's do, and
resolves it against the mesh of the enclosing ``shard_map`` (a context
variable that ``bind_mesh`` sets) to that axis's process group. Code
between the collectives is per-rank SPMD code, the counterpart of a
``shard_map`` body.

Every differentiable collective is a ``torch.autograd.Function`` whose
backward is JAX's transpose of the same primitive under ``shard_map``
with ``check_vma=False``, so the gradients are the reference's line for
line:

* ``psum`` ↔ ``psum`` (cotangents are summed), ``pmean`` ↔ ``pmean``;
* ``all_gather`` ↔ ``psum_scatter`` on the same dim, and back;
* ``all_to_all`` ↔ ``all_to_all`` with split and concat swapped;
* ``ppermute`` ↔ ``ppermute`` by the inverse permutation;
* ``tp_copy``: identity forward, ``psum`` backward;
* ``tp_allreduce``: ``psum`` forward, identity backward.

A Function keeps the process group it ran on for its backward: the
autograd engine runs a CUDA backward on a thread of its own, where the
context variable is unset.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.sharding import PartitionSpec, local_shard

_MESH = contextvars.ContextVar("ray_tpu_torch_mesh", default=None)


@contextlib.contextmanager
def bind_mesh(mesh):
    """Resolve axis names against ``mesh`` inside the ``with`` block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh that axis names resolve against; raises outside
    ``shard_map``/``bind_mesh``."""
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("mesh axis names resolve only inside shard_map "
                           "(or bind_mesh)")
    return mesh


def with_current_mesh(fn):
    """``fn`` bound to the current mesh (if any) wherever it is called
    later: for code that autograd may run again on its own thread, such
    as a checkpointed layer's recompute."""
    mesh = _MESH.get()
    if mesh is None:
        return fn

    def bound(*args, **kwargs):
        with bind_mesh(mesh):
            return fn(*args, **kwargs)
    return bound


def _dim(axis: str) -> int:
    names = current_mesh().mesh_dim_names
    if axis not in names:
        raise ValueError(f"unknown mesh axis {axis!r}; the mesh has {names}")
    return names.index(axis)


def axis_size(axis: str) -> int:
    """Size of a mesh axis (a Python int)."""
    return current_mesh().size(_dim(axis))


def axis_index(axis: str) -> int:
    """This rank's coordinate on a mesh axis (a Python int)."""
    _dim(axis)
    return current_mesh().get_local_rank(axis)


def _group(axis: str):
    _dim(axis)
    return current_mesh().get_group(axis)


# ----------------------------------------------- the collectives, no grad

def _all_reduce(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x, group, dim: int, tiled: bool):
    """Shards stacked on a new ``dim`` (rank order), or concatenated
    along ``dim`` when ``tiled``."""
    n = dist.get_world_size(group)
    flat = x.contiguous().reshape(-1)
    out = flat.new_empty(n * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=group)
    out = out.view((n,) + tuple(x.shape)).movedim(0, dim)
    return out.flatten(dim, dim + 1) if tiled else out


def _reduce_scatter(x, group, dim: int, tiled: bool):
    """The sum over ranks, cut along ``dim`` into one block per rank
    (``tiled``) or indexed by rank on ``dim`` (size n, removed)."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n or (not tiled and x.shape[dim] != n):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not scatter "
                         f"over {n} ranks (tiled={tiled})")
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, dim) if tiled else out[0]


def _all_to_all(x, group, split_dim: int, concat_dim: int, tiled: bool):
    """Block j of ``split_dim`` goes to rank j; the blocks received are
    concatenated along ``concat_dim`` (``tiled``) or stacked on a new
    ``concat_dim`` after ``split_dim`` (size n) is removed, in source
    rank order."""
    n = dist.get_world_size(group)
    size = x.shape[split_dim]
    if size % n or (not tiled and size != n):
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks (tiled={tiled})")
    xs = x.movedim(split_dim, 0)
    if tiled:     # [n, size / n, rest...]
        xs = xs.reshape((n, size // n) + tuple(xs.shape[1:]))
    xs = xs.contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    if not tiled:
        return out.movedim(0, concat_dim)
    out = out.movedim(1, split_dim + 1)    # [n, *block shape]
    return out.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


def _ppermute(x, group, perm):
    """``perm``: (source, destination) pairs of group ranks. A rank that
    is no pair's destination gets zeros; a pair (r, r) is a copy, with no
    send or receive."""
    me = dist.get_rank(group)
    out, ops = torch.zeros_like(x), []
    send = x.contiguous()
    for src, dst in perm:
        if src == me and dst == me:
            out = x.clone()
        elif src == me:
            ops.append(dist.P2POp(dist.isend, send,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            out = torch.empty_like(send)
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


# ------------------------------------------ autograd with JAX's transposes

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tiled):
        ctx.args = (group, dim, tiled)
        return _all_gather(x, group, dim, tiled)

    @staticmethod
    def backward(ctx, ct):
        return _reduce_scatter(ct, *ctx.args), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tiled):
        ctx.args = (group, dim, tiled)
        return _reduce_scatter(x, group, dim, tiled)

    @staticmethod
    def backward(ctx, ct):
        return _all_gather(ct, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim, tiled):
        ctx.args = (group, concat_dim, split_dim, tiled)
        return _all_to_all(x, group, split_dim, concat_dim, tiled)

    @staticmethod
    def backward(ctx, ct):
        return _all_to_all(ct, *ctx.args), None, None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, ct):
        inverse = tuple((dst, src) for src, dst in ctx.perm)
        return _ppermute(ct, ctx.group, inverse), None, None


class _TpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.group), None


class _TpAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def psum(x, axis: str):
    """All-reduce-sum over a mesh axis (ray.util.collective.allreduce)."""
    return _Psum.apply(x, _group(axis))


def pmean(x, axis: str):
    return psum(x, axis) / axis_size(axis)


def all_gather(x, axis: str, *, tiled: bool = True, gather_dim: int = 0):
    """Gather shards along a mesh axis (collective.allgather)."""
    return _AllGather.apply(x, _group(axis), gather_dim, tiled)


def psum_scatter(x, axis: str, *, scatter_dim: int = 0, tiled: bool = True):
    """Reduce-scatter (collective.reducescatter)."""
    return _PsumScatter.apply(x, _group(axis), scatter_dim, tiled)


def all_to_all(x, axis: str, *, split_dim: int, concat_dim: int,
               tiled: bool = True):
    """All-to-all over a mesh axis, the Ulysses/MoE primitive."""
    return _AllToAll.apply(x, _group(axis), split_dim, concat_dim, tiled)


def ppermute(x, axis: str, perm):
    """Send this rank's ``x`` along ``perm``, (source, destination) pairs
    of axis coordinates; ranks no pair reaches get zeros."""
    return _Ppermute.apply(x, _group(axis), tuple(map(tuple, perm)))


def ppermute_ring(x, axis: str, *, shift: int = 1):
    """Rotate shards around the axis ring (ring attention's hop)."""
    n = axis_size(axis)
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)])


def tp_copy(x, axis: str):
    """Identity forward, psum backward (Megatron's "f" operator).

    Place on a tp-replicated activation right before column-parallel
    (output-sharded) matmuls: each tp rank backpropagates only its
    shard's contribution to the activation cotangent, so the cotangents
    must be summed over tp to stay consistent with the replicated
    forward value.
    """
    return _TpCopy.apply(x, _group(axis))


def tp_allreduce(x, axis: str):
    """psum forward, identity backward (Megatron's "g" operator).

    Place on a row-parallel matmul's partial output. ``psum``'s own
    transpose SUMS cotangents across ranks, which is right only when
    every rank's cotangent is a distinct contribution; here the
    downstream compute is replicated on ``axis`` (every rank holds the
    same loss copy and produces the same cotangent), so the true
    cotangent of each rank's partial is that single copy: identity.
    Requires: the output must be consumed by tp-replicated computation.
    """
    return _TpAllreduce.apply(x, _group(axis))


def broadcast_from(x, axis: str, root: int = 0):
    """Broadcast the root shard's value to all ranks on the axis
    (collective.broadcast): select root's contribution, all-reduce."""
    is_root = torch.full((), axis_index(axis) == root, device=x.device)
    return psum(torch.where(is_root, x, torch.zeros_like(x)), axis)


# ------------------------------------------------------------- shard_map

def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def map_specs(fn, specs, tree):
    """``fn(leaf, spec)`` over ``tree``, with ``specs`` a prefix of it
    whose leaves are ``PartitionSpec``s."""
    if isinstance(specs, PartitionSpec):
        return _map_leaves(lambda x: fn(x, specs), tree)
    if isinstance(specs, dict):
        if set(specs) != set(tree):
            raise ValueError(f"spec keys {sorted(specs)} != tree keys "
                             f"{sorted(tree)}")
        return {k: map_specs(fn, specs[k], tree[k]) for k in tree}
    if isinstance(specs, (tuple, list)) and len(specs) == len(tree):
        return type(tree)(map_specs(fn, s, t) for s, t in zip(specs, tree))
    raise TypeError(f"spec {specs!r} does not match {type(tree).__name__}")


def unshard(x, spec):
    """The full tensor from every rank's block under ``spec`` (tiled
    all-gathers along its named dims); inside ``shard_map``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = all_gather(x, axis, tiled=True, gather_dim=dim)
    return x


def shard_map(f, *, mesh, in_specs, out_specs, check_vma=None,
              check_rep=None):
    """Per-rank ``jax.shard_map``: ``shard_map(f, ...)(*args)`` takes this
    rank's block of each full input by its spec, runs ``f`` with the
    mesh's axis names bound, and gathers each output by its spec (an
    output whose spec names no axis is this rank's value as it is).
    ``in_specs`` is a tree prefix of the args tuple (one spec per arg,
    or one for all), ``out_specs`` of the output. ``check_vma`` /
    ``check_rep`` are accepted for the reference's call shape and
    ignored."""
    del check_vma, check_rep

    def mapped(*args):
        specs = (in_specs,) * len(args) if isinstance(
            in_specs, PartitionSpec) else in_specs
        local = map_specs(lambda x, s: local_shard(x, s, mesh), tuple(specs),
                           args)
        with bind_mesh(mesh):
            return map_specs(unshard, out_specs, f(*local))
    return mapped
