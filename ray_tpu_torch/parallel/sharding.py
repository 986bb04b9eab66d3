"""Sharding rules for transformer training (counterpart of
``ray_tpu/parallel/sharding.py``).

This module maps *logical* tensor axis names to mesh axes, the seam
where tp/dp/sp/pp layout policy lives. A spec is a ``PartitionSpec``: a
plain tuple with one mesh axis name (or ``None``, replicated) per tensor
dim, leading dims first; missing trailing dims are replicated.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# logical axis name → mesh axis (None = replicated).
DEFAULT_RULES = {
    "batch": "dp",
    "seq": "sp",          # sequence parallelism for activations
    "kv_seq": None,
    "embed": None,        # residual stream replicated across tp
    "mlp": "tp",          # ffn hidden sharded over tp
    "heads": "tp",        # attention heads sharded over tp
    "head_dim": None,
    "vocab": "tp",
    "layers": None,       # stacked-layer leading dim (pp shards it)
    "stages": "pp",
    "expert": "tp",       # experts ride the tp axis by default
}


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: a tuple of mesh axis
    names or ``None``, one per tensor dim. Its own type, so that a tree of
    specs (``shard_map``'s ``in_specs``) can tell a spec from a tuple of
    them."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def transformer_rules(**overrides) -> dict:
    rules = dict(DEFAULT_RULES)
    rules.update(overrides)
    return rules


def logical_to_mesh(logical_axes: Sequence[Optional[str]],
                    rules: Optional[dict] = None) -> PartitionSpec:
    """('batch','seq','embed') → PartitionSpec('dp','sp',None)."""
    rules = rules or DEFAULT_RULES
    return P(*[rules.get(a) if a else None for a in logical_axes])


def local_shard(x: torch.Tensor, spec: Sequence[Optional[str]],
                mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec`` on
    ``mesh`` (a view): each named dim is cut into the axis's size equal
    blocks and the rank's coordinate on that axis picks one. Raises when
    a sharded dim does not divide."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{x.dim()} dims of a {tuple(x.shape)} tensor")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.size(mesh.mesh_dim_names.index(axis))
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(x.shape)} tensor does "
                             f"not divide over axis {axis!r} of size {n}")
        block = x.shape[dim] // n
        x = x.narrow(dim, mesh.get_local_rank(axis) * block, block)
    return x


def with_sharding(mesh, x: torch.Tensor,
                  logical_axes: Sequence[Optional[str]],
                  rules: Optional[dict] = None) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under the sharding its
    logical axes imply. JAX's version constrains a global array's layout
    and lets XLA move the data; per rank, the same sharding means taking
    the rank's slice."""
    return local_shard(x, logical_to_mesh(logical_axes, rules), mesh)


def named_sharding(mesh, logical_axes: Sequence[Optional[str]],
                   rules: Optional[dict] = None):
    """No per-rank counterpart: JAX's ``NamedSharding`` describes how a
    global array is laid out over devices, and in the port no object
    holds a global array. Use ``logical_to_mesh`` for the spec and
    ``with_sharding`` (or ``local_shard``) for this rank's block."""
    raise NotImplementedError(
        "named_sharding has no per-rank counterpart; use logical_to_mesh "
        "for the spec and with_sharding for this rank's block")
