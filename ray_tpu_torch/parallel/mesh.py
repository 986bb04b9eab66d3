"""Device mesh construction (counterpart of ``ray_tpu/parallel/mesh.py``).

The JAX package builds a named ``jax.sharding.Mesh`` over the devices one
process owns. Here every rank is a process that owns one device, so the
mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
default process group (``parallel.launch`` starts them), with one
process group per axis slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# Canonical axis order: outermost (slowest) → innermost (fastest). tp
# innermost so its collectives ride the nearest links.
AXES = ("dp", "pp", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each named axis; -1 on at most one axis means 'rest'."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self) -> tuple:
        return (self.dp, self.pp, self.sp, self.tp)

    def resolve(self, n_devices: int) -> "MeshConfig":
        sizes = list(self.sizes())
        if -1 in sizes:
            i = sizes.index(-1)
            known = math.prod(s for s in sizes if s != -1)
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by {known}")
            sizes[i] = n_devices // known
        if math.prod(sizes) != n_devices:
            raise ValueError(
                f"mesh {dict(zip(AXES, sizes))} != {n_devices} devices")
        return MeshConfig(*sizes)


def default_mesh_shape(n_devices: int) -> MeshConfig:
    """Factorize n_devices over (dp, pp, sp, tp), giving every axis ≥2
    when possible (powers of two first), so all four parallelism kinds
    are exercised on any mesh of ≥16 devices (≥3 kinds on 8)."""
    sizes = [1, 1, 1, 1]
    rest = n_devices
    # Deal factors of two round-robin across axes, tp first (innermost
    # gets the fastest links), then dp (batch scales best), then sp, pp.
    order = [3, 0, 2, 1]
    i = 0
    while rest % 2 == 0 and rest > 1:
        sizes[order[i % 4]] *= 2
        rest //= 2
        i += 1
    sizes[0] *= rest  # odd remainder onto dp
    return MeshConfig(*sizes)


def build_mesh(config: Optional[MeshConfig] = None, *,
               device_type: str = "cuda") -> DeviceMesh:
    """A 4-axis ``DeviceMesh`` named ``AXES`` over the ranks of the
    default process group, rank-major in ``AXES`` order. Singleton axes
    are kept so sharding rules can always name all of dp/pp/sp/tp.
    ``device_type`` is ``"cuda"`` (NCCL, one GPU per rank) unless the
    caller asks for ``"cpu"`` (gloo). Raises without an initialized
    default process group."""
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs an initialized default process group: run "
            "inside parallel.launch.run_spmd, or call "
            "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    config = (config or default_mesh_shape(n)).resolve(n)
    return DeviceMesh(device_type, torch.arange(n).reshape(config.sizes()),
                      mesh_dim_names=AXES)
