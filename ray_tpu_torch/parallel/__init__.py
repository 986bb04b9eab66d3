"""The parallelism layer on ``torch.distributed`` (counterpart of
``ray_tpu/parallel``).

Per-rank SPMD code over a 4-axis ``DeviceMesh`` (``mesh.build_mesh``),
one process per device (``launch.run_spmd``), with explicit collectives
on the mesh's per-axis process groups (``collectives``): Megatron tp,
ring or Ulysses sp, a GPipe pipeline on pp, data-parallel gradient
means, and top-1 MoE all-to-all. NCCL on the card, gloo on the CPU.

Axes (by convention, any subset may be size 1):
  dp — data parallel (batch)
  pp — pipeline parallel (layer stages)
  sp — sequence/context parallel (ring attention / Ulysses)
  tp — tensor parallel (also used for experts)
"""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    MeshConfig,
    build_mesh,
    default_mesh_shape,
)
from ray_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather,
    all_to_all,
    axis_index,
    axis_size,
    pmean,
    ppermute_ring,
    psum,
    psum_scatter,
    shard_map,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    logical_to_mesh,
    transformer_rules,
    with_sharding,
)
from ray_tpu_torch.parallel.ring_attention import ring_attention  # noqa: F401
from ray_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
from ray_tpu_torch.parallel.pipeline import pipeline_spmd  # noqa: F401
from ray_tpu_torch.parallel.moe import moe_dispatch_combine  # noqa: F401
