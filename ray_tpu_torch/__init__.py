"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's device layer.

A second package beside ``ray_tpu`` (the JAX reference), file for file:
``ray_tpu_torch/ops/attention.py`` ports ``ray_tpu/ops/attention.py``
and so on. It imports torch and numpy, never jax and nothing of
``ray_tpu``. Entry points run on CUDA unless the caller passes
``device="cpu"``; the TPU's Pallas kernels become hand-written CUDA
kernels (``csrc/``) built with nvcc at first use, with no fallback.
"""

from ray_tpu_torch._private.device import resolve_device  # noqa: F401
from ray_tpu_torch.entry import dryrun_multichip, entry  # noqa: F401
from ray_tpu_torch.exceptions import (  # noqa: F401
    RayTpuError,
    ServeOverloadedError,
)
