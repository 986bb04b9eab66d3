"""Serving: continuous batching over the per-slot KV cache."""

from ray_tpu_torch.serve.decode_scheduler import (  # noqa: F401
    DecodeScheduler,
    TorchSlotEngine,
)
