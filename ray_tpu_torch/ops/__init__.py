"""Hot ops of the flagship model: plain PyTorch, with a hand-written
CUDA kernel where the JAX package had a Pallas one (flash attention)."""

from ray_tpu_torch.ops.attention import (  # noqa: F401
    attention,
    flash_attention,
    flash_attention_reference,
    flash_forward,
)
from ray_tpu_torch.ops.norms import rmsnorm  # noqa: F401
from ray_tpu_torch.ops.rotary import (  # noqa: F401
    apply_rotary,
    rope_frequencies,
)
