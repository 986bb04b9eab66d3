"""Hot ops of the flagship model: plain PyTorch, with hand-written CUDA
kernels where the JAX package had Pallas ones (flash attention forward
and backward)."""

from ray_tpu_torch.ops.attention import (  # noqa: F401
    attention,
    flash_attention,
    flash_attention_reference,
    flash_backward_reference,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_forward,
)
from ray_tpu_torch.ops.norms import rmsnorm  # noqa: F401
from ray_tpu_torch.ops.rotary import (  # noqa: F401
    apply_rotary,
    rope_frequencies,
)
