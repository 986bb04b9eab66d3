"""The flagship decoder on one device: forward, loss and train step,
KV-cached decode, and conversion of the JAX package's params."""

from ray_tpu_torch.models.convert import params_from_jax  # noqa: F401
from ray_tpu_torch.models.decode import (  # noqa: F401
    decode_step,
    generate,
    init_kv_cache,
    init_slot_cache,
    prefill,
    slot_decode_step,
    slot_prefill,
)
from ray_tpu_torch.models.transformer import (  # noqa: F401
    AdamW,
    ParallelConfig,
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
)
