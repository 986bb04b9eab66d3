"""Operations, bytes and peaks: the arithmetic every share is made of.

Frozen copies, each marked with its origin in the port's tree, so that a
change to the program cannot move the yardstick:

* ``train_flops``, ``flash_fwd_flops``: ``models/bench_model.py``.
* ``k1_bound``, ``bwd_bound`` (the algorithmic bound only: the split-work
  figure counted the implementation, not the work): ``chip_smoke.py``.

The model shapes come from the cell's configuration as a ``Shape``.
"""

from __future__ import annotations

import dataclasses

# One NVIDIA H100 SXM (data sheet; dense rates, at the full 700 W).
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
BYTES = {"bf16": 2, "fp32": 4}


@dataclasses.dataclass(frozen=True)
class Shape:
    """A decoder's sizes as the port runs it: tied embedding, as many KV
    heads as query heads, SwiGLU."""
    vocab: int
    d_model: int
    n_heads: int
    head_dim: int
    n_layers: int
    d_ff: int

    @property
    def attn_width(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def layer_matmul_params(self) -> int:
        """Parameters of one layer's matrix products (q, k, v, o, gate,
        up, down)."""
        return 4 * self.d_model * self.attn_width + 3 * self.d_model * self.d_ff

    @property
    def n_params(self) -> int:
        """Every parameter: the embedding (tied to the head), the layers'
        matrices and their two norms, the final norm."""
        return (self.vocab * self.d_model
                + self.n_layers * (self.layer_matmul_params + 2 * self.d_model)
                + self.d_model)

    def kv_row_bytes(self, dtype: str = "bf16") -> int:
        """One position's K and V over every layer."""
        return 2 * self.n_layers * self.attn_width * BYTES[dtype]


# --- copied from ray_tpu_torch/models/bench_model.py (train_flops,
# flash_fwd_flops); the configuration's fields are passed as a Shape.

def train_flops(n_params: int, shape: Shape, B: int, T: int) -> float:
    """One train step's FLOPs: 6 per parameter and token, plus the
    causal attention matmuls forward and backward."""
    dense_flops = 6.0 * n_params * B * T
    attn_flops = (12.0 * shape.n_layers * B * shape.n_heads * T * T
                  * shape.head_dim) / 2.0  # causal halves the work
    return dense_flops + attn_flops


def flash_fwd_flops(B: int, T: int, H: int, D: int) -> float:
    """The causal attention forward's two matmuls."""
    return 4.0 * B * H * T * T * D / 2.0


# --- copied from chip_smoke.py (_bound, _pairs, k1_bound, bwd_bound),
# returning seconds; dtype is "bf16" or "fp32".

def _bound(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def _pairs(T, causal):
    """(q, k) pairs the mask keeps, per head."""
    return T * (T + 1) // 2 if causal else T * T


def k1_bound(B, T, H, D, dtype, causal):
    """Least time for K1's work: 2 matmuls of 2 flops per (q, k) pair the
    mask keeps, against q, k, v read once and O, lse written once."""
    flops = 4 * B * H * D * _pairs(T, causal)
    nbytes = 4 * B * T * H * D * BYTES[dtype] + B * H * T * 4
    return _bound(flops, nbytes, dtype)


def bwd_bound(B, T, H, D, dtype, causal, kernel):
    """Least time for K2's (``"dkv"``: s, dp, dV, dK) or K3's (``"dq"``:
    s, dp, dQ) work: 2 flops per (q, k) pair the mask keeps and head_dim
    element of each matmul, against q, k, v, dO, lse and delta read once
    and the outputs (dK, dV or dQ) written once."""
    mats, tensors = (4, 6) if kernel == "dkv" else (3, 5)
    flops = 2 * mats * B * H * D * _pairs(T, causal)
    nbytes = (tensors * B * T * H * D * BYTES[dtype]
              + 2 * B * H * T * 4)
    return _bound(flops, nbytes, dtype)


# --- serving: what the inputs need, whatever the program does.

def prefill_flops(shape: Shape, T: int) -> float:
    """A prompt of T tokens: every matrix product over T rows, causal
    attention over the pairs the mask keeps, logits for the last row."""
    return (2.0 * T * shape.n_layers * shape.layer_matmul_params
            + shape.n_layers * flash_fwd_flops(1, T, shape.n_heads,
                                               shape.head_dim)
            + 2.0 * shape.d_model * shape.vocab)


def decode_flops(shape: Shape, valid_rows: int) -> float:
    """One token that attends ``valid_rows`` cached positions (its own
    included): the matrix products, attention over the valid rows only,
    and its logits."""
    return (2.0 * shape.n_layers * shape.layer_matmul_params
            + 4.0 * shape.n_layers * shape.attn_width * valid_rows
            + 2.0 * shape.d_model * shape.vocab)


def decode_step_bytes(shape: Shape, active: int, valid_rows: int) -> float:
    """The least a decode step of ``active`` rows moves: every parameter
    once (bf16), the valid K/V rows of the active slots (``valid_rows``
    summed over them, the new rows included), the new K/V rows written
    and the fp32 logits written."""
    return (shape.n_params * BYTES["bf16"]
            + valid_rows * shape.kv_row_bytes()
            + active * shape.kv_row_bytes()
            + active * shape.vocab * 4)


def decode_step_flops(shape: Shape, active: int, valid_rows: int) -> float:
    """A decode step of ``active`` rows whose valid rows sum to
    ``valid_rows``: ``decode_flops`` summed over the rows."""
    return (active * (2.0 * shape.n_layers * shape.layer_matmul_params
                      + 2.0 * shape.d_model * shape.vocab)
            + 4.0 * shape.n_layers * shape.attn_width * valid_rows)
