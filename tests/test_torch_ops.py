"""Parity of the port's ops (ray_tpu_torch.ops) with the JAX package's.

The same numpy inputs go through both. The JAX side runs the Pallas
flash kernel (K1) in interpret mode, as tests/test_ops.py does, and its
``_flash_forward`` for the per-row logsumexp. The port runs on the CPU,
where ``flash_attention`` takes the plain path and
``flash_attention_reference`` is K1's plain version.

Tolerances are those of tests/test_ops.py: fp32 2e-5, bf16 3e-2.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rotary as jrotary
from ray_tpu_torch.ops import norms as tnorms
from ray_tpu_torch.ops import rotary as trotary

# the packages' __init__ rebinds ``ops.attention`` to the function
jattn = importlib.import_module("ray_tpu.ops.attention")
tattn = importlib.import_module("ray_tpu_torch.ops.attention")

F32_TOL = 2e-5
BF16_TOL = 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x, jdt, tdt):
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rmsnorm_matches_jax(dt):
    jdt, tdt, tol = DTYPES[dt]
    jx, tx = _both(_rand(0, 2, 5, 64), jdt, tdt)
    jw, tw = _both(1.0 + 0.1 * _rand(1, 64), jdt, tdt)
    _close(tnorms.rmsnorm(tx, tw), jnorms.rmsnorm(jx, jw), tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("with_positions", [False, True])
def test_rotary_matches_jax(dt, with_positions):
    jdt, tdt, tol = DTYPES[dt]
    jx, tx = _both(_rand(2, 2, 6, 3, 16), jdt, tdt)
    jcos, jsin = jrotary.rope_frequencies(16, 32)
    tcos, tsin = trotary.rope_frequencies(16, 32, device="cpu")
    _close(tcos, jcos, F32_TOL)
    _close(tsin, jsin, F32_TOL)
    pos = np.array([3, 9, 0, 31, 7, 7]) if with_positions else None
    want = jrotary.apply_rotary(
        jx, jcos, jsin, positions=None if pos is None else jnp.asarray(pos))
    got = trotary.apply_rotary(
        tx, tcos, tsin,
        positions=None if pos is None else torch.from_numpy(pos))
    _close(got, want, tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(48, 48), (1, 40)])
def test_attention_matches_jax(dt, causal, tq, tk):
    # Tq=1 < Tk pins the bottom-right-aligned causal mask (decode shape)
    jdt, tdt, tol = DTYPES[dt]
    jq, tq_ = _both(_rand(3, 2, tq, 2, 32), jdt, tdt)
    jk, tk_ = _both(_rand(4, 2, tk, 2, 32), jdt, tdt)
    jv, tv = _both(_rand(5, 2, tk, 2, 32), jdt, tdt)
    _close(tattn.attention(tq_, tk_, tv, causal=causal),
           jattn.attention(jq, jk, jv, causal=causal), tol)


def _flash_inputs(seed, T, jdt=jnp.float32, tdt=torch.float32):
    xs = [_rand(seed + i, 1, T, 2, 64) for i in range(3)]
    return [_both(x, jdt, tdt) for x in xs]


def _check_k1(T, causal, block_q, block_k, jdt, tdt, tol):
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(10, T, jdt, tdt)
    scale = 64 ** -0.5
    j_out, j_lse = jattn._flash_forward(jq, jk, jv, causal, scale, block_q,
                                        block_k, True)
    t_out, t_lse = tattn.flash_attention_reference(tq, tk, tv,
                                                   causal=causal)
    assert t_lse.dtype == torch.float32 and t_lse.shape == (1, 2, T, 1)
    _close(t_out, j_out, tol)
    _close(t_lse, j_lse, F32_TOL)
    # the wrapper takes the plain version for a CPU tensor
    w_out, w_lse = tattn.flash_forward(tq, tk, tv, causal=causal)
    assert torch.equal(w_out, t_out) and torch.equal(w_lse, t_lse)
    # flash_attention on the CPU: JAX's off-TPU rule (plain attention)
    want = jattn.flash_attention(jq, jk, jv, causal=causal,
                                 block_q=block_q, block_k=block_k,
                                 interpret=True)
    got = tattn.flash_attention(tq, tk, tv, causal=causal,
                                block_q=block_q, block_k=block_k)
    _close(got, want, tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_q,block_k", [(128, 128), (64, 128),
                                             (128, 64)])
def test_flash_matches_jax_kernel(causal, block_q, block_k):
    _check_k1(256, causal, block_q, block_k, jnp.float32, torch.float32,
              F32_TOL)


def test_flash_matches_jax_kernel_bf16():
    _check_k1(128, True, 64, 64, jnp.bfloat16, torch.bfloat16, BF16_TOL)


def test_flash_unaligned_t_matches_jax_kernel():
    # T=96 is not a multiple of 64: the JAX kernel runs it with 32-row
    # blocks; the port's kernel masks the ragged tail of its 64-row tiles
    _check_k1(96, True, 32, 32, jnp.float32, torch.float32, F32_TOL)


def test_flash_decode_shape_takes_plain_attention():
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(20, 40)
    want = jattn.flash_attention(jq[:, -1:], jk, jv)
    got = tattn.flash_attention(tq[:, -1:], tk, tv)
    _close(got, want, F32_TOL)
    with pytest.raises(ValueError, match="share one"):
        tattn.flash_attention_reference(tq[:, -1:], tk, tv)

