"""Parity of the port's flash-attention backward with the JAX package's.

The same numpy inputs go through both. The JAX side differentiates its
``flash_attention`` with ``jax.vjp``: through the Pallas custom_vjp (K1
forward, K2 and K3 backward) in interpret mode where the blocks divide
T, as tests/test_ops.py runs it, and through XLA attention otherwise.
The port runs on the CPU, where ``flash_backward_reference`` is the
plain version of K2 + K3 and ``_Flash``, the autograd Function that
``flash_attention`` takes on CUDA, runs the plain versions of K1-K3.

Tolerances are those of tests/test_ops.py for the Pallas backward: fp32
2e-4, bf16 1e-1 (sums in another order; bf16 rounds dq, dk, dv and the O
that delta reads).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jattn = importlib.import_module("ray_tpu.ops.attention")
tattn = importlib.import_module("ray_tpu_torch.ops.attention")

GRAD_TOL = {"f32": 2e-4, "bf16": 1e-1}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _attn_inputs(T, dt, seed=30):
    jdt, tdt = DTYPES[dt]
    xs = [_rand(seed + i, 2, T, 2, 64) for i in range(4)]   # q, k, v, dO
    return ([jnp.asarray(x, jdt) for x in xs],
            [torch.from_numpy(x).to(tdt) for x in xs])


@pytest.mark.parametrize("dt,causal", [("f32", True), ("f32", False),
                                       ("bf16", True)])
def test_flash_backward_matches_jax_pallas_backward(dt, causal):
    # JAX: jax.vjp through the Pallas custom_vjp (K1 forward, K2 and K3
    # backward) in interpret mode; the port: K1's plain version for O and
    # lse, then the plain version of K2 + K3
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _attn_inputs(128, dt)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(
        q, k, v, causal=causal, block_q=64, block_k=64, interpret=True),
        jq, jk, jv)
    want = vjp(jdo)
    out, lse = tattn.flash_attention_reference(tq, tk, tv, causal=causal)
    got = tattn.flash_backward_reference(tq, tk, tv, out, lse, tdo,
                                         causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == DTYPES[dt][1]
        _close(g, w, GRAD_TOL[dt])


def _autograd_grads(fn, xs, do):
    leaves = [x.clone().requires_grad_() for x in xs]
    fn(*leaves).backward(do)
    return [x.grad for x in leaves]


def test_flash_backward_at_ragged_t_matches_autograd_and_jax():
    # T=96 is not a multiple of JAX's blocks: JAX takes XLA attention;
    # the port's kernels mask the ragged tail of their 64-row tiles
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _attn_inputs(96, "f32", seed=40)
    _, vjp = jax.vjp(jax.jit(jattn.flash_attention), jq, jk, jv)
    out, lse = tattn.flash_attention_reference(tq, tk, tv)
    got = tattn.flash_backward_reference(tq, tk, tv, out, lse, tdo)
    ref = _autograd_grads(tattn.attention, (tq, tk, tv), tdo)
    for g, r, w in zip(got, ref, vjp(jdo)):
        _close(g, r, GRAD_TOL["f32"])
        _close(g, w, GRAD_TOL["f32"])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_on_cpu_takes_plain_versions(causal):
    _, (tq, tk, tv, tdo) = _attn_inputs(80, "f32", seed=50)
    got = _autograd_grads(
        lambda q, k, v: tattn._Flash.apply(q, k, v, causal, 0.125),
        (tq, tk, tv), tdo)
    out, lse = tattn.flash_attention_reference(tq, tk, tv, causal=causal)
    want = tattn.flash_backward_reference(tq, tk, tv, out, lse, tdo,
                                          causal=causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the kernel wrappers take the same plain versions for CPU tensors
    delta = tattn.flash_delta(out, tdo)
    dk, dv = tattn.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal=causal)
    dq = tattn.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, causal=causal)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    assert delta.shape == (2, 2, 80, 1) and delta.dtype == torch.float32
