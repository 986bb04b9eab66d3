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

The CUDA kernels do not run here. What the bf16 tensor-core route
(``csrc/flash_bwd_sm90.cu``) is built on is pinned by emulating its
rounding points in torch against the plain version under
``chip_smoke.BWD_TOL``, and its routing and launch arguments by calling
the launch path with the C call replaced.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

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


def _bf16_share(got, ref):
    """The worst element's error over chip_smoke's bf16 allowance."""
    atol, rtol = chip_smoke.BWD_TOL[torch.bfloat16]
    return max(float(((g.float() - r.float()).abs()
                      / (atol + rtol * r.float().abs())).max())
               for g, r in zip(got, ref))


@pytest.mark.parametrize("split,within", [(True, True), (False, False)])
def test_sm90_rounding_points_hold_the_two_ulp_check(split, within):
    # The sm90 kernels take bf16 q, k, v, dO (exact products in fp32),
    # sum S and dP in fp32, form p and ds in fp32 and hand them to the
    # three products that take them as bf16: split as hi + lo (the
    # kernel), the sums stay within two ulps of the plain version; one
    # bf16 rounding (FlashAttention-2/3) fails the check by ~10x.
    _, (tq, tk, tv, tdo) = _attn_inputs(256, "bf16", seed=60)
    tq, tk, tv, tdo = (x[:1] for x in (tq, tk, tv, tdo))   # 1 x 256 x 2 x 64
    out, lse = tattn.flash_attention_reference(tq, tk, tv)
    delta = tattn.flash_delta(out, tdo)
    want = tattn.flash_backward_reference(tq, tk, tv, out, lse, tdo)
    p, ds = tattn._bwd_probs(tq, tk, tv, tdo, lse, delta, True, 64 ** -0.5)

    def operand(x):
        hi = x.to(torch.bfloat16).float()
        return hi + (x - hi).to(torch.bfloat16).float() if split else hi

    p, ds = operand(p), operand(ds)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, tdo.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, tq.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, tk.float())
    share = _bf16_share([x.to(torch.bfloat16) for x in (dq, dk, dv)], want)
    assert (share <= 0.6) if within else (share > 4), share


def test_bwd_route_by_dtype_and_sm90_alignment():
    x = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    assert tattn._route(x) == "sm90"
    assert tattn._route(x.float()) == "scalar"
    with pytest.raises(TypeError):
        tattn._route(x.half())
    tattn._check_sm90_alignment(x, x.transpose(1, 2))   # strides 64, 128
    padded = torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        tattn._check_sm90_alignment(x, padded)          # h stride 68
    flat = torch.zeros(x.numel() + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + x.numel()].view(x.shape)       # 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        tattn._check_sm90_alignment(shifted)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "sm90"),
                                         (torch.float32, "scalar")])
def test_bwd_launch_takes_its_route_with_its_signature(monkeypatch, dtype,
                                                        route):
    # the launch path on CPU tensors with the C call replaced: each
    # kernel's library, entry point and argument count (plus the stream)
    # match its ctypes signature, and the launch counts by route
    calls = []
    monkeypatch.setattr(tattn, "_kernel_fn", lambda lib, name: name)
    monkeypatch.setattr(tattn, "_launch",
                        lambda lib, q, fn, *args: calls.append(
                            (lib, fn, args)))
    for fn in (tattn.flash_bwd_dkv, tattn.flash_bwd_dq):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_route",
                            {"sm90": 0, "scalar": 0})
    q, k, v, do = (torch.zeros(2, 96, 2, 64, dtype=dtype) for _ in range(4))
    lse, delta = torch.zeros(2, 2, 96, 1), torch.zeros(2, 2, 96, 1)
    dk, dv = tattn._launch_flash_bwd_dkv(q, k, v, do, lse, delta, True, 0.1)
    dq = tattn._launch_flash_bwd_dq(q, k, v, do, lse, delta, True, 0.1)
    assert dk.dtype == dv.dtype == dq.dtype == dtype
    suffix = "_sm90" if route == "sm90" else ""
    assert [(lib, fn) for lib, fn, _ in calls] == [
        (tattn._BWD_LIBS[route], f"flash_bwd_dkv{suffix}"),
        (tattn._BWD_LIBS[route], f"flash_bwd_dq{suffix}")]
    for _, fn, args in calls:
        assert len(args) + 1 == len(tattn._SIGNATURES[fn])
    want = {"sm90": 0, "scalar": 0, route: 1}
    assert tattn.flash_bwd_dkv.launches_by_route == want
    assert tattn.flash_bwd_dq.launches_by_route == want
    assert tattn.flash_bwd_dkv.launches == tattn.flash_bwd_dq.launches == 1
    if route == "sm90":   # a misaligned input raises before any launch
        with pytest.raises(ValueError, match="multiples of 8"):
            tattn._launch_flash_bwd_dq(
                q, k, torch.zeros(2, 96, 2, 68, dtype=dtype)[..., :64],
                do, lse, delta, True, 0.1)
        assert len(calls) == 2
