"""K1's tensor-core route (``csrc/flash_fwd_sm90.cu``) on the CPU.

The CUDA kernel does not run here. What it is built on is pinned by
emulating its rounding points in torch (bf16 q, k, v; S summed in fp32;
an online softmax over k-tiles in fp32; P split hi + lo into the P.V
product) against K1's plain version under ``chip_smoke.TOL``, and its
routing and launch arguments by calling the launch path with the C call
replaced. The parity of the plain version with the JAX
package's Pallas K1 is in tests/test_torch_ops.py.
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke

tattn = importlib.import_module("ray_tpu_torch.ops.attention")


def _inputs(seed, B, T, H, D, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(
        np.float32)).to(dtype) for _ in range(3)]


def _sm90_forward(q, k, v, split, block_k=64):
    """The sm90 K1's arithmetic: per k-tile of block_k keys, S = Q.K^T in
    fp32, masked to -1e30, the running max and denominator rescaled by
    alpha, and O += P.V with P as hi + lo bf16 (``split``) or one bf16
    rounding; O / l and lse = m * scale + log(l) at the end."""
    B, T, H, D = q.shape
    scale = D ** -0.5
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # [B,H,T,D]
    m = torch.full((B, H, T, 1), -1e30)
    l = torch.zeros(B, H, T, 1)
    acc = torch.zeros(B, H, T, D)
    qpos = torch.arange(T)[:, None]
    for k0 in range(0, T, block_k):
        kpos = torch.arange(k0, min(T, k0 + block_k))[None, :]
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)
        s = s.masked_fill(qpos < kpos, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp((m - m_new) * scale)
        p = torch.exp((s - m_new) * scale)
        hi = p.to(torch.bfloat16).float()
        p_v = hi + (p - hi).to(torch.bfloat16).float() if split else hi
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p_v @ vf[:, :, k0:k0 + block_k]
        m = m_new
    out = (acc / l).transpose(1, 2).to(q.dtype)
    return out, m * scale + torch.log(l)


@pytest.mark.parametrize("T", [256, 300])   # 300: a ragged last k-tile
@pytest.mark.parametrize("split,within", [(True, True), (False, False)])
def test_sm90_k1_rounding_points_hold_the_two_ulp_check(T, split, within):
    # With P split hi + lo, O stays within two bf16 ulps of the plain
    # version (~0.47 of the allowance here, 0.49 on an H100); one bf16
    # rounding of P (FlashAttention-2/3) fails the check ~8x. lse does
    # not see P.V and holds its fp32 tolerance either way.
    q, k, v = _inputs(70, 1, T, 2, 64)
    want, want_lse = tattn.flash_attention_reference(q, k, v)
    got, lse = _sm90_forward(q, k, v, split)
    tol = chip_smoke.TOL[torch.bfloat16]
    share = chip_smoke.tol_share(got, want, *tol["o"])
    assert (share <= 0.6) if within else (share > 4), share
    assert chip_smoke.tol_share(lse, want_lse, *tol["lse"]) <= 1.0


def test_fwd_route_by_dtype_and_tile():
    x = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    assert tattn._route(x) == "sm90"
    assert tattn._route(x.float()) == "scalar"
    with pytest.raises(TypeError):
        tattn._route(x.half())
    # the sm90 K1 tiles at 64 x 64 whatever block_q/block_k say: its C
    # entry point takes no tile, only the scalar route's dtype tag
    assert (tattn._SIGNATURES["flash_fwd_sm90"]
            == tattn._FWD_ARGS + tattn._TAIL_BF16)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "sm90"),
                                         (torch.float32, "scalar")])
def test_fwd_launch_takes_its_route_with_its_signature(monkeypatch, dtype,
                                                        route):
    # the launch path on CPU tensors with the C call replaced: the
    # library, entry point and argument count (plus the stream) match
    # its ctypes signature, and the launch counts by route
    calls = []
    monkeypatch.setattr(tattn, "_kernel_fn", lambda lib, name: name)
    monkeypatch.setattr(tattn, "_launch",
                        lambda lib, q, fn, *args: calls.append(
                            (lib, fn, args)))
    monkeypatch.setattr(tattn.flash_attention, "launches", 0)
    monkeypatch.setattr(tattn.flash_attention, "launches_by_route",
                        {"sm90": 0, "scalar": 0})
    q, k, v = (torch.zeros(2, 96, 2, 64, dtype=dtype) for _ in range(3))
    out, lse = tattn._launch_flash_fwd(q, k, v, True, 0.1)
    assert out.dtype == dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, 96, 1)
    name = "flash_fwd_sm90" if route == "sm90" else "flash_fwd"
    [(lib, fn, args)] = calls
    assert (lib, fn) == (tattn._FWD_LIBS[route], name)
    assert len(args) + 1 == len(tattn._SIGNATURES[fn])
    assert args[21:23] == (0.1, 1)   # sm_scale, causal after strides
    assert tattn.flash_attention.launches_by_route == {
        "sm90": 0, "scalar": 0, route: len(calls)}
    assert tattn.flash_attention.launches == len(calls)
    if route == "sm90":   # a misaligned input raises before any launch
        padded = torch.zeros(2, 96, 2, 68, dtype=dtype)[..., :64]
        with pytest.raises(ValueError, match="multiples of 8"):
            tattn._launch_flash_fwd(q, padded, v, True, 0.1)
        assert len(calls) == 1 and tattn.flash_attention.launches == 1


@pytest.mark.parametrize("D", [8, 32, 64, 128])
def test_flash_attention_routes_head_dims_the_kernels_lack(D):
    # on CUDA every Tq == Tk call runs the kernels, whatever the head_dim:
    # those they are built for pass their checks, and any other raises
    # there rather than running the plain path on the card; decode
    # (Tq != Tk) and the CPU take the plain path
    assert tattn._use_kernel("cuda", 96, 96)
    assert tattn._use_kernel("cuda", 300, 300)
    assert not tattn._use_kernel("cuda", 1, 96)
    assert not tattn._use_kernel("cpu", 96, 96)
    assert D in tattn._KERNEL_HEAD_DIMS
    tattn._check_kernel_inputs(*(torch.zeros(1, 8, 2, D) for _ in range(3)))
    lack = {8: 24, 32: 40, 64: 96, 128: 256}[D]   # a width beside D
    with pytest.raises(ValueError, match="head_dim"):
        tattn._check_kernel_inputs(*(torch.zeros(1, 8, 2, lack)
                                     for _ in range(3)))


@pytest.mark.parametrize("D", [32, 64])
def test_flash_attention_consults_the_routing(monkeypatch, D):
    # flash_attention asks _use_kernel with the call's (device, Tq, Tk):
    # with the device taken out of the decision, D=32 reaches _Flash as
    # D=64 does
    asked, flashed = [], []
    monkeypatch.setattr(tattn, "_use_kernel", lambda dev, tq, tk: (
        asked.append((dev, tq, tk)) or True))
    monkeypatch.setattr(tattn._Flash, "apply", lambda q, k, v, causal, sc: (
        flashed.append(q.shape) or tattn.attention(q, k, v, causal=causal,
                                                   sm_scale=sc)))
    q, k, v = _inputs(3, 1, 40, 2, D, torch.float32)
    out = tattn.flash_attention(q, k, v)
    assert asked == [("cpu", 40, 40)]
    assert flashed == [q.shape]
    torch.testing.assert_close(out, tattn.attention(q, k, v))
