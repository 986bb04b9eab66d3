"""Attention: plain PyTorch references and the Hopper flash kernel (K1).

Counterpart of ``ray_tpu/ops/attention.py``. Shapes everywhere:
[batch, seq, heads, head_dim].

* ``attention`` is the plain reference softmax attention (the JAX
  package's XLA path): fp32 scores and softmax, ``p`` cast to v's dtype,
  P·V accumulated in fp32, causal mask bottom-right aligned when
  Tq != Tk.
* ``flash_attention_reference`` is the plain version of the kernel: the
  same function as ``_flash_kernel`` (fp32 throughout, masked scores at
  -1e30), returning ``(out, lse)`` with lse fp32
  [B, H, T, 1].
* ``flash_forward`` is the kernel's wrapper: a CUDA tensor launches
  ``csrc/flash_fwd.cu``, a CPU tensor takes the plain version.
* ``flash_attention`` dispatches as the JAX function does, except that on
  CUDA every Tq == Tk call launches the kernel, at any T (the kernel
  masks the ragged tail itself).

The backward kernels (K2, K3) are not ported yet: a CUDA input that
requires grad raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch._private import kernels

_NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


def _scale(q: torch.Tensor, sm_scale: float | None) -> float:
    return sm_scale if sm_scale is not None else q.shape[-1] ** -0.5


def attention(q, k, v, *, causal: bool = True,
              sm_scale: float | None = None) -> torch.Tensor:
    """Reference softmax attention (fp32 accumulation)."""
    sm_scale = _scale(q, sm_scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        # q sits at the tail of the kv sequence when Tq != Tk (decode)
        qpos = torch.arange(Tq, device=q.device) + (Tk - Tq)
        mask = qpos[:, None] >= torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(),
                        v.float()).to(q.dtype)


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              sm_scale: float | None = None):
    """Plain version of K1: ``(out, lse)``, out in q's dtype, lse fp32
    [B, H, T, 1] = m + log(l). Tq must equal Tk, as for the kernel."""
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, T, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    sm_scale = _scale(q, sm_scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        T = q.shape[1]
        pos = torch.arange(T, device=q.device)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)   # >= 1: the max term is exp(0)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / l
    return out.transpose(1, 2).to(q.dtype), m + torch.log(l)


@functools.cache
def _flash_fwd_fn():
    fn = kernels.library("flash_fwd").flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel_error(err: int) -> str:
    fn = kernels.library("flash_fwd").flash_fwd_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def _launch_flash_fwd(q, k, v, causal: bool, sm_scale: float):
    """Launch csrc/flash_fwd.cu on q's current stream; ``(out, lse)``."""
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share one dtype")
    if q.dim() != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, T, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one device")
    B, T, H, D = q.shape
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {D}")
    if min(B, T, H) < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash kernel needs unit stride on head_dim")
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T, 1), dtype=torch.float32, device=q.device)
    fn = _flash_fwd_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, T, H, D, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                 float(sm_scale), int(causal), _KERNEL_DTYPES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: "
                           f"{_kernel_error(err)} (cudaError {err})")
    flash_attention.launches += 1
    return out, lse


def flash_forward(q, k, v, *, causal: bool = True,
                  sm_scale: float | None = None):
    """K1's wrapper: ``(out, lse)``. CUDA tensors launch the kernel (or
    raise); CPU tensors take ``flash_attention_reference``."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type != "cuda":
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash attention backward kernels are not ported yet")
    return _launch_flash_fwd(q, k, v, causal, sm_scale)


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Blockwise online-softmax attention; the JAX signature.

    CUDA with Tq == Tk: the K1 kernel, at any T. CUDA with Tq != Tk
    (decode) and every CPU call: ``attention``, as the JAX function does
    off-TPU. ``block_q``/``block_k`` are kept for signature parity: the
    CUDA kernel tiles at 64 x 64 whatever they say.
    """
    del block_q, block_k
    sm_scale = _scale(q, sm_scale)
    if q.device.type != "cuda" or k.shape[1] != q.shape[1]:
        return attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return flash_forward(q, k, v, causal=causal, sm_scale=sm_scale)[0]


flash_attention.launches = 0   # K1 launches since the last reset
