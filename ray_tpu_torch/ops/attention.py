"""Attention: plain PyTorch references and the Hopper flash kernels.

Counterpart of ``ray_tpu/ops/attention.py``. Shapes everywhere:
[batch, seq, heads, head_dim].

* ``attention`` is the plain reference softmax attention (the JAX
  package's XLA path): fp32 scores and softmax, ``p`` cast to v's dtype,
  P·V accumulated in fp32, causal mask bottom-right aligned when
  Tq != Tk.
* ``flash_attention_reference`` is the plain version of K1: the same
  function as ``_flash_kernel`` (fp32 throughout, masked scores at
  -1e30), returning ``(out, lse)`` with lse fp32 [B, H, T, 1].
  ``flash_bwd_dkv_reference`` and ``flash_bwd_dq_reference`` are the
  plain versions of K2 and K3 (``_bwd_tiles`` with
  ``_flash_bwd_dkv_kernel`` and ``_flash_bwd_dq_kernel``), and
  ``flash_backward_reference`` the whole of JAX's ``_flash_backward``.
* ``flash_forward``, ``flash_bwd_dkv`` and ``flash_bwd_dq`` are the
  kernels' wrappers: a CUDA tensor launches the route that ``_route``
  picks by dtype, K1 to K3 alike: bf16 the tensor-core kernels
  (``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_sm90.cu``), fp32 the
  scalar ones (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``). A CPU
  tensor takes the plain version. They are not differentiable
  themselves.
* ``flash_attention`` dispatches as the JAX function does, except that on
  CUDA every Tq == Tk call goes through ``_Flash``, the counterpart of
  JAX's ``_flash`` custom_vjp: K1 forward, and delta then K2 and K3
  backward, at any T (the kernels mask the ragged tail themselves) and
  at every head_dim the kernels are built for (8, 16, 32, 64, 128; any
  other raises). ``_use_kernel`` holds that decision; decode steps
  (Tq != Tk) and CPU calls go to ``attention``.

Each wrapper counts its launches: ``flash_attention.launches`` (K1),
``flash_bwd_dkv.launches`` (K2) and ``flash_bwd_dq.launches`` (K3), and
by route in ``.launches_by_route``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch._private import kernels

_NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Under 64 (the tensor-core tile's width) the kernels pad the head in
# shared memory with zero columns.
_KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)


def _scale(q: torch.Tensor, sm_scale: float | None) -> float:
    return sm_scale if sm_scale is not None else q.shape[-1] ** -0.5


def _causal_mask(T: int, device) -> torch.Tensor:
    pos = torch.arange(T, device=device)
    return pos[:, None] >= pos[None, :]


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
        s = s.masked_fill(~_causal_mask(q.shape[1], q.device), _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)   # >= 1: the max term is exp(0)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / l
    return out.transpose(1, 2).to(q.dtype), m + torch.log(l)


def flash_delta(out, do) -> torch.Tensor:
    """delta = rowsum(dO * O), fp32 [B, H, T, 1]: the one XLA reduce of
    JAX's ``_flash_backward``, a torch op here too."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(),
                        out.float())[..., None].contiguous()


def _bwd_probs(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """Plain ``_bwd_tiles`` over the whole [T, T] at once: fp32 ``(p, ds)``
    [B, H, T, T], sm_scale folded into ds."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[1], q.device), _NEG_INF)
    p = torch.exp(s - lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta) * sm_scale


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, causal: bool = True,
                            sm_scale: float | None = None):
    """Plain version of K2: ``(dk, dv)`` in k's and v's dtypes."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, _scale(q, sm_scale))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, causal: bool = True,
                           sm_scale: float | None = None):
    """Plain version of K3: dq in q's dtype."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, _scale(q, sm_scale))
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_backward_reference(q, k, v, out, lse, do, *, causal: bool = True,
                             sm_scale: float | None = None):
    """Plain version of K2 + K3 with delta, the same function as JAX's
    ``_flash_backward``: ``(dq, dk, dv)`` in the inputs' dtypes."""
    sm_scale = _scale(q, sm_scale)
    delta = flash_delta(out, do)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal=causal,
                                     sm_scale=sm_scale)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=causal,
                                sm_scale=sm_scale)
    return dq, dk, dv


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TAIL = [ctypes.c_float, _I, _I, _P]   # sm_scale, causal, dtype, stream
_TAIL_BF16 = [ctypes.c_float, _I, _P]  # sm_scale, causal, stream
# Each C entry point's arguments: pointers, then B, T, H, D, then strides
# (the backward kernels take their inputs' 12 strides as one int64 array).
_FWD_ARGS = [_P] * 5 + [_I] * 4 + [_L] * 12
_DKV_ARGS = [_P] * 8 + [_I] * 4 + [ctypes.POINTER(_L)] + [_L] * 6
_DQ_ARGS = [_P] * 7 + [_I] * 4 + [ctypes.POINTER(_L)] + [_L] * 3
_SIGNATURES = {
    "flash_fwd": _FWD_ARGS + _TAIL,
    "flash_fwd_sm90": _FWD_ARGS + _TAIL_BF16,
    "flash_bwd_dkv": _DKV_ARGS + _TAIL,
    "flash_bwd_dq": _DQ_ARGS + _TAIL,
    "flash_bwd_dkv_sm90": _DKV_ARGS + _TAIL_BF16,
    "flash_bwd_dq_sm90": _DQ_ARGS + _TAIL_BF16,
}
# K1-K3 route by dtype -> the library (csrc/<name>.cu) that holds each
_ROUTES = {torch.bfloat16: "sm90", torch.float32: "scalar"}
_FWD_LIBS = {"sm90": "flash_fwd_sm90", "scalar": "flash_fwd"}
_BWD_LIBS = {"sm90": "flash_bwd_sm90", "scalar": "flash_bwd"}


@functools.cache
def _kernel_fn(lib: str, name: str):
    fn = getattr(kernels.library(lib), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _kernel_error(lib: str, err: int) -> str:
    fn = getattr(kernels.library(lib), f"{lib}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def _check_kernel_inputs(q, *others) -> None:
    """What every flash kernel refuses: another dtype than fp32/bf16,
    mixed dtypes or devices, shapes other than one [B, T, H, D], a
    head_dim outside ``_KERNEL_HEAD_DIMS``, an empty input, or head_dim
    strided."""
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if any(x.dtype != q.dtype for x in others):
        raise TypeError("flash kernel inputs must share one dtype")
    if q.dim() != 4 or any(x.shape != q.shape for x in others):
        shapes = [tuple(x.shape) for x in (q, *others)]
        raise ValueError(f"flash kernel inputs must share one [B, T, H, D] "
                         f"shape, got {shapes}")
    if any(x.device != q.device for x in others):
        raise ValueError("flash kernel inputs must lie on one device")
    B, T, H, D = q.shape
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {D}")
    if min(B, T, H) < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if any(x.stride(-1) != 1 for x in (q, *others)):
        raise ValueError("flash kernel needs unit stride on head_dim")


def _check_rows(q, *rows) -> None:
    """lse and delta: contiguous fp32 [B, H, T, 1] on q's device."""
    B, T, H, _ = q.shape
    for x in rows:
        if (x.dtype != torch.float32 or x.shape != (B, H, T, 1)
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"lse and delta must be contiguous float32 "
                             f"{(B, H, T, 1)} on {q.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _route(q) -> str:
    """Which kernels a CUDA input of q's dtype launches, K1 to K3 alike:
    ``"sm90"`` (bf16: the tensor-core kernels of ``csrc/flash_fwd_sm90.cu``
    and ``csrc/flash_bwd_sm90.cu``) or ``"scalar"`` (fp32:
    ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, whose fp32 FMAs hold
    the fp32 tolerance that TF32 tensor cores could not)."""
    if q.dtype not in _ROUTES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    return _ROUTES[q.dtype]


def _check_sm90_alignment(*xs) -> None:
    """The sm90 kernels copy 16-byte chunks with cp.async and store
    bf16 pairs: every base pointer must be 16-byte aligned and every
    (b, t, h) stride a multiple of 8 elements. Raises, never falls back."""
    for x in xs:
        if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(
                f"the sm90 flash kernels need 16-byte aligned tensors with "
                f"(b, t, h) strides in multiples of 8 elements, got "
                f"data_ptr % 16 = {x.data_ptr() % 16}, strides "
                f"{tuple(x.stride())}")


def _launch(lib: str, q, fn, *args) -> None:
    """Call a kernel's C entry point on q's current stream; raise on a
    failed launch."""
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{lib} kernel launch failed: "
                           f"{_kernel_error(lib, err)} (cudaError {err})")


def _launch_flash_fwd(q, k, v, causal: bool, sm_scale: float):
    """Launch K1 on the route of q's dtype, on q's current stream;
    ``(out, lse)``."""
    _check_kernel_inputs(q, k, v)
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T, 1), dtype=torch.float32, device=q.device)
    route = _route(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, T, H, D,
            *(st for x in (q, k, v, out) for st in x.stride()[:3]),
            float(sm_scale), int(causal)]
    if route == "sm90":
        _check_sm90_alignment(q, k, v, out)
        name = "flash_fwd_sm90"
    else:
        name = "flash_fwd"
        args.append(_KERNEL_DTYPES[q.dtype])
    lib = _FWD_LIBS[route]
    _launch(lib, q, _kernel_fn(lib, name), *args)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out, lse


def _in_strides(*xs):
    """The (b, t, h) strides of q, k, v and dO as the backward kernels
    take them: one array of 12 int64."""
    return (_L * 12)(*(st for x in xs for st in x.stride()[:3]))


def _launch_bwd(kernel: str, ins, outs, lse, delta, causal,
                sm_scale) -> str:
    """Launch K2 (``kernel="dkv"``) or K3 (``"dq"``) on the route of q's
    dtype, on q's current stream; returns the route. ``ins`` is
    (q, k, v, dO), ``outs`` (dk, dv) or (dq,)."""
    q = ins[0]
    B, T, H, D = q.shape
    route = _route(q)
    args = [*(x.data_ptr() for x in ins), lse.data_ptr(), delta.data_ptr(),
            *(x.data_ptr() for x in outs), B, T, H, D, _in_strides(*ins),
            *(st for x in outs for st in x.stride()[:3]), float(sm_scale),
            int(causal)]
    if route == "sm90":
        _check_sm90_alignment(*ins, *outs)
        name = f"flash_bwd_{kernel}_sm90"
    else:
        name = f"flash_bwd_{kernel}"
        args.append(_KERNEL_DTYPES[q.dtype])
    lib = _BWD_LIBS[route]
    _launch(lib, q, _kernel_fn(lib, name), *args)
    return route


def _launch_flash_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale):
    """Launch K2 on q's current stream; ``(dk, dv)``."""
    _check_kernel_inputs(q, k, v, do)
    _check_rows(q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    route = _launch_bwd("dkv", (q, k, v, do), (dk, dv), lse, delta, causal,
                        sm_scale)
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.launches_by_route[route] += 1
    return dk, dv


def _launch_flash_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale):
    """Launch K3 on q's current stream; dq."""
    _check_kernel_inputs(q, k, v, do)
    _check_rows(q, lse, delta)
    dq = torch.empty_like(q)
    route = _launch_bwd("dq", (q, k, v, do), (dq,), lse, delta, causal,
                        sm_scale)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.launches_by_route[route] += 1
    return dq


def _no_grad_needed(name: str, *xs) -> None:
    """The wrappers' outputs carry no autograd history on CUDA: refuse
    inputs that would need one rather than drop the gradient."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            f"{name} is not differentiable on CUDA; call flash_attention, "
            f"whose autograd Function runs K2 and K3 backward")


def flash_forward(q, k, v, *, causal: bool = True,
                  sm_scale: float | None = None):
    """K1's wrapper: ``(out, lse)``. CUDA tensors launch the kernel (or
    raise); CPU tensors take ``flash_attention_reference``."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type != "cuda":
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
    _no_grad_needed("flash_forward", q, k, v)
    return _launch_flash_fwd(q, k, v, causal, sm_scale)


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  sm_scale: float | None = None):
    """K2's wrapper: ``(dk, dv)`` from lse (K1's) and delta
    (``flash_delta``). CUDA tensors launch the kernel (or raise); CPU
    tensors take ``flash_bwd_dkv_reference``."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type != "cuda":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                       causal=causal, sm_scale=sm_scale)
    _no_grad_needed("flash_bwd_dkv", q, k, v, do)
    return _launch_flash_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 sm_scale: float | None = None):
    """K3's wrapper: dq. CUDA tensors launch the kernel (or raise); CPU
    tensors take ``flash_bwd_dq_reference``."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type != "cuda":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                      causal=causal, sm_scale=sm_scale)
    _no_grad_needed("flash_bwd_dq", q, k, v, do)
    return _launch_flash_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale)


class _Flash(torch.autograd.Function):
    """Flash attention with its gradient, the counterpart of JAX's
    ``_flash`` custom_vjp: forward K1, saving (q, k, v, out, lse);
    backward delta, then K2 and K3. On CPU tensors every step takes its
    plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        out, lse = flash_forward(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:   # e.g. the expanded grad of a sum()
            do = do.contiguous()
        delta = flash_delta(out, do)
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def _use_kernel(device_type: str, Tq: int, Tk: int) -> bool:
    """Whether ``flash_attention`` runs the kernels: on CUDA, for
    Tq == Tk, whatever the head_dim (the kernels raise at one they are
    not built for). Decode steps (Tq != Tk) and the CPU go to
    ``attention``, as they do in the reference."""
    return device_type == "cuda" and Tq == Tk


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Blockwise online-softmax attention; the JAX signature.

    CUDA with Tq == Tk: ``_Flash`` (K1 forward; K2 and K3 backward when
    an input requires grad), at any T and any head_dim in
    ``_KERNEL_HEAD_DIMS`` (another raises). CUDA with Tq != Tk (decode),
    and every CPU call: ``attention`` under torch autograd, as the JAX
    function does off-TPU. ``block_q``/``block_k`` are kept for signature parity: the
    CUDA kernels tile at 64 x 64 whatever they say.
    """
    del block_q, block_k
    sm_scale = _scale(q, sm_scale)
    if not _use_kernel(q.device.type, q.shape[1], k.shape[1]):
        return attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return _Flash.apply(q, k, v, causal, sm_scale)


flash_attention.launches = 0   # K1 launches since the last reset
flash_attention.launches_by_route = {"sm90": 0, "scalar": 0}  # K1, by route
flash_bwd_dkv.launches = 0     # K2 launches since the last reset
flash_bwd_dq.launches = 0      # K3 launches since the last reset
flash_bwd_dkv.launches_by_route = {"sm90": 0, "scalar": 0}   # K2, by route
flash_bwd_dq.launches_by_route = {"sm90": 0, "scalar": 0}    # K3, by route
