"""Wrapper of the hand-written flash-attention kernels
(``csrc/flash_attention.cu``; replace
``repro/kernels/flash_attention.py:flash_attention``).

Blocked online-softmax attention with GQA, causal masking and an optional
sliding window, over q ``(B, H, S, hd)`` and k, v ``(B, KV, S, hd)`` in f32
or bf16, f32 softmax and accumulation, the output in q's dtype: the
function of ``ref.flash_attention_ref``.  bf16 runs the tensor-core kernel
(``wgmma`` on TMA-fed tiles, P split hi/lo), f32 the SIMT kernel (f32 FMAs).

Under autograd (grad mode on and q, k or v requiring grad) the bf16 kernel
runs through ``_FlashAttention``: its forward also keeps the f32 output and
the rows' log-sum-exp, and its backward is the hand-written bf16 backward
(dQ, then dK and dV; no TPU kernel had one).  The backward takes what
``backward_takes`` accepts; other inputs under autograd raise, so no result
is ever cut from the graph.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0     # launches of either forward kernel since the last reset
TC_LAUNCHES = 0  # of which the bf16 tensor-core kernel's (chip_smoke.py reads both)
BWD_CALLS = 0    # calls of the bf16 backward, two launches each (dQ, then dK/dV)

HEAD_DIMS = (32, 64, 80, 128)  # every kernel's instantiations, the backward's too
ROW_PAD = 128  # lse and D rows are padded to whole q tiles (csrc tc::kBM, kBwdBlk)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, ctypes.c_float, _P)
_SIGNATURES = {
    "flash_attention_f32": _ARGS, "flash_attention_bf16": _ARGS,
    "flash_attention_bf16_fwd": (_P,) * 6 + _ARGS[4:],
    "flash_attention_bf16_bwd": (_P,) * 10 + _ARGS[4:]}
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def _layout_ok(strides: tuple[int, ...], ptr: int, elt: int) -> bool:
    """Both kernels read each (batch, head, row) of hd contiguous elements,
    the f32 kernel with 16-byte loads, the bf16 kernels by TMA (whose maps
    need a 16-byte aligned base and strides that are multiples of 16
    bytes): stride 1 on hd, and every other stride and the base address on
    16-byte boundaries."""
    return (strides[3] == 1 and ptr % 16 == 0
            and all(st * elt % 16 == 0 for st in strides[:3]))


def _check_layout(name: str, t: torch.Tensor) -> None:
    elt = t.element_size()
    if not _layout_ok(t.stride(), t.data_ptr(), elt):
        raise ValueError(
            f"flash_attention kernel: {name} has a layout it does not take "
            f"(strides {t.stride()}, {elt}-byte elements): hd must be "
            f"contiguous and rows 16-byte aligned")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    tensors = {"q": q, "k": k, "v": v}
    if not all(t.is_cuda for t in tensors.values()):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes f32 or bf16 of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device == v.device):
        raise ValueError("flash_attention kernel: q, k, v on other devices")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel needs q (B,H,S,hd) and k, v "
                         f"(B,KV,S,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if k.shape != (B, KV, S, hd) or KV == 0 or H % KV:
        raise ValueError(f"flash_attention kernel: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (H % KV must be 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if window < 0:
        raise ValueError(f"flash_attention kernel: window {window} < 0")
    for name, t in tensors.items():
        _check_layout(name, t)


def backward_takes(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the hand-written backward takes inputs of this dtype (q, k
    and v share one) and head dim, on a CUDA device: bf16 and a head dim
    in ``HEAD_DIMS``."""
    return dtype == torch.bfloat16 and head_dim in HEAD_DIMS


def _strides(*ts: torch.Tensor):
    return (ctypes.c_int64 * (3 * len(ts)))(*(t.stride(i) for t in ts
                                             for i in range(3)))


def _launch(entry: str, q: torch.Tensor, *args) -> None:
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    _build.check(rc, entry)


def _forward(q, k, v, causal: bool, window: int, save: bool):
    """One forward launch -> out, and with ``save`` also (o32, lse): the f32
    output before its rounding, in out's layout, and the (B, H, S padded to
    ``ROW_PAD``) f32 log-sum-exp of the rows' scaled scores."""
    global LAUNCHES, TC_LAUNCHES
    B, H, S, hd = q.shape
    out = torch.empty_like(q)
    o32 = lse = None
    if save:
        o32 = torch.empty_like(q, dtype=torch.float32)
        lse = torch.empty((B, H, -(-S // ROW_PAD) * ROW_PAD),
                          dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, o32, lse
    _check_layout("out", out)
    scalars = (B, H, k.shape[1], S, hd)
    flags = (int(bool(causal)), int(window), hd ** -0.5)
    if save:
        _launch("flash_attention_bf16_fwd", q, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), o32.data_ptr(), lse.data_ptr(),
                *scalars, _strides(q, k, v, out, o32), *flags)
    else:
        _launch(_ENTRY[q.dtype], q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), *scalars, _strides(q, k, v, out), *flags)
    LAUNCHES += 1
    if q.dtype == torch.bfloat16:
        TC_LAUNCHES += 1
    return out, o32, lse


def flash_attention_backward(q, k, v, o32, lse, dout, causal: bool = True,
                             window: int = 0):
    """dq, dk, dv (bf16, in q's, k's and v's layouts) of the bf16 kernel's
    attention, from the inputs, the forward's ``o32`` and ``lse``
    (``_forward(..., save=True)``) and the output's gradient ``dout``: two
    launches, dQ (with D = rowsum(dout o o32)), then dK and dV."""
    global BWD_CALLS
    B, H, S, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    dout = dout.to(torch.bfloat16)
    if not _layout_ok(dout.stride(), dout.data_ptr(), 2):
        dout = dout.contiguous()
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        _check_layout(name, t)
    dsum = torch.empty_like(lse)
    _launch("flash_attention_bf16_bwd", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o32.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, k.shape[1], S, hd, _strides(q, k, v, o32, dout, dq, dk, dv),
            int(bool(causal)), int(window), hd ** -0.5)
    BWD_CALLS += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The bf16 kernel under autograd: the forward keeps q, k, v, the f32
    output and the log-sum-exp; the backward is the hand-written one, once
    differentiable (a double backward raises)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, o32, lse = _forward(q, k, v, causal, window, save=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o32, lse, dout,
                                              ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd), CUDA, f32 or bf16, one
    dtype -> (B, H, S, hd) in q's dtype and memory layout.  Views with
    strides (e.g. a ``(B, S, H, hd)`` tensor transposed) are read in place.
    With grad mode on and q, k or v requiring grad the result carries the
    kernel's backward; inputs the backward does not take
    (``backward_takes``) then raise."""
    _check(q, k, v, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if not backward_takes(q.dtype, q.shape[-1]):
            raise RuntimeError(
                f"flash_attention kernel: no backward for {q.dtype} with "
                f"head_dim {q.shape[-1]} (it takes bf16 with head_dim in "
                f"{HEAD_DIMS}); q, k or v requires grad")
        return _FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window, save=False)[0]
