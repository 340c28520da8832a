"""Wrapper of the hand-written flash-attention kernels
(``csrc/flash_attention.cu``; replace
``repro/kernels/flash_attention.py:flash_attention``).

Blocked online-softmax attention with GQA, causal masking and an optional
sliding window, over q ``(B, H, S, hd)`` and k, v ``(B, KV, S, hd)`` in f32
or bf16, f32 softmax and accumulation, the output in q's dtype: the
function of ``ref.flash_attention_ref``.  bf16 runs the tensor-core kernel
(``wgmma`` on TMA-fed tiles, P split hi/lo), f32 the SIMT kernel (f32 FMAs).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0     # launches of either kernel since the last reset
TC_LAUNCHES = 0  # of which the bf16 tensor-core kernel's (chip_smoke.py reads both)

HEAD_DIMS = (32, 64, 80, 128)  # the kernel's instantiations (csrc dispatch)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, ctypes.c_float, _P)
_SIGNATURES = {"flash_attention_f32": _ARGS, "flash_attention_bf16": _ARGS}
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def _check_layout(name: str, t: torch.Tensor) -> None:
    """Both kernels read each (batch, head, row) of hd contiguous elements,
    the f32 kernel with 16-byte loads, the bf16 kernel by TMA (whose maps
    need a 16-byte aligned base and strides that are multiples of 16
    bytes): stride 1 on hd, and every other stride and the base address on
    16-byte boundaries."""
    elt = t.element_size()
    if (t.stride(3) != 1 or t.data_ptr() % 16
            or any(t.stride(i) * elt % 16 for i in range(3))):
        raise ValueError(
            f"flash_attention kernel: {name} has a layout it does not take "
            f"(strides {t.stride()}, {elt}-byte elements): hd must be "
            f"contiguous and rows 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd), CUDA, f32 or bf16, one
    dtype -> (B, H, S, hd) in q's dtype and memory layout.  Views with
    strides (e.g. a ``(B, S, H, hd)`` tensor transposed) are read in place."""
    global LAUNCHES, TC_LAUNCHES
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _check_layout("out", out)
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (q, k, v, out)
                                       for i in range(3)))
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, S, hd, strides, int(bool(causal)), int(window),
            hd ** -0.5, stream)
    _build.check(rc, "flash_attention")
    LAUNCHES += 1
    if q.dtype == torch.bfloat16:
        TC_LAUNCHES += 1
    return out
