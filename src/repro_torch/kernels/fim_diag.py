"""Wrapper of the hand-written fused diagonal-Fisher kernel
(``csrc/fim_diag.cu``; replaces ``repro/kernels/fim_diag.py:fim_diag``).

Computes ``ema*old + (1-ema) * mean_b g[b, :]**2`` over a (B, D)
per-example-gradient matrix in one read of ``g``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "fim_diag_f32": (_P, _P, _P, _I, _I, ctypes.c_float, _P),
    "fim_diag_bf16": (_P, _P, _P, _I, _I, ctypes.c_float, _P),
}
_ENTRY = {torch.float32: "fim_diag_f32", torch.bfloat16: "fim_diag_bf16"}


def fim_diag(grads: torch.Tensor, old_diag: torch.Tensor,
             ema: float) -> torch.Tensor:
    """grads: (B, D) f32/bf16 CUDA; old_diag: (D,) f32 -> (D,) f32."""
    global LAUNCHES
    if not grads.is_cuda:
        raise ValueError("fim_diag kernel needs a CUDA tensor")
    if grads.dtype not in _ENTRY:
        raise ValueError(f"fim_diag kernel takes f32 or bf16, got {grads.dtype}")
    if grads.dim() != 2 or not grads.is_contiguous():
        raise ValueError("fim_diag kernel needs a contiguous (B, D) tensor")
    B, D = grads.shape
    if (old_diag.shape != (D,) or old_diag.dtype != torch.float32
            or old_diag.device != grads.device
            or not old_diag.is_contiguous()):
        raise ValueError("fim_diag kernel needs old_diag: contiguous (D,) f32 "
                         "on grads' device")
    out = torch.empty((D,), dtype=torch.float32, device=grads.device)
    if D == 0:
        return out
    lib = _build.load("fim_diag", _SIGNATURES)
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, _ENTRY[grads.dtype])(
            grads.data_ptr(), old_diag.data_ptr(), out.data_ptr(), B, D,
            float(ema), stream)
    _build.check(rc, "fim_diag")
    LAUNCHES += 1
    return out
