"""Wrapper of the hand-written int8 round-trip kernel
(``csrc/codec_ops.cu``; replaces ``repro/kernels/codec_ops.py:
int8_roundtrip``).

``clip(floor(x/s) + (u < x/s - floor(x/s)), -127, 127) * s`` elementwise,
with the uniforms ``u`` and the scale ``s`` computed by the caller
(``ops.int8_roundtrip``), so the kernel is bit-identical to
``ref.int8_roundtrip_ref``.  The reference's ``topk_select`` is not
ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {"int8_roundtrip": (_P, _P, _P, _P, _I, _P)}


def int8_roundtrip(x: torch.Tensor, u: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x, u: contiguous f32 CUDA of one shape; scale: 0-d f32 on the same
    device (read by the kernel, never synced to the host)."""
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError("int8_roundtrip kernel needs a CUDA tensor")
    for name, t in (("x", x), ("u", u)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"int8_roundtrip kernel needs {name} contiguous "
                             "f32")
    if u.shape != x.shape or u.device != x.device:
        raise ValueError("int8_roundtrip kernel needs u shaped like x on its "
                         "device")
    if (scale.numel() != 1 or scale.dtype != torch.float32
            or scale.device != x.device):
        raise ValueError("int8_roundtrip kernel needs a one-element f32 scale "
                         "on x's device")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    scale = scale.contiguous()
    lib = _build.load("codec_ops", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.int8_roundtrip(x.data_ptr(), u.data_ptr(), scale.data_ptr(),
                                out.data_ptr(), x.numel(), stream)
    _build.check(rc, "int8_roundtrip")
    LAUNCHES += 1
    return out
