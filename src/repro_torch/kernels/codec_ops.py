"""Wrappers of the hand-written codec kernels, which replace the two of
``repro/kernels/codec_ops.py``:

* ``int8_roundtrip`` (``csrc/codec_ops.cu``):
  ``clip(floor(x/s) + (u < x/s - floor(x/s)), -127, 127) * s`` elementwise,
  with the uniforms ``u`` and the scale ``s`` computed by the caller
  (``ops.int8_roundtrip``), so the kernel is bit-identical to
  ``ref.int8_roundtrip_ref``;
* ``topk_select`` (``csrc/topk.cu``): the bucketed threshold select, four
  launches (histogram, threshold, per-tile tie counts with their scan,
  select) with the threshold kept on the device, bit-identical to
  ``ref.topk_select_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset (chip_smoke.py reads them)
LAUNCHES = 0        # int8_roundtrip
TOPK_LAUNCHES = 0   # topk_select

TOPK_HEADER = 512 + 3  # histogram, t, need, ticket (kHeader in csrc/topk.cu)
TOPK_TILE = 4096       # elements per select tile (kTile in csrc/topk.cu)

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {"int8_roundtrip": (_P, _P, _P, _P, _I, _P)}
_TOPK_SIGNATURES = {"topk_select": (_P, _P, _I, _I, _P, _I, _P)}


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


def topk_scratch_len(n: int) -> int:
    """int32 scratch of one call: the header plus a count and an offset
    per tile."""
    return TOPK_HEADER + 2 * (-(-n // TOPK_TILE))


def topk_select(flat: torch.Tensor, k: int) -> torch.Tensor:
    """flat: contiguous 1-D f32 CUDA of n >= 1 elements; k: a host int in
    [0, n].  Zeroes all but k entries (see ``ref.topk_select_ref``).  The
    threshold never leaves the device."""
    global TOPK_LAUNCHES
    if not flat.is_cuda:
        raise ValueError("topk_select kernel needs a CUDA tensor")
    if (flat.dtype != torch.float32 or flat.dim() != 1
            or not flat.is_contiguous()):
        raise ValueError("topk_select kernel needs a contiguous 1-D f32 "
                         "tensor")
    n = flat.numel()
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"topk_select kernel takes 1 <= n < 2**31 elements, "
                         f"got {n}")
    k = int(k)
    if not 0 <= k <= n:
        raise ValueError(f"topk_select kernel needs 0 <= k <= n = {n}, "
                         f"got {k}")
    out = torch.empty_like(flat)
    scratch = torch.empty(topk_scratch_len(n), dtype=torch.int32,
                          device=flat.device)
    lib = _build.load("topk", _TOPK_SIGNATURES)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.topk_select(flat.data_ptr(), out.data_ptr(), n, k,
                             scratch.data_ptr(), scratch.numel(), stream)
    _build.check(rc, "topk_select")
    TOPK_LAUNCHES += 1
    return out
