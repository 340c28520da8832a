"""Wrapper of the hand-written VL-BFGS Gram kernel (``csrc/vlbfgs.cu``;
replaces ``repro/kernels/vlbfgs.py:gram``).

Computes the (n, n) f32 Gram matrix ``B·Bᵀ`` of the basis
``[s_0..s_{m-1}, y_0..y_{m-1}, g]`` in one read of the basis: stage 1
splits D over blocks that each write an upper-triangle partial, stage 2
sums each pair's partials in a fixed order (deterministic, no atomics).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)

MAX_N = 64          # must match GRAM_MAX_N in csrc/vlbfgs.cu
TILE = 64           # must match GRAM_TILE in csrc/vlbfgs.cu
BLOCKS_PER_SM = 4   # stage-1 blocks aimed at per SM (enough loads in flight)

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {"vlbfgs_gram": (_P, _P, _P, _I, _I, _I, _I, _P)}


def split(D: int, n_sm: int) -> tuple[int, int]:
    """-> (chunk, blocks): stage-1 D chunk (a multiple of TILE) and block
    count, at least ``n_sm`` blocks wherever D has that many tiles."""
    tiles = max(1, -(-D // TILE))
    per_block = max(1, tiles // (BLOCKS_PER_SM * n_sm))
    blocks = -(-tiles // per_block)
    return per_block * TILE, blocks


def gram(basis: torch.Tensor) -> torch.Tensor:
    """basis: (n, D) contiguous f32 CUDA, n <= 64 -> (n, n) f32."""
    global LAUNCHES
    if not basis.is_cuda:
        raise ValueError("vlbfgs gram kernel needs a CUDA tensor")
    if (basis.dtype != torch.float32 or basis.dim() != 2
            or not basis.is_contiguous()):
        raise ValueError("vlbfgs gram kernel needs a contiguous (n, D) f32 "
                         "tensor")
    n, D = basis.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"vlbfgs gram kernel takes 1 <= n <= {MAX_N} rows, "
                         f"got {n}")
    n_sm = torch.cuda.get_device_properties(basis.device).multi_processor_count
    chunk, blocks = split(D, n_sm)
    npairs = n * (n + 1) // 2
    partial = torch.empty((npairs, blocks), dtype=torch.float32,
                          device=basis.device)
    out = torch.empty((n, n), dtype=torch.float32, device=basis.device)
    lib = _build.load("vlbfgs", _SIGNATURES)
    with torch.cuda.device(basis.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vlbfgs_gram(basis.data_ptr(), partial.data_ptr(),
                             out.data_ptr(), n, D, chunk, blocks, stream)
    _build.check(rc, "vlbfgs_gram")
    LAUNCHES += 1
    return out
