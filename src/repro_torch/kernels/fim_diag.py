"""Wrapper of the hand-written fused diagonal-Fisher kernel
(``csrc/fim_diag.cu``; replaces ``repro/kernels/fim_diag.py:fim_diag``).

Computes ``ema*old + (1-ema) * mean_b g[b, :]**2`` for every (B, D_i)
per-example-gradient matrix of a client in one launch and one read of each
``g`` (``fim_diag_leaves``); ``old`` may be left out for zeros.  The
single-matrix ``fim_diag`` is the same kernel over a one-leaf table.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)

THREADS = 256         # threads a block (kThreads in csrc/fim_diag.cu)
MAX_LEAVES = 64       # leaves a launch takes (kMaxLeaves)
MAX_GROUPS = 16       # column groups a block of a wide leaf (16 x 16 bytes)
VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements in 16 bytes

_P, _I, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {"fim_diag_leaves": (_P, _P, _P, _P, _P, _P, _C, _I,
                                   ctypes.c_float, _C, _P)}


def leaf_table(cols, vec: int) -> tuple[list[int], list[int], list[int]]:
    """-> (order, first, shift) of one launch over leaves of ``cols``
    columns (each >= 1): the leaves widest first (stable), so the narrow
    leaves' blocks fill the SMs the wide leaf's last wave leaves idle; each
    leaf's first block in that order, then the grid; and log2 of each
    leaf's column groups (of ``vec`` columns) a block, up to MAX_GROUPS."""
    cols = [int(c) for c in cols]
    order = sorted(range(len(cols)), key=lambda i: -cols[i])
    first, shift = [0], []
    for i in order:
        groups = -(-cols[i] // vec)
        sh = min((groups - 1).bit_length(), MAX_GROUPS.bit_length() - 1)
        shift.append(sh)
        first.append(first[-1] + -(-groups >> sh))
    return order, first, shift


def fim_diag_leaves(grads, olds, ema: float) -> list[torch.Tensor]:
    """grads: (B, D_i) contiguous CUDA tensors of one dtype (f32 or bf16)
    and one B; olds: (D_i,) contiguous f32 tensors on the same device, or
    None for zeros.  -> the (D_i,) f32 results, views of one flat buffer.
    One launch a group of up to ``MAX_LEAVES`` non-empty leaves; none for
    an empty list or empty leaves."""
    global LAUNCHES
    grads = list(grads)
    if not grads:
        return []
    g0 = grads[0]
    if not g0.is_cuda:
        raise ValueError("fim_diag kernel needs CUDA tensors")
    if g0.dtype not in VEC:
        raise ValueError(f"fim_diag kernel takes f32 or bf16, got {g0.dtype}")
    if olds is not None:
        olds = list(olds)
        if len(olds) != len(grads):
            raise ValueError("fim_diag kernel needs one old diagonal a leaf")
    B = g0.shape[0] if g0.dim() == 2 else -1
    for i, g in enumerate(grads):
        if (g.dim() != 2 or g.shape[0] != B or g.dtype != g0.dtype
                or g.device != g0.device or not g.is_contiguous()):
            raise ValueError(f"fim_diag kernel needs leaf {i} a contiguous "
                             f"(B, D) {g0.dtype} tensor of B = {B} on "
                             f"{g0.device}")
        if olds is not None:
            o = olds[i]
            if (o.shape != (g.shape[1],) or o.dtype != torch.float32
                    or o.device != g0.device or not o.is_contiguous()):
                raise ValueError(f"fim_diag kernel needs old diagonal {i}: "
                                 "contiguous (D,) f32 on grads' device")
    cols = [g.shape[1] for g in grads]
    flat = torch.empty(sum(cols), dtype=torch.float32, device=g0.device)
    outs, at = [], 0
    for d in cols:
        outs.append(flat[at:at + d])
        at += d
    live = [i for i, d in enumerate(cols) if d]
    if not live:
        return outs
    lib = _build.load("fim_diag", _SIGNATURES)
    bf16 = int(g0.dtype == torch.bfloat16)
    with torch.cuda.device(g0.device):
        stream = torch.cuda.current_stream().cuda_stream
        for at in range(0, len(live), MAX_LEAVES):
            group = live[at:at + MAX_LEAVES]
            order, first, shift = leaf_table([cols[i] for i in group],
                                             VEC[g0.dtype])
            leaves = [group[k] for k in order]
            table = [(ctypes.c_int64 * len(leaves))(*vals) for vals in (
                [grads[i].data_ptr() for i in leaves],
                [0 if olds is None else olds[i].data_ptr() for i in leaves],
                [outs[i].data_ptr() for i in leaves],
                [cols[i] for i in leaves])]
            rc = lib.fim_diag_leaves(
                *table, (ctypes.c_int * len(first))(*first),
                (ctypes.c_int * len(shift))(*shift), len(leaves), B,
                float(ema), bf16, stream)
            _build.check(rc, "fim_diag_leaves")
            LAUNCHES += 1
    return outs


def fim_diag(grads: torch.Tensor, old_diag: torch.Tensor,
             ema: float) -> torch.Tensor:
    """grads: (B, D) f32/bf16 CUDA; old_diag: (D,) f32 -> (D,) f32: the
    leaf kernel over a one-leaf table."""
    return fim_diag_leaves([grads], [old_diag], ema)[0]
