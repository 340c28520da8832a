"""Wrapper of the hand-written VL-BFGS Gram kernel (``csrc/vlbfgs.cu``;
replaces ``repro/kernels/vlbfgs.py:gram``).

Computes the (n, n) f32 Gram matrix ``B·Bᵀ`` of the basis
``[s_0..s_{m-1}, y_0..y_{m-1}, g]`` in one launch and one read of each
basis element, straight from the leaves of the history (``gram_leaves``):
blocks over column chunks of the leaves write upper-triangle partials and
the last blocks to finish sum them in a fixed order (deterministic, no
atomics on values).  Each row group (s, y, g) is f32 or bf16, read where
it lies and widened to f32 in the kernel (an LLM's bf16 history is never
copied to f32).  ``gram(basis)`` is the same kernel over a table that
points into one (n, D) basis.
"""
from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from repro_torch.kernels import _build

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py reads it)

MAX_N = 64          # rows the kernel takes (kMaxN in csrc/vlbfgs.cu)
MAX_LEAVES = 64     # leaves a launch takes (kMaxLeaves)
MAX_THREADS = 384   # threads a block (kMaxThreads)
STAGES = 4          # slabs in shared memory (kStages)
TILE_EDGE = 8       # a thread's register tile is 8 x 8 pairs (kT)
RANGE = 16          # partials a reducer loads at once a pair (kRange)
REDUCERS = 8        # the last blocks to arrive, which sum the partials (kReducers)
SLAB_QUADS = 64     # 4-column quads of a slab the host aims at (256 columns)
STAGE_BYTES = 200 * 1024  # shared memory the stages may take
BLOCKS_PER_SM = 1   # blocks aimed at per SM: few partials for the last block
# columns a block takes at most: a thread sums 4 products of a pair a slab
# into one f32 register, so a chunk of c columns is a chain of 4c / tile
# additions; at 2^16 columns (1,024 at n = 21) its rounding stays near
# 1e-6 of the entry's scale, where a chunk of 6.4 M columns (838.9 M over
# 132 blocks) read 8e-5 on the card.  Longer leaves take more blocks than
# SMs, in waves, and more partials for the reducers
MAX_CHUNK = 1 << 16
MAX_SMEM = 226 * 1024   # dynamic shared memory a block may use (kMaxSmem)

_P, _I, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {"vlbfgs_gram_leaves": (_P, _P, _P, _C, _P, _P, _C, _C, _I, _P,
                                      _P, _P, _P)}
DTYPES = (torch.float32, torch.bfloat16)   # what a row group may hold
_TICKETS: dict[tuple[torch.device, int], torch.Tensor] = {}


def tile_shape(n: int) -> tuple[int, int, int]:
    """-> (tiles, lanes, tile) for n basis rows: the 8 x 8 register tiles
    of the upper triangle of the (n rounded up to 8)² pair space, the
    threads sharing a tile (a multiple of 8, so a quarter-warp reads 8
    neighbouring quads of one row), and the slab's columns,
    4 · lanes · (quads a lane), as many as STAGE_BYTES allow."""
    rows = -(-n // TILE_EDGE) * TILE_EDGE
    r = rows // TILE_EDGE
    tiles = r * (r + 1) // 2
    lanes = min(128, 8 * max(1, MAX_THREADS // (8 * tiles)))
    quads = max(1, SLAB_QUADS // lanes)
    while quads > 1 and STAGES * rows * (4 * lanes * quads + 4) * 4 > STAGE_BYTES:
        quads //= 2
    return tiles, lanes, 4 * lanes * quads


def leaf_plan(n: int, cols, n_sm: int,
              quantum: int = 4) -> tuple[int, int, int, list[int]]:
    """-> (lanes, tile, chunk, first) of one launch over leaves of ``cols``
    columns (each >= 1): ``chunk``, a multiple of ``quantum`` columns (4 for
    f32 rows, 8 where a group is bf16, so every slab of a row keeps the
    row's 16-byte alignment), is the least that gives at most
    ``BLOCKS_PER_SM`` blocks an SM over all leaves (a block a leaf where
    there are more leaves), but no more than ``MAX_CHUNK`` where the
    reducers can take the blocks that makes; ``first`` each leaf's first
    block, then the grid."""
    _, lanes, tile = tile_shape(n)
    cols = [int(c) for c in cols]
    chunk = _least_chunk(cols, max(BLOCKS_PER_SM * n_sm, len(cols)), quantum)
    if chunk > MAX_CHUNK:
        # cut to MAX_CHUNK columns, as far as the reducers' shared memory
        # (a range sum per RANGE blocks and pair) holds the partials
        pairs = -(-n * (n + 1) // 2 // REDUCERS)
        most = RANGE * (MAX_SMEM // (4 * pairs))
        chunk = max(MAX_CHUNK, _least_chunk(cols, most, quantum))
    first = [0]
    for c in cols:
        first.append(first[-1] + -(-c // chunk))
    return lanes, tile, chunk, first


def _least_chunk(cols: list[int], blocks: int, quantum: int) -> int:
    """The least multiple of ``quantum`` columns that cuts ``cols`` into at
    most ``blocks`` blocks (one where that cannot be)."""
    lo, hi = 1, -(-max(cols) // quantum)    # chunk / quantum
    while lo < hi:
        mid = (lo + hi) // 2
        if sum(-(-c // (quantum * mid)) for c in cols) <= blocks:
            hi = mid
        else:
            lo = mid + 1
    return quantum * lo


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The two counters (blocks arrived, reducers done) of launches on one
    stream of a device: zero before and after each launch (the last reducer
    resets them).  Launches on one stream run one after another, so a
    stream's counters serve one launch at a time; launches on two streams
    may overlap and get two pairs."""
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return t


def _launch(rows: list[tuple[int, int, int]], cols: list[int],
            count: tuple[int, int, int], half: tuple[int, int, int],
            device: torch.device) -> torch.Tensor:
    """(n, n) Gram of leaves whose 3 row groups start at ``rows`` (a
    (s, y, g) address triple a leaf, 0 for an empty group) with
    ``count`` rows each, bf16 where ``half`` (3 flags) says so and f32
    elsewhere, and ``cols`` columns a leaf (all >= 1); one launch a group
    of up to ``MAX_LEAVES`` leaves, summed in group order."""
    global LAUNCHES
    n = sum(count)
    lib = _build.load("vlbfgs", _SIGNATURES)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    total = None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for at in range(0, len(cols), MAX_LEAVES):
            part_cols = cols[at:at + MAX_LEAVES]
            lanes, tile, chunk, first = leaf_plan(n, part_cols, n_sm,
                                                  8 if any(half) else 4)
            partial = torch.empty((first[-1], n * (n + 1) // 2),
                                  dtype=torch.float32, device=device)
            out = torch.empty((n, n), dtype=torch.float32, device=device)
            addrs = [a for leaf in rows[at:at + MAX_LEAVES] for a in leaf]
            rc = lib.vlbfgs_gram_leaves(
                (ctypes.c_int64 * len(addrs))(*addrs),
                (ctypes.c_int64 * len(part_cols))(*part_cols),
                (ctypes.c_int * len(first))(*first), len(part_cols),
                (ctypes.c_int * 3)(*count), (ctypes.c_int * 3)(*half),
                lanes, tile, chunk,
                partial.data_ptr(), _ticket(device, stream).data_ptr(),
                out.data_ptr(), stream)
            _build.check(rc, "vlbfgs_gram_leaves")
            LAUNCHES += 1
            total = out if total is None else total + out
    return total


def gram_leaves(s_leaves: Sequence[torch.Tensor],
                y_leaves: Sequence[torch.Tensor],
                g_leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Gram matrix of ``[s_0..s_{m-1}, y_0..y_{m-1}, g]`` read in place:
    s and y leaves are (m, *shape_i) contiguous CUDA history buffers in
    slot order, g leaves *shape_i contiguous, all on one device,
    2m+1 <= 64; each group's leaves all f32 or all bf16 (a bf16 history
    beside an f32 gradient).  -> (2m+1, 2m+1) f32, one launch (a group of
    up to ``MAX_LEAVES`` non-empty leaves); zeros and no launch when every
    leaf is empty."""
    s_leaves, y_leaves, g_leaves = list(s_leaves), list(y_leaves), list(g_leaves)
    if not g_leaves or not len(s_leaves) == len(y_leaves) == len(g_leaves):
        raise ValueError("vlbfgs gram kernel needs one s, y and g a leaf, and "
                         "at least one leaf")
    dev = g_leaves[0].device
    if not g_leaves[0].is_cuda:
        raise ValueError("vlbfgs gram kernel needs CUDA tensors")
    m = s_leaves[0].shape[0] if s_leaves[0].dim() else -1
    n = 2 * m + 1
    if not 1 <= n <= MAX_N:
        raise ValueError(f"vlbfgs gram kernel takes 1 <= 2m+1 <= {MAX_N} "
                         f"rows, got m = {m}")
    groups = (s_leaves, y_leaves, g_leaves)
    dtypes = [leaves[0].dtype for leaves in groups]
    rows, cols = [], []
    for i, (s, y, g) in enumerate(zip(*groups)):
        for name, t, shape, dtype in zip("syg", (s, y, g), ((m, *g.shape),
                                                            (m, *g.shape),
                                                            tuple(g.shape)),
                                         dtypes):
            if (dtype not in DTYPES or t.dtype != dtype
                    or not t.is_contiguous() or t.device != dev
                    or tuple(t.shape) != shape):
                raise ValueError(f"vlbfgs gram kernel needs {name} of leaf "
                                 f"{i} a contiguous f32 or bf16 {shape} "
                                 f"tensor on {dev}, of the {name} group's "
                                 f"one dtype")
        if g.numel():
            rows.append((s.data_ptr(), y.data_ptr(), g.data_ptr()))
            cols.append(g.numel())
    if not cols:
        return torch.zeros((n, n), dtype=torch.float32, device=dev)
    half = tuple(int(d == torch.bfloat16) for d in dtypes)
    return _launch(rows, cols, (m, m, 1), half, dev)


def gram(basis: torch.Tensor) -> torch.Tensor:
    """basis: (n, D) contiguous f32 or bf16 CUDA, 1 <= n <= 64 -> (n, n)
    f32: the leaf kernel over a table of one leaf, its n rows one group."""
    if not basis.is_cuda:
        raise ValueError("vlbfgs gram kernel needs a CUDA tensor")
    if (basis.dtype not in DTYPES or basis.dim() != 2
            or not basis.is_contiguous()):
        raise ValueError("vlbfgs gram kernel needs a contiguous (n, D) f32 "
                         "or bf16 tensor")
    n, D = basis.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"vlbfgs gram kernel takes 1 <= n <= {MAX_N} rows, "
                         f"got {n}")
    if D == 0:
        return torch.zeros((n, n), dtype=torch.float32, device=basis.device)
    half = (int(basis.dtype == torch.bfloat16), 0, 0)
    return _launch([(basis.data_ptr(), 0, 0)], [D], (n, 0, 0), half,
                   basis.device)
