"""Wrappers of the hand-written codec kernels, which replace the two of
``repro/kernels/codec_ops.py``:

* ``int8_roundtrip_leaves`` (``csrc/codec_ops.cu``): every leaf of one
  payload in one launch pair, per-leaf maxima then the scale and
  ``clip(floor(x/s) + (u < x/s - floor(x/s)), -127, 127) * s`` elementwise,
  with the uniforms ``u`` drawn by the caller (``ops.int8_roundtrip_leaves``),
  bit-identical to ``ref.int8_scale`` and ``ref.int8_roundtrip_ref``;
* ``topk_select`` (``csrc/topk.cu``): the bucketed threshold select,
  bit-identical to ``ref.topk_select_ref``, in one cluster launch for n up
  to the cluster's shared memory (``topk_select_cluster``) and in four
  launches (histogram, threshold, per-tile tie counts with their scan,
  select) above it (``topk_select_tiles``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset (chip_smoke.py reads them)
LAUNCHES = 0               # int8 launch pairs (one a payload of <= 64 leaves)
TOPK_LAUNCHES = 0          # topk_select calls, either path
TOPK_CLUSTER_LAUNCHES = 0  # of which the one-launch cluster path

INT8_BLOCK = 2048       # elements a block (kBlockElems in csrc/codec_ops.cu)
INT8_MAX_LEAVES = 64    # leaves a launch pair takes (kMaxLeaves)
TOPK_HEADER = 512 + 3  # histogram, t, need, ticket (kHeader in csrc/topk.cu)
TOPK_TILE = 4096       # elements per select tile (kTile in csrc/topk.cu)

_P, _I, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {"int8_roundtrip_leaves": (_P, _P, _P, _P, _P, _C, _P, _P, _P)}
_TOPK_SIGNATURES = {"topk_select": (_P, _P, _I, _I, _P, _I, _P),
                    "topk_select_cluster": (_P, _P, _I, _I, _C, _P),
                    "topk_cluster_shape": (_C, _P, _P)}
# (device index, requested cluster size) -> (cluster size, capacity)
_CLUSTER_SHAPES: dict[tuple[int, int], tuple[int, int]] = {}


def int8_leaf_table(sizes) -> list[int]:
    """Each leaf's first block, then the grid: ``ceil(size / INT8_BLOCK)``
    blocks a leaf, in leaf order."""
    first = [0]
    for n in sizes:
        first.append(first[-1] + -(-int(n) // INT8_BLOCK))
    return first


def int8_roundtrip_leaves(xs, us) -> tuple[list[torch.Tensor], torch.Tensor]:
    """xs, us: leaves of one payload, contiguous f32 CUDA tensors of at
    least one element on one device, each u shaped like its x.  -> (the
    round-tripped leaves, shaped like xs; the (len(xs),) f32 scales).  One
    launch pair a group of up to ``INT8_MAX_LEAVES`` leaves; nothing is
    synced to the host."""
    global LAUNCHES
    xs, us = list(xs), list(us)
    if not xs or len(us) != len(xs):
        raise ValueError("int8_roundtrip kernel needs one u a leaf, and at "
                         "least one leaf")
    dev = xs[0].device
    if not xs[0].is_cuda:
        raise ValueError("int8_roundtrip kernel needs CUDA tensors")
    for i, (x, u) in enumerate(zip(xs, us)):
        for name, t in (("x", x), ("u", u)):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"int8_roundtrip kernel needs {name} of leaf "
                                 f"{i} contiguous f32")
        if x.device != dev or u.device != dev or u.shape != x.shape:
            raise ValueError(f"int8_roundtrip kernel needs leaf {i}'s u shaped "
                             "like x, all on one device")
        if x.numel() == 0:
            raise ValueError(f"int8_roundtrip kernel needs leaf {i} non-empty")
    sizes = [x.numel() for x in xs]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    outs, at = [], 0
    for x, n in zip(xs, sizes):
        outs.append(flat[at:at + n].view(x.shape))
        at += n
    scales = torch.empty(len(xs), dtype=torch.float32, device=dev)
    lib = _build.load("codec_ops", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for g in range(0, len(xs), INT8_MAX_LEAVES):
            group = range(g, min(len(xs), g + INT8_MAX_LEAVES))
            first = int8_leaf_table(sizes[i] for i in group)
            partial = torch.empty(first[-1], dtype=torch.int32, device=dev)
            table = [(ctypes.c_int64 * len(group))(*vals) for vals in (
                [xs[i].data_ptr() for i in group],
                [us[i].data_ptr() for i in group],
                [outs[i].data_ptr() for i in group],
                [sizes[i] for i in group])]
            rc = lib.int8_roundtrip_leaves(
                *table, (ctypes.c_int * len(first))(*first), len(group),
                partial.data_ptr(), scales[g:].data_ptr(), stream)
            _build.check(rc, "int8_roundtrip_leaves")
            LAUNCHES += 1
    return outs, scales


def topk_scratch_len(n: int) -> int:
    """int32 scratch of one four-launch call: the header plus a count and
    an offset per tile."""
    return TOPK_HEADER + 2 * (-(-n // TOPK_TILE))


def cluster_shape(device, cluster: int = 0) -> tuple[int, int]:
    """-> (cluster size, capacity) of the one-launch path on ``device``:
    ``cluster`` blocks (0: 16 where the card can place such a cluster at
    full shared memory, else 8), and the largest n it takes (0 if the card
    places neither)."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, int(cluster))
    if key not in _CLUSTER_SHAPES:
        lib = _build.load("topk", _TOPK_SIGNATURES)
        c, cap = ctypes.c_int(), ctypes.c_int64()
        with torch.cuda.device(index):
            rc = lib.topk_cluster_shape(int(cluster), ctypes.byref(c),
                                        ctypes.byref(cap))
        _build.check(rc, "topk_cluster_shape")
        _CLUSTER_SHAPES[key] = (c.value, cap.value)
    return _CLUSTER_SHAPES[key]


def _check_select(flat: torch.Tensor, k: int) -> int:
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
    return k


def topk_select(flat: torch.Tensor, k: int) -> torch.Tensor:
    """flat: contiguous 1-D f32 CUDA of n >= 1 elements; k: a host int in
    [0, n].  Zeroes all but k entries (see ``ref.topk_select_ref``).  The
    path is chosen by n alone: one cluster launch up to the capacity of
    ``cluster_shape``, four launches above it.  The threshold never
    leaves the device."""
    k = _check_select(flat, k)
    cluster, capacity = cluster_shape(flat.device)
    if flat.numel() <= capacity:
        return topk_select_cluster(flat, k, cluster)
    return topk_select_tiles(flat, k)


def topk_select_cluster(flat: torch.Tensor, k: int,
                        cluster: int) -> torch.Tensor:
    """The one-launch path, with ``cluster`` blocks (8 or 16); n must be
    within ``cluster_shape(flat.device, cluster)``'s capacity."""
    global TOPK_LAUNCHES, TOPK_CLUSTER_LAUNCHES
    k = _check_select(flat, k)
    placed, capacity = cluster_shape(flat.device, cluster)
    if placed != cluster or flat.numel() > capacity:
        raise ValueError(f"topk_select cluster path: n = {flat.numel()} does "
                         f"not fit a cluster of {cluster} on this card "
                         f"(capacity {capacity})")
    out = torch.empty_like(flat)
    lib = _build.load("topk", _TOPK_SIGNATURES)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.topk_select_cluster(flat.data_ptr(), out.data_ptr(),
                                     flat.numel(), k, cluster, stream)
    _build.check(rc, "topk_select_cluster")
    TOPK_LAUNCHES += 1
    TOPK_CLUSTER_LAUNCHES += 1
    return out


def topk_select_tiles(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The four-launch path, for any n (a memset and four launches, with an
    int32 scratch buffer)."""
    global TOPK_LAUNCHES
    k = _check_select(flat, k)
    n = flat.numel()
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
