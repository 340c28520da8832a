"""The codec kernels' decompositions (``csrc/topk.cu``, ``topk_cluster_kernel``;
``csrc/codec_ops.cu``, ``int8_amax`` and ``int8_apply``), emulated in numpy on
the CPU and held bit for bit against the plain versions (``ref.topk_select_ref``,
``ref.int8_scale``, ``ref.int8_roundtrip_ref``), the reference's oracles and,
for the select, the Pallas kernel in interpret mode.

The cluster select does what the kernel does, in its order: C contiguous
chunks of m = ceil(n / C) rounded up to 4 elements; a 512-bucket histogram a
chunk, exchanged so that every block holds all C; each block suffix-scans
their sum for t and need and takes the lower ranks' bucket-t counts as its
tie offset; 32 warp segments a chunk (a multiple of 32 elements each) and the
warps' tie counts; a warp whose ties are all kept or all dropped keeps
bucket >= t or > t, and in the one warp of the cluster that holds the
need-th tie each lane walks a contiguous run of the segment from its first
rank (the warp's exclusive scan of the runs' tie counts).  The
chunk layout (head, bulk-copied pieces, tail) is checked to cover each chunk
with 16-byte aligned pieces at every alignment of x.

The int8 leaf table does what the two launches do: ceil(size / INT8_BLOCK)
blocks a leaf (``codec_ops.int8_leaf_table``), a binary search from a block
to its leaf, per-block maxima of |x| as uint32 bits, per-leaf maxima, the
scale, and the correctly rounded round-trip, at most INT8_MAX_LEAVES leaves
a launch pair.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import codec_ops as rcodec_ops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.configs.paper_models import FMNIST_CNN  # noqa: E402
from repro_torch.kernels import codec_ops, ops, ref  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

BUCKETS, SHIFT = ref.TOPK_BUCKETS, ref.TOPK_SHIFT
WARPS = 32       # cl::kWarps
PIECES = 8       # cl::kPieces
F32 = np.float32


def _bits(a) -> np.ndarray:
    return np.asarray(a, F32).view(np.uint32)


def _bucket(x: np.ndarray) -> np.ndarray:
    return ((x.view(np.uint32) & 0x7FFFFFFF) >> SHIFT).astype(np.int64)


def chunk_layout(length: int, mis: int) -> list[tuple[int, int, str]]:
    """The kernel's split of a chunk of ``length`` elements whose first
    element sits ``mis`` bytes past a 16-byte boundary: (start, end, how)
    ranges, ``how`` = "thread" or "bulk"."""
    head = min(length, ((16 - mis) & 15) >> 2)
    body = ((length - head) >> 2) << 2
    tail = head + body
    per = (((body >> 2) + PIECES - 1) // PIECES) << 2
    ranges = [(0, head, "thread")] if head else []
    for p in range(PIECES):
        s, e = p * per, min(body, p * per + per)
        if e <= s:
            break
        ranges.append((head + s, head + e, "bulk"))
    if tail < length:
        ranges.append((tail, length, "thread"))
    return ranges


def threshold(hists: np.ndarray, k: int) -> tuple[int, int, list[int]]:
    """t, need and each chunk's tie offset as every block finds them from
    the (C, 512) histograms it holds after the exchange."""
    C = hists.shape[0]
    h = hists.sum(axis=0)
    below = np.cumsum(hists, axis=0) - hists       # [rank]: the lower ranks'
    ge = np.cumsum(h[::-1])[::-1]
    hits = [i for i in range(BUCKETS)
            if ge[i] >= k and (i == BUCKETS - 1 or ge[i + 1] < k)]
    assert len(hits) == 1, hits
    t = hits[0]
    return t, int(k - (ge[t] - h[t])), [int(below[r, t]) for r in range(C)]


def cluster_select(x: np.ndarray, k: int, C: int) -> np.ndarray:
    """The one-launch kernel's arithmetic with C blocks."""
    n = x.size
    m = (-(-n // C) + 3) & ~3
    chunks = [(min(n, r * m), min(n, r * m + m)) for r in range(C)]
    b = _bucket(x)
    hists = np.stack([np.bincount(b[lo:hi], minlength=BUCKETS)
                      for lo, hi in chunks])
    t, need, offs = threshold(hists, k)
    out = np.zeros_like(x)
    walks = []      # the warps that walk their ties: at most one
    for rank, (lo, hi) in enumerate(chunks):
        length = hi - lo
        off = offs[rank]
        seg = ((-(-length // WARPS) + 31) >> 5) << 5
        segs = [(min(length, w * seg), min(length, w * seg + seg))
                for w in range(WARPS)]
        warp_ties = [int((b[lo + s:lo + e] == t).sum()) for s, e in segs]
        for w, (s, e) in enumerate(segs):
            rank_t = off + sum(warp_ties[:w])
            if rank_t + warp_ties[w] <= need or rank_t >= need:
                # all of the segment's ties kept, or all dropped
                tk = t if rank_t < need else t + 1
                seg_x = x[lo + s:lo + e]
                out[lo + s:lo + e] = np.where(b[lo + s:lo + e] >= tk, seg_x, F32(0))
                continue
            walks.append((rank, w))
            # lane l walks the contiguous run [s + l * run, ...) from its
            # first rank: the warp's exclusive scan of the runs' tie counts
            run = -(-(e - s) // 32)
            runs = [(min(e, s + lane * run), min(e, s + lane * run + run))
                    for lane in range(32)]
            mine = [int((b[lo + r0:lo + r1] == t).sum()) for r0, r1 in runs]
            for lane, (r0, r1) in enumerate(runs):
                r = rank_t + sum(mine[:lane])
                for j in range(r0, r1):
                    keep = b[lo + j] > t
                    if b[lo + j] == t:
                        keep = r < need
                        r += 1
                    out[lo + j] = x[lo + j] if keep else F32(0)
    assert len(walks) <= 1, walks
    return out


def _check_select(x: np.ndarray, k: int, C: int, interpret: bool = True):
    got = cluster_select(x, k, C)
    want = ref.topk_select_ref(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got), _bits(rref.topk_select_ref(jnp.asarray(x), k)))
    if interpret:
        kern = rcodec_ops.topk_select(jnp.asarray(x), k, interpret=True)
        np.testing.assert_array_equal(_bits(got), _bits(kern))
    return got


def _ks(n: int) -> list[int]:
    return sorted({0, 1, math.ceil(0.1 * n), n})


# n = 33 and 57 at C = 8 leave chunks of 0 and 1 elements
@pytest.mark.parametrize("C", [1, 8, 16])
@pytest.mark.parametrize("n", [1, 8, 33, 57, 1000, 4097, 10_007])
def test_cluster_select_bit_identical(C, n):
    x = np.random.default_rng(n * 31 + C).normal(size=n).astype(F32) * F32(1e-2)
    for k in _ks(n):
        got = _check_select(x, k, C)
        assert np.count_nonzero(got) == k


def test_cluster_select_ragged_chunks():
    """The layouts the C = 8 cases above produce: a chunk of 1 element and
    empty chunks."""
    for n, lens in ((33, [8, 8, 8, 8, 1, 0, 0, 0]), (57, [8] * 7 + [1])):
        m = (-(-n // 8) + 3) & ~3
        assert [min(n, r * m + m) - min(n, r * m) for r in range(8)] == lens


@pytest.mark.parametrize("C", [1, 8, 16])
def test_cluster_select_one_bucket_and_signed_zeros(C):
    """Every element in one bucket (all ties, across every chunk); then
    exact zeros and -0.0 (a kept -0.0 keeps its sign)."""
    rng = np.random.default_rng(C)
    n = 5003
    one = ((1.0 + rng.random(n) * 0.4) * rng.choice([-1.0, 1.0], n)).astype(F32)
    assert np.unique(_bucket(one)).size == 1
    for k in _ks(n) + [n - 1]:
        _check_select(one, k, C)
    levels = np.array([0.0, -0.0, 1.0, -1.0, 1.25, 2.0], F32)
    x = levels[rng.integers(0, 6, n)]
    for k in _ks(n) + [n // 2]:
        _check_select(x, k, C)
    got = cluster_select(x, n, C)
    zero = x == 0
    assert np.array_equal(np.signbit(got[zero]), np.signbit(x[zero]))
    assert np.signbit(x[zero]).any()


@pytest.mark.parametrize("C", [8, 16])
def test_cluster_select_at_the_main_path_size(C):
    """fim_lbfgs's (g, Γ) payload: n = 413,844, k = ceil(0.1 n); against
    the plain version and the reference's oracle (the interpret-mode
    kernel is held at the smaller sizes above)."""
    n, k = 413_844, 41_385
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.normal(size=n // 2) * 1e-2,
                        rng.exponential(size=n // 2) * 1e-4]).astype(F32)
    got = _check_select(x, k, C, interpret=False)
    assert np.count_nonzero(got) == k


@pytest.mark.parametrize("mis", [0, 4, 8, 12])
@pytest.mark.parametrize("length", [0, 1, 2, 3, 4, 5, 7, 31, 32, 33, 1001,
                                    25_868, 51_732])
def test_chunk_layout_covers_with_aligned_pieces(length, mis):
    ranges = chunk_layout(length, mis)
    covered = [j for s, e, _ in ranges for j in range(s, e)]
    assert covered == list(range(length))
    bulk = [(s, e) for s, e, how in ranges if how == "bulk"]
    assert len(bulk) <= PIECES
    for s, e in bulk:
        assert (mis + 4 * s) % 16 == 0 and (4 * (e - s)) % 16 == 0
    assert sum(e - s for s, e, how in ranges if how == "thread") <= 6


# ---------------------------------------------------------------- int8
def leaf_of(first: list[int], block: int) -> int:
    """The kernel's binary search: the last leaf whose first block is at
    or before ``block``."""
    lo, hi = 0, len(first) - 2
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= block:
            lo = mid
        else:
            hi = mid - 1
    return lo


def leaf_table_roundtrip(xs, us):
    """-> (outs, scales, launch pairs): the two launches' arithmetic, in
    groups of INT8_MAX_LEAVES leaves."""
    outs, scales, pairs = [], [], 0
    for g in range(0, len(xs), codec_ops.INT8_MAX_LEAVES):
        gx = [x.ravel() for x in xs[g:g + codec_ops.INT8_MAX_LEAVES]]
        gu = [u.ravel() for u in us[g:g + codec_ops.INT8_MAX_LEAVES]]
        first = codec_ops.int8_leaf_table(x.size for x in gx)
        partial = np.zeros(first[-1], np.uint32)
        for blk in range(first[-1]):          # launch 1: int8_amax
            leaf = leaf_of(first, blk)
            base = (blk - first[leaf]) * codec_ops.INT8_BLOCK
            part = gx[leaf][base:base + codec_ops.INT8_BLOCK]
            partial[blk] = (part.view(np.uint32) & 0x7FFFFFFF).max()
        for leaf, (x, u) in enumerate(zip(gx, gu)):   # launch 2: int8_apply
            amax = partial[first[leaf]:first[leaf + 1]].max().view(F32)
            s = amax if np.isnan(amax) else np.maximum(amax, F32(1e-12)) / F32(127)
            with np.errstate(invalid="ignore", divide="ignore"):
                q = x / s
                lo = np.floor(q)
                r = lo + (u < q - lo).astype(F32)
                rnd = np.where(np.isnan(r), r, np.clip(r, F32(-127), F32(127)))
                outs.append((rnd * s).reshape(xs[g + leaf].shape))
            scales.append(s)
        pairs += 1
    return outs, np.array(scales, F32), pairs


def _payload(shapes, seed):
    rng = np.random.default_rng(seed)
    xs = [(rng.normal(size=s) * 0.05).astype(F32) for s in shapes]
    us = [rng.random(size=s).astype(F32) for s in shapes]
    return xs, us


def _check_leaves(xs, us, pairs, oracle: bool = True):
    got, scales, n_pairs = leaf_table_roundtrip(xs, us)
    assert n_pairs == pairs
    for i, (x, u) in enumerate(zip(xs, us)):
        tx, tu = torch.from_numpy(x), torch.from_numpy(u)
        s = ref.int8_scale(tx)
        want = ref.int8_roundtrip_ref(tx, tu, s).numpy()
        if np.isnan(want).any():
            np.testing.assert_array_equal(np.isnan(got[i]), np.isnan(want))
            np.testing.assert_array_equal(got[i], want)   # NaN == NaN here
            assert np.isnan(scales[i]) == bool(torch.isnan(s))
            continue
        np.testing.assert_array_equal(_bits(got[i]), _bits(want))
        np.testing.assert_array_equal(_bits(scales[i]), _bits(s))
        if oracle:
            r_s = rref.int8_scale(jnp.asarray(x))
            np.testing.assert_array_equal(_bits(scales[i]), _bits(r_s))
            np.testing.assert_array_equal(_bits(got[i]), _bits(
                rref.int8_roundtrip_ref(jnp.asarray(x), jnp.asarray(u), r_s)))


def _cnn_payload_shapes():
    """The 16 leaves of fim_lbfgs's (g, Γ) payload on the F-MNIST CNN."""
    shapes = [tuple(p.shape) for p in tree_leaves(
        cnn.init(FMNIST_CNN, torch.Generator().manual_seed(0)))]
    return shapes + shapes


def test_leaf_table_blocks_and_map():
    sizes = [1, 2048, 2049, 4096, 5, 200_704]
    first = codec_ops.int8_leaf_table(sizes)
    assert first == [0, 1, 2, 4, 6, 7, 7 + 98]
    for blk in range(first[-1]):
        leaf = leaf_of(first, blk)
        assert first[leaf] <= blk < first[leaf + 1]


def test_leaf_table_cnn_payload_bit_identical():
    shapes = _cnn_payload_shapes()
    assert len(shapes) == 16
    xs, us = _payload(shapes, 0)
    xs[8:] = [np.square(x) * F32(1e-2) for x in xs[8:]]   # Fisher-like Γ
    _check_leaves(xs, us, 1)


def test_leaf_table_edge_leaves():
    """An all-zero leaf (the 1e-12 floor), one element, ragged block
    tails, and inf, NaN and -inf leaves (every output NaN, as the plain
    version's)."""
    shapes = [(5,), (1,), (2048,), (2049,), (4095,), (64,), (64,), (64,)]
    xs, us = _payload(shapes, 1)
    xs[0][:] = 0
    xs[5][3] = np.inf
    xs[6][60] = np.nan
    xs[7][0] = -np.inf
    _check_leaves(xs[:5], us[:5], 1)
    _check_leaves(xs, us, 1, oracle=False)
    got, scales, _ = leaf_table_roundtrip(xs[:1], us[:1])
    assert not got[0].any() and scales[0] == F32(1e-12) / F32(127)
    for i in (5, 6, 7):
        assert np.isnan(leaf_table_roundtrip([xs[i]], [us[i]])[0][0]).all()


def test_leaf_table_payload_split_over_two_launch_pairs():
    """70 leaves: 64 in the first launch pair, 6 in the second (held
    against the plain version alone: 70 shapes would compile the
    reference's oracle 70 times)."""
    shapes = [(1 + 97 * i,) for i in range(70)]
    xs, us = _payload(shapes, 2)
    assert codec_ops.INT8_MAX_LEAVES == 64
    _check_leaves(xs, us, 2, oracle=False)


def test_ops_payload_equals_per_leaf_calls_on_the_cpu():
    """ops.int8_roundtrip_leaves draws one torch.rand a non-empty leaf in
    leaf order (an empty leaf draws nothing and comes back as x.float()),
    so it equals per-leaf ops.int8_roundtrip from the same generator state
    and leaves the generator where they do."""
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.normal(size=s).astype(F32))
          for s in ((300, 17), (0,), (1000,), (3, 3, 16, 32), (0, 4))]
    xs.append(torch.zeros(7))
    g_all, g_one = (torch.Generator().manual_seed(9) for _ in range(2))
    whole = ops.int8_roundtrip_leaves(xs, g_all, mode="auto")
    per_leaf = [ops.int8_roundtrip(x, g_one, mode="off") for x in xs]
    for a, b, x in zip(whole, per_leaf, xs):
        assert a.shape == x.shape and a.dtype == torch.float32
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(g_all.get_state(), g_one.get_state())
    assert ops.int8_roundtrip_leaves([], g_all) == []
    with pytest.raises(ValueError, match="CUDA"):
        ops.int8_roundtrip_leaves(xs, g_all, mode="on")
