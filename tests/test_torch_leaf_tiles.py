"""The leaf-table decompositions of ``csrc/fim_diag.cu`` (``fim_diag_leaves``)
and ``csrc/vlbfgs.cu`` (``gram_leaves``), emulated in numpy on the CPU and
held to the plain versions (``ref.fim_diag_ref`` a leaf;
``ref.vlbfgs_gram_ref`` on the concatenated basis) and to the reference's
Pallas kernels in interpret mode, within 1e-5 (f32 sums in other orders;
each Gram entry (i, j) relative to sqrt(G_ii G_jj), the size of the
products it sums, so a history's small entries are held as tightly as
their rows allow).  Then the port's Fisher diagonal
and Gram entry points on the CPU (the plain paths of the leaf dispatch)
against the reference's, with its Pallas kernels in interpret mode.

The Fisher launch does what the kernel does: the leaves widest first
(``fim_diag.leaf_table``), a binary search from a block to its leaf,
2^shift column groups of 16 bytes a block and 256 >> shift row slices, each
slice summing its rows' squares in increasing row order, the slices' sums
added in slice order, then the mean and the EMA.  A thread loads 16 bytes
from a row only where that row's address is 16-byte aligned and its group
whole, and single elements elsewhere.

The Gram launch does what the kernel does: ``vlbfgs.leaf_plan``'s column
chunks a block, (n, tile) slabs, zero-filled past the chunk; 8 x 8
register tiles whose ``lanes`` threads take every lanes-th quad of a slab,
summed in lane order into the block's upper-triangle partials; the last
``vlbfgs.REDUCERS`` blocks to arrive each sum a slice of the pairs, each
pair's partials in block order ``vlbfgs.RANGE`` blocks at a time, then the
ranges in order, and write both mirrored entries.  A slab comes in by
16-byte copies on rows that start 16-byte aligned and 4-byte copies on
the others, each thread stepping through the quad grid.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_models as rcfg  # noqa: E402
from repro.core import fim as rfim  # noqa: E402
from repro.core import lbfgs as rlbfgs  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.models import cnn as rcnn  # noqa: E402
from repro_torch.configs import paper_models as pcfg  # noqa: E402
from repro_torch.configs.paper_models import FMNIST_CNN  # noqa: E402
from repro_torch.core import fim as pfim  # noqa: E402
from repro_torch.core import lbfgs as plbfgs  # noqa: E402
from repro_torch.kernels import fim_diag, ops, ref, vlbfgs  # noqa: E402
from repro_torch.models import cnn as pcnn  # noqa: E402
from repro_torch.utils.convert import from_jax  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

F32 = np.float32
TOL = 1e-5
N_SM = 132  # the H100's SMs: the plans the card's launches use


def gram_err(got, want) -> float:
    """max over (i, j) of |got_ij - want_ij| / sqrt(want_ii want_jj)."""
    want = np.asarray(want, np.float64)
    d = np.sqrt(np.clip(np.diag(want), 0, None))
    scale = np.maximum(np.outer(d, d), np.finfo(F32).tiny)
    return float((np.abs(np.asarray(got, np.float64) - want) / scale).max())


def cnn_shapes() -> list[tuple]:
    """The F-MNIST CNN's 8 leaves, in tree order."""
    return [tuple(p.shape) for p in tree_leaves(
        pcnn.init(FMNIST_CNN, torch.Generator().manual_seed(0)))]


def leaf_of(first: list[int], block: int) -> int:
    """The kernels' binary search: the last leaf whose first block is at or
    before ``block``."""
    lo, hi = 0, len(first) - 2
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= block:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# --------------------------------------------------------------- fim_diag
def fim_emulated(grads, olds, ema: float, vec: int) -> list[np.ndarray]:
    """One launch's arithmetic over (B, D_i) f32 arrays (bf16 values
    widened, for vec = 8): the per-leaf block shape of the table, each
    slice's sequential sum of squares, the slices in order, mean, EMA."""
    cols = [g.shape[1] for g in grads]
    order, first, shift = fim_diag.leaf_table(cols, vec)
    for blk in range(first[-1]):
        pos = leaf_of(first, blk)
        assert first[pos] <= blk < first[pos + 1]
    outs = [None] * len(grads)
    for pos, i in enumerate(order):
        g = grads[i]
        B, D = g.shape
        rows = fim_diag.THREADS >> shift[pos]
        acc = np.zeros((rows, D), F32)
        for k in range(-(-B // rows)):
            b = np.arange(rows) + k * rows
            live = b < B
            v = g[b[live]]
            acc[live] = acc[live] + v * v
        s = np.zeros(D, F32)
        for r in range(rows):
            s = s + acc[r]
        mean = s / F32(B)
        e = F32(ema)
        outs[i] = ((F32(1) - e) * mean if olds is None
                   else e * olds[i] + (F32(1) - e) * mean)
    return outs


def fim_loads(B: int, D: int, esize: int, base: int) -> tuple[int, int]:
    """(16-byte loads, single-element loads) of one leaf at byte address
    ``base``, each thread choosing as the kernel does: all rows by 16 bytes
    where its group is whole and the base and the row stride keep every
    row 16-byte aligned, else row by row by the row's own address."""
    vec = 16 // esize
    vector = scalar = 0
    b = np.arange(B)
    for c0 in range(0, D, vec):
        whole = c0 + vec <= D
        if whole and ((base + c0 * esize) | (D * esize)) % 16 == 0:
            vector += B
            continue
        aligned = whole & ((base + (b * D + c0) * esize) % 16 == 0)
        vector += int(aligned.sum())
        scalar += int((~aligned).sum()) * min(vec, D - c0)
    return vector, scalar


def _fim_inputs(shapes, B, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    grads = [(rng.normal(size=(B, int(np.prod(s)))) * 0.1).astype(F32)
             for s in shapes]
    if dtype == "bfloat16":
        grads = [_bf16(g) for g in grads]
    return grads


@pytest.mark.parametrize("B", [7, 600])
def test_fim_emulation_cnn_client_matches_plain_and_pallas(B):
    """The 8 CNN leaves of one client, old = 0 and ema = 0 (the main
    path's call): the emulated launch against ref.fim_diag_ref a leaf and
    the Pallas kernel in interpret mode."""
    grads = _fim_inputs(cnn_shapes(), B, seed=B)
    got = fim_emulated(grads, None, 0.0, vec=4)
    for g, out in zip(grads, got):
        want = ref.fim_diag_ref(torch.from_numpy(g), None, 0.0).numpy()
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
        pallas = np.asarray(rops.fim_diag_update(
            jnp.asarray(g), jnp.zeros(g.shape[1], jnp.float32), 0.0,
            force_kernel=True))
        np.testing.assert_allclose(out, pallas, rtol=TOL, atol=TOL)


def test_fim_emulation_with_old_and_ema_matches_pallas():
    grads = _fim_inputs(cnn_shapes(), 7, seed=3)
    rng = np.random.default_rng(4)
    olds = [rng.random(g.shape[1]).astype(F32) for g in grads]
    got = fim_emulated(grads, olds, 0.9, vec=4)
    for g, o, out in zip(grads, olds, got):
        want = ref.fim_diag_ref(torch.from_numpy(g), torch.from_numpy(o),
                                0.9).numpy()
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
        pallas = np.asarray(rops.fim_diag_update(
            jnp.asarray(g), jnp.asarray(o), 0.9, force_kernel=True))
        np.testing.assert_allclose(out, pallas, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shapes", [[(1,)], [(10,)], [(3,)], [(1,), (10,), (5000,)],
                                    [(257, 3), (2049,), (7,)]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fim_emulation_odd_widths_match_plain(shapes, dtype):
    grads = _fim_inputs(shapes, 33, seed=len(shapes), dtype=dtype)
    got = fim_emulated(grads, None, 0.0, vec=4 if dtype == "float32" else 8)
    for g, out in zip(grads, got):
        want = ref.fim_diag_ref(torch.from_numpy(g), None, 0.0).numpy()
        np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)


def test_fim_leaf_table_blocks_cover_every_column():
    """Widest first; each leaf's blocks tile its columns exactly once; the
    wide leaf gets MAX_GROUPS groups a block, narrow leaves just enough."""
    for vec in fim_diag.VEC.values():
        cols = [int(np.prod(s)) for s in cnn_shapes()] + [1, 3, 5000]
        order, first, shift = fim_diag.leaf_table(cols, vec)
        assert [cols[i] for i in order] == sorted(cols, reverse=True)
        assert order == sorted(range(len(cols)),
                               key=lambda i: (-cols[i], i))   # stable
        for pos, i in enumerate(order):
            width = vec << shift[pos]
            assert width <= fim_diag.THREADS          # the final sum's threads
            assert (1 << shift[pos]) <= fim_diag.MAX_GROUPS
            seen = np.zeros(cols[i], np.int64)
            for blk in range(first[pos], first[pos + 1]):
                assert leaf_of(first, blk) == pos
                t0 = (blk - first[pos]) * width
                assert t0 < cols[i]
                seen[t0:t0 + width] += 1
            assert (seen == 1).all()
            if -(-cols[i] // vec) <= fim_diag.MAX_GROUPS:   # one block
                assert first[pos + 1] - first[pos] == 1
    order, first, shift = fim_diag.leaf_table([200_704], 4)
    assert shift == [4] and first == [0, 3136]


@pytest.mark.parametrize("D,esize,base,want", [
    (10, 4, 0, None), (10, 4, 8, None), (200_704, 4, 0, (600 * 50_176, 0)),
    (200_704, 4, 4, (0, 600 * 200_704)), (9, 2, 0, None), (1280, 2, 0, (600 * 160, 0)),
    (1, 4, 0, (0, 600)), (4, 4, 12, (0, 2400))])
def test_fim_loads_fall_back_at_misaligned_rows(D, esize, base, want):
    """Every element is read once; a (600, 10) f32 leaf's odd rows start 8
    bytes off and read element by element, its even rows by 16 bytes where
    the group is whole."""
    B = 600
    vector, scalar = fim_loads(B, D, esize, base)
    assert vector * (16 // esize) + scalar == B * D
    if want is not None:
        assert (vector, scalar) == want
    if (D, esize) == (10, 4):
        # rows whose start is 16-byte aligned: every other one; 2 whole
        # groups a row (columns 0-3, 4-7), columns 8-9 one by one
        aligned_rows = B // 2
        assert vector == 2 * aligned_rows
        assert scalar == B * D - 8 * aligned_rows


# -------------------------------------------------------------- the Gram
def gram_copies(cols: int, count, tile: int, chunk: int,
                bases=(0, 0, 0)) -> dict:
    """One leaf's slab copies, as every block issues them: {"16": 16-byte
    copies (a quad of a row that starts 16-byte aligned), "4": 4-byte
    copies (the quads of the other rows), "zeros": elements zero-filled
    past the chunk}; asserts each element of each row lands exactly once."""
    n = sum(count)
    kinds = {"16": 0, "4": 0, "zeros": 0}
    for r in range(n):
        g = 0 if r < count[0] else (1 if r < count[0] + count[1] else 2)
        rr = r - sum(count[:g])
        seen = np.zeros(cols, np.int64)
        for c_begin in range(0, cols, chunk):
            c_end = min(c_begin + chunk, cols)
            for c in range(c_begin, c_end, tile):
                width = min(tile, c_end - c)
                src = bases[g] + (rr * cols + c) * 4
                for q in range(tile // 4):
                    valid = min(max(width - 4 * q, 0), 4)
                    seen[c + 4 * q:c + 4 * q + valid] += 1
                    kinds["zeros"] += 4 - valid
                    if src % 16 == 0:
                        kinds["16"] += 1
                    else:
                        kinds["4"] += 4
        assert (seen == 1).all()
    return kinds


def copy_order(n: int, quads: int, threads: int) -> list[list[tuple]]:
    """Each thread's (row, quad) copies of a slab, in the order the kernel
    steps them (thread k: quads k, k + threads, ... of the (n, quads) grid,
    stepped without a division)."""
    out = []
    step_r, step_q = threads // quads, threads % quads
    for k in range(threads):
        r, q, mine = k // quads, k % quads, []
        while r < n:
            if q >= quads:
                q -= quads
                r += 1
                if r >= n:
                    break
            mine.append((r, q))
            r, q = r + step_r, q + step_q
        out.append(mine)
    return out


def gram_emulated(leaf_rows: list[np.ndarray], n_sm: int = N_SM,
                  finish_seed: int = 0) -> np.ndarray:
    """One launch's arithmetic over leaves given as (n, cols_i) row blocks
    of the basis: the blocks' lane sums, their partials, and the last
    block's sums (blocks finishing in a random order)."""
    n = leaf_rows[0].shape[0]
    cols = [x.shape[1] for x in leaf_rows]
    lanes, tile, chunk, first = vlbfgs.leaf_plan(n, cols, n_sm)
    U = tile // (4 * lanes)
    iu = np.triu_indices(n)                 # row-major upper triangle
    grid = first[-1]
    partial = np.zeros((len(iu[0]), grid), F32)
    for blk in range(grid):
        leaf = leaf_of(first, blk)
        X = leaf_rows[leaf]
        c_begin = (blk - first[leaf]) * chunk
        c_end = min(c_begin + chunk, cols[leaf])
        acc = np.zeros((lanes, n, n), F32)
        for c in range(c_begin, c_end, tile):
            slab = np.zeros((n, tile), F32)
            w = min(tile, c_end - c)
            slab[:, :w] = X[:, c:c + w]
            for u in range(U):
                for e in range(4):
                    x = slab[:, 4 * (u * lanes + np.arange(lanes)) + e]
                    acc = acc + np.einsum("ik,jk->kij", x, x)
        block_sum = np.zeros((n, n), F32)
        for k in range(lanes):
            block_sum = block_sum + acc[k]
        partial[:, blk] = block_sum[iu]
    # the counters: blocks arrive in a random order; the last REDUCERS to
    # arrive each sum a slice of the pairs, each pair's partials in block
    # order RANGE blocks at a time, then the ranges in order; the last
    # reducer to finish resets both counters
    npairs = len(iu[0])
    reducers = min(vlbfgs.REDUCERS, grid)
    order = np.random.default_rng(finish_seed).permutation(grid)
    arrived, done = 0, 0
    ranks = {}
    for blk in order:
        if arrived >= grid - reducers:
            ranks[int(blk)] = arrived - (grid - reducers)
        arrived += 1
    assert sorted(ranks.values()) == list(range(reducers))
    v = np.zeros(npairs, F32)
    for rank in np.random.default_rng(finish_seed + 1).permutation(reducers):
        p0 = rank * npairs // reducers
        p1 = (rank + 1) * npairs // reducers
        total = np.zeros(p1 - p0, F32)
        for b0 in range(0, grid, vlbfgs.RANGE):
            r = np.zeros(p1 - p0, F32)
            for b in range(b0, min(b0 + vlbfgs.RANGE, grid)):
                r = r + partial[p0:p1, b]
            total = total + r
        v[p0:p1] = total
        done += 1
        if done == reducers:
            arrived, done = 0, 0
    assert arrived == 0 and done == 0
    out = np.zeros((n, n), F32)
    out[iu] = v
    out.T[iu] = v
    return out


def _history_rows(shapes, m: int, seed: int):
    """(s, y, g) leaves of an f32 history of m slots (positive curvature)
    and their (2m+1, cols) row blocks of the basis."""
    rng = np.random.default_rng(seed)
    s = [(rng.normal(size=(m, *sh)) * 0.01).astype(F32) for sh in shapes]
    y = [(a * rng.uniform(0.5, 2.0, a.shape)).astype(F32) for a in s]
    g = [rng.normal(size=sh).astype(F32) for sh in shapes]
    rows = [np.concatenate([a.reshape(m, -1), b.reshape(m, -1),
                            c.reshape(1, -1)]) for a, b, c in zip(s, y, g)]
    return s, y, g, rows


@pytest.mark.parametrize("m", [1, 3, 10])
def test_gram_emulation_cnn_history_matches_plain_and_pallas(m):
    s, y, g, rows = _history_rows(cnn_shapes(), m, seed=m)
    got = gram_emulated(rows)
    assert np.array_equal(got, got.T)
    basis = np.concatenate(rows, axis=1)
    assert basis.shape == (2 * m + 1, 206_922)
    want = ref.vlbfgs_gram_ref(torch.from_numpy(basis)).numpy()
    assert gram_err(got, want) <= TOL
    pallas = np.asarray(rops.vlbfgs_gram(jnp.asarray(basis), force_kernel=True))
    assert gram_err(got, pallas) <= TOL


@pytest.mark.parametrize("n,D", [(1, 1), (5, 512), (9, 10_001), (21, 4096),
                                 (64, 5000)])
def test_gram_emulation_one_basis_matches_plain(n, D):
    """``gram(basis)``: one leaf, its n rows one group."""
    basis = np.random.default_rng(n + D).normal(size=(n, D)).astype(F32)
    got = gram_emulated([basis])
    want = ref.vlbfgs_gram_ref(torch.from_numpy(basis)).numpy()
    assert gram_err(got, want) <= TOL
    assert np.array_equal(got, got.T)


def _planted(fault: str, s, y, g):
    """An m-slot history with one defect planted, as a kernel with that
    defect would read the true one."""
    if fault == "misaligned_odd_rows_zeroed":   # rows off 16 bytes lost
        def cut(leaves):
            out = [a.copy() for a in leaves]
            for a in out:
                if a[0].size % 4:
                    a[1::2] = 0
            return out
        return cut(s), cut(y), g
    if fault == "history_narrow_leaves_dropped":
        wide = max(range(len(g)), key=lambda i: g[i].size)

        def cut(leaves):
            return [a if i == wide else np.zeros_like(a)
                    for i, a in enumerate(leaves)]
        return cut(s), cut(y), g
    assert fault == "y_read_as_s"
    return s, s, g


@pytest.mark.parametrize("fault,subtle", [
    ("misaligned_odd_rows_zeroed", True),
    ("history_narrow_leaves_dropped", None), ("y_read_as_s", False)])
def test_gram_gate_rejects_planted_faults(fault, subtle):
    """The gate (gram_err within TOL) rejects the Gram of an m = 10 CNN
    history with one defect planted.  The control: a gate on the largest
    entry (g's norm, ~10^4 times a history row's) passes the subtle fault
    and rejects the gross one (the history's narrow leaves dropped sit at
    ~1.1 TOL there, on the edge, so no claim)."""
    m = 10
    s, y, g, rows = _history_rows(cnn_shapes(), m, seed=m)
    want = ref.vlbfgs_gram_ref(torch.from_numpy(
        np.concatenate(rows, axis=1))).numpy()
    fs, fy, fg = _planted(fault, s, y, g)
    got = ref.vlbfgs_gram_ref(torch.from_numpy(np.concatenate([np.concatenate(
        [a.reshape(m, -1), b.reshape(m, -1), c.reshape(1, -1)])
        for a, b, c in zip(fs, fy, fg)], axis=1))).numpy()
    assert gram_err(got, want) > TOL
    at_max = np.abs(got - want).max() / np.abs(want).max()
    if subtle is not None:
        assert (at_max <= TOL) == subtle


def test_gram_result_does_not_depend_on_the_order_blocks_finish():
    *_, rows = _history_rows(cnn_shapes(), 3, seed=5)
    a = gram_emulated(rows, finish_seed=0)
    b = gram_emulated(rows, finish_seed=1)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [1, 3, 5, 9, 21, 41, 64])
def test_gram_tile_shape(n):
    tiles, lanes, tile = vlbfgs.tile_shape(n)
    rows = -(-n // vlbfgs.TILE_EDGE) * vlbfgs.TILE_EDGE
    r = rows // vlbfgs.TILE_EDGE
    assert tiles == r * (r + 1) // 2
    threads = -(-tiles * lanes // 32) * 32
    assert threads <= vlbfgs.MAX_THREADS
    assert tile % (4 * lanes) == 0
    assert lanes % 8 == 0     # a quarter-warp reads one row's 8 quads
    assert vlbfgs.STAGES * rows * (tile + 4) * 4 <= vlbfgs.STAGE_BYTES
    if n == 21:
        assert (tiles, lanes, tile, threads) == (6, 64, 256, 384)


@pytest.mark.parametrize("n,cols", [
    (21, [16, 144, 32, 4608, 128, 200_704, 10, 1280]), (21, [1]),
    (7, [10, 1, 3, 1_000_003]), (64, [5000]), (1, [1, 1, 1]),
    (3, [17] * 64)])
def test_gram_blocks_cover_every_column(n, cols):
    """Each leaf's blocks tile its columns exactly once, in chunks of whole
    quads, no more blocks than SMs where the leaves allow (the n_sm = 132
    plan), and the least such chunk."""
    lanes, tile, chunk, first = vlbfgs.leaf_plan(n, cols, N_SM)
    assert chunk % 4 == 0 and tile % (4 * lanes) == 0
    for leaf, c in enumerate(cols):
        seen = np.zeros(c, np.int64)
        for blk in range(first[leaf], first[leaf + 1]):
            assert leaf_of(first, blk) == leaf
            c_begin = (blk - first[leaf]) * chunk
            assert c_begin < c
            seen[c_begin:c_begin + chunk] += 1
        assert (seen == 1).all()
    target = max(vlbfgs.BLOCKS_PER_SM * N_SM, len(cols))
    assert first[-1] <= target
    if chunk > 4:
        assert sum(-(-c // (chunk - 4)) for c in cols) > target
    if n == 21 and len(cols) == 8:        # the main path's launch
        assert (lanes, tile, chunk, first[-1]) == (64, 256, 1632, 132)


def test_gram_copies_fall_back_at_misaligned_rows():
    """An m = 10 history of the CNN: only the (10,) leaf's odd rows of s
    and y start off a 16-byte boundary (40 bytes a row) and copy 4 bytes
    at a time; every element is copied once, the slab's tail zero-filled."""
    n = 21
    _, lanes, tile = vlbfgs.tile_shape(n)
    cols = [int(np.prod(s)) for s in cnn_shapes()]
    _, _, chunk, _ = vlbfgs.leaf_plan(n, cols, N_SM)
    for c in cols:
        kinds = gram_copies(c, (10, 10, 1), tile, chunk)
        if c % 4:
            assert c == 10
            assert kinds["4"] == 2 * 5 * (tile // 4) * 4   # 5 odd rows of s and y
        else:
            assert kinds["4"] == 0
    # a misaligned base moves every row of its group to 4-byte copies
    kinds = gram_copies(12, (2, 2, 1), 16, 16, bases=(4, 0, 0))
    assert kinds["4"] == 2 * 4 * 4 and kinds["16"] == 3 * 4


@pytest.mark.parametrize("n,threads", [(21, 384), (1, 128), (64, 288), (9, 384),
                                       (41, 352)])
def test_gram_slab_copies_cover_the_quad_grid_once(n, threads):
    _, _, tile = vlbfgs.tile_shape(n)
    quads = tile // 4
    seen = np.zeros((n, quads), np.int64)
    for mine in copy_order(n, quads, threads):
        for r, q in mine:
            seen[r, q] += 1
    assert (seen == 1).all()


# ------------------------------------------- the port's entry points, CPU
def _cnn_batch(seed: int, batch: int):
    rc = rcfg.reduced(rcfg.FMNIST_CNN)
    pc = pcfg.reduced(pcfg.FMNIST_CNN)
    rparams = jax.jit(lambda key: rcnn.init(rc, key)[0])(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch,) + rc.input_shape).astype(np.float32)
    y = rng.integers(0, 10, size=batch).astype(np.int64)
    return rc, pc, rparams, from_jax(jax.tree.map(np.asarray, rparams)), x, y


def _assert_tree_close(ours, theirs, rtol, atol_frac):
    for p, r in zip(tree_leaves(ours), jax.tree.leaves(theirs), strict=True):
        r = np.asarray(r)
        assert p.shape == r.shape
        atol = atol_frac * max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(p.detach().numpy(), r, rtol=rtol, atol=atol)


def test_per_example_diag_leaves_match_pallas():
    """The port's Fisher diagonal (one leaf-table call for the tree, its
    plain path on the CPU) against the reference's through the Pallas
    kernel in interpret mode.  Per-example gradients sum in other orders
    in XLA and PyTorch: 1e-4 relative, as tests/test_torch_core.py."""
    rc, pc, rp, pp, x, y = _cnn_batch(seed=2, batch=7)
    want = jax.jit(lambda p, a, b: rfim.per_example_diag(
        rcnn.per_example_loss_fn(rc), p, a, b, kernels="on"))(
            rp, jnp.asarray(x), jnp.asarray(y))
    got = pfim.per_example_diag(pcnn.per_example_loss_fn(pc), pp,
                                torch.from_numpy(x), torch.from_numpy(y),
                                kernels="auto")
    _assert_tree_close(got, want, rtol=1e-4, atol_frac=1e-6)


def test_microbatch_diag_leaves_match_pallas():
    rng = np.random.default_rng(9)
    tree = {"a": rng.normal(size=(6, 7)).astype(F32),
            "b": {"c": rng.normal(size=(10,)).astype(F32),
                  "d": rng.normal(size=(3, 3, 2)).astype(F32)}}
    want = rfim.microbatch_diag(jax.tree.map(jnp.asarray, tree), kernels="on")
    got = pfim.microbatch_diag(from_jax(tree), kernels="auto")
    _assert_tree_close(got, want, rtol=TOL, atol_frac=1e-7)


@pytest.mark.parametrize("m,n_pairs", [(1, 1), (3, 2), (10, 10)])
def test_gram_leaves_plain_matches_reference_kernel(m, n_pairs):
    """``ops.vlbfgs_gram_leaves(mode="off")`` over a port history against
    the reference's ``_gram_via_kernel(h, g, "on")`` (the Pallas Gram in
    interpret mode) on the same history; and the port's own
    ``_gram_via_kernel`` (its CPU path) against both."""
    rng = np.random.default_rng(m)
    shapes = {"w": (6, 7), "b": (10,), "z": {"k": (3, 2, 2)}}

    def tree(fn):
        return {k: {kk: fn(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else fn(v) for k, v in shapes.items()}

    zeros = tree(lambda s: np.zeros(s, F32))
    rh, ph = rlbfgs.init(jax.tree.map(jnp.asarray, zeros), m), plbfgs.init(
        from_jax(zeros), m)
    for _ in range(n_pairs):
        s = tree(lambda sh: rng.normal(size=sh).astype(F32))
        y = jax.tree.map(lambda a: (a * rng.uniform(0.5, 2.0, a.shape)).astype(F32), s)
        rh = rlbfgs.push(rh, jax.tree.map(jnp.asarray, s), jax.tree.map(jnp.asarray, y))
        ph = plbfgs.push(ph, from_jax(s), from_jax(y))
    g = tree(lambda sh: rng.normal(size=sh).astype(F32))
    want = np.asarray(rlbfgs._gram_via_kernel(rh, jax.tree.map(jnp.asarray, g), "on"))
    pg = from_jax(g)
    got = ops.vlbfgs_gram_leaves(tree_leaves(ph.s), tree_leaves(ph.y),
                                 tree_leaves(pg), mode="off").numpy()
    assert gram_err(got, want) <= TOL
    via = plbfgs._gram_via_kernel(ph, pg, "auto").numpy()
    np.testing.assert_array_equal(via, got)
    emulated = gram_emulated([np.concatenate([
        a.reshape(m, -1).numpy(), b.reshape(m, -1).numpy(), c.reshape(1, -1).numpy()])
        for a, b, c in zip(tree_leaves(ph.s), tree_leaves(ph.y), tree_leaves(pg))])
    assert gram_err(emulated, want) <= TOL


def _constexprs(source: str) -> dict:
    """name -> value of each ``constexpr int[64_t] kName = <integer>;`` of
    ``csrc/<source>.cu`` (products of integers evaluated)."""
    text = (Path(vlbfgs.__file__).parents[1] / "csrc" / f"{source}.cu").read_text()
    found = {}
    for name, expr in re.findall(
            r"constexpr\s+(?:int|int64_t)\s+(k\w+)\s*=\s*([0-9 *]+);", text):
        found[name] = int(np.prod([int(v) for v in expr.split("*")]))
    return found


def test_python_launch_constants_mirror_the_cuda_sources():
    """The host-side plans (``vlbfgs.tile_shape``/``leaf_plan``,
    ``fim_diag.leaf_table``) size launches from mirrors of the sources'
    constants: they must match what the kernels were built with."""
    v = _constexprs("vlbfgs")
    assert {k: v[k] for k in ("kMaxN", "kMaxLeaves", "kStages", "kMaxThreads",
                              "kT", "kRange", "kReducers")} == {
        "kMaxN": vlbfgs.MAX_N, "kMaxLeaves": vlbfgs.MAX_LEAVES,
        "kStages": vlbfgs.STAGES, "kMaxThreads": vlbfgs.MAX_THREADS,
        "kT": vlbfgs.TILE_EDGE, "kRange": vlbfgs.RANGE,
        "kReducers": vlbfgs.REDUCERS}
    assert vlbfgs.STAGE_BYTES <= v["kMaxSmem"]
    f = _constexprs("fim_diag")
    assert (f["kThreads"], f["kMaxLeaves"]) == (fim_diag.THREADS,
                                                 fim_diag.MAX_LEAVES)
    for vec in fim_diag.VEC.values():       # a block's groups fit its threads
        assert vec * fim_diag.MAX_GROUPS <= fim_diag.THREADS


def test_fim_leaves_dispatch_on_the_cpu():
    """No old is zeros, bit for bit; "auto" on the CPU is the plain path;
    an empty list is an empty list; "on" refuses a CPU tensor."""
    grads = [torch.from_numpy(g) for g in _fim_inputs([(10,), (3, 4)], 5, 1)]
    none = ops.fim_diag_update_leaves(grads, None, 0.0, mode="off")
    zeros = ops.fim_diag_update_leaves(
        grads, [torch.zeros(g.shape[1]) for g in grads], 0.0, mode="off")
    auto = ops.fim_diag_update_leaves(grads, None, 0.0, mode="auto")
    for a, b, c, g in zip(none, zeros, auto, grads):
        assert torch.equal(a, b) and torch.equal(a, c)
        assert torch.equal(a, torch.mean(g.square(), dim=0))
    assert ops.fim_diag_update_leaves([], None, 0.0) == []
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ops.fim_diag_update_leaves(grads, None, 0.0, mode="on")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ops.vlbfgs_gram_leaves([torch.zeros(1, 3)], [torch.zeros(1, 3)],
                               [torch.zeros(3)], mode="on")


def test_leaf_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fim_diag.fim_diag_leaves([torch.zeros((2, 3))], None, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        vlbfgs.gram_leaves([torch.zeros(1, 3)], [torch.zeros(1, 3)],
                           [torch.zeros(3)])
    assert fim_diag.fim_diag_leaves([], None, 0.0) == []
