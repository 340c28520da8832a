"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card, plus the cohort path's Γ launches, the fleet engine's float64
device backend against its numpy backend, and the MoE layer's dispatch
against chip_smoke.py's plain one.  Marked ``cuda``: on a host without a CUDA device every test skips
with the reason.  This file imports neither JAX nor the reference, so it
runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fim_diag and the Gram sum in other orders than the plain
versions (f32 accumulation), so 1e-5 relative (each Gram entry (i, j)
relative to sqrt(G_ii G_jj), the size of the products it sums, against an
f64 product); int8 and the top-k select
are bit-identical; flash attention 2e-5 in f32 (tests/test_kernels.py's
tolerance) and one bf16 ulp in bf16: both round an f32 result to bf16
once, so 2^-7 relative (8 significant bits) plus 1e-5 absolute for
elements so near zero that the f32 difference spans several of their ulps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.paper_models import FMNIST_CNN  # noqa: E402
from repro_torch.kernels import (codec_ops, fim_diag,  # noqa: E402
                                 flash_attention, ops, ref, vlbfgs)
from repro_torch.models import cnn  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B,D", [(8, 256), (5, 131), (300, 3000),
                                 (257, 2049), (600, 200_704)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fim_diag_kernel_matches_plain(cuda, B, D, dtype):
    gen = torch.Generator(device=cuda).manual_seed(B + D)
    g = torch.randn((B, D), generator=gen, device=cuda).to(getattr(torch, dtype))
    old = torch.rand((D,), generator=gen, device=cuda)
    before = fim_diag.LAUNCHES
    got = ops.fim_diag_update(g, old, 0.9, mode="on")
    assert fim_diag.LAUNCHES == before + 1
    torch.testing.assert_close(got, ref.fim_diag_ref(g, old, 0.9),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ops.fim_diag_update(g, old, 0.9, mode="on"))


def _cnn_shapes():
    """The 8 leaves of the F-MNIST CNN, in tree order."""
    return [tuple(p.shape) for p in tree_leaves(
        cnn.init(FMNIST_CNN, torch.Generator().manual_seed(0)))]


def _fim_leaves_check(grads, olds, ema):
    """One launch a call, each leaf within 1e-5 of the plain version, and
    a second call bit-equal."""
    before = fim_diag.LAUNCHES
    got = ops.fim_diag_update_leaves(grads, olds, ema, mode="on")
    assert fim_diag.LAUNCHES == before + 1
    again = ops.fim_diag_update_leaves(grads, olds, ema, mode="on")
    plain = ops.fim_diag_update_leaves(grads, olds, ema, mode="off")
    assert len(got) == len(grads)
    for a, b, w, g in zip(got, again, plain, grads):
        assert a.shape == (g.shape[1],) and a.dtype == torch.float32
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("B", [7, 600])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fim_diag_leaves_cnn_client_one_launch(cuda, B, dtype):
    """The 8 leaves of one client of the F-MNIST CNN in one launch, no old
    (the main path's call), then with an old diagonal and ema 0.9."""
    gen = torch.Generator(device=cuda).manual_seed(B)
    grads = [torch.randn((B, int(np.prod(s))), generator=gen, device=cuda)
             .to(getattr(torch, dtype)) for s in _cnn_shapes()]
    _fim_leaves_check(grads, None, 0.0)
    olds = [torch.rand((g.shape[1],), generator=gen, device=cuda)
            for g in grads]
    _fim_leaves_check(grads, olds, 0.9)


@pytest.mark.parametrize("D", [1, 10, 13])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fim_diag_leaves_narrow_and_misaligned(cuda, D, dtype):
    """D = 10 f32: every odd row starts 8 bytes off a 16-byte boundary, so
    those rows load element by element; a base off 16 bytes too (a view
    one element into a buffer)."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    buf = torch.randn((33 * D + 1,), generator=gen, device=cuda).to(
        getattr(torch, dtype))
    shifted = buf[1:].view(33, D)
    _fim_leaves_check([shifted, buf[:33 * D].view(33, D)], None, 0.0)


def test_fim_diag_leaves_no_old_is_zeros_bit_for_bit(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    grads = [torch.randn((600, int(np.prod(s))), generator=gen, device=cuda)
             for s in _cnn_shapes()]
    none = _fim_leaves_check(grads, None, 0.0)
    zeros = _fim_leaves_check(
        grads, [torch.zeros(g.shape[1], device=cuda) for g in grads], 0.0)
    for a, b in zip(none, zeros):
        assert torch.equal(a, b)


def test_fim_diag_leaves_empty_launches_nothing(cuda):
    before = fim_diag.LAUNCHES
    assert ops.fim_diag_update_leaves([], None, 0.0, mode="on") == []
    got = ops.fim_diag_update_leaves([torch.zeros((4, 0), device=cuda)],
                                     None, 0.0, mode="on")
    assert got[0].shape == (0,)
    assert fim_diag.LAUNCHES == before


def test_fim_diag_leaves_beyond_one_table(cuda):
    """70 leaves: two launches (64 leaves a table)."""
    gen = torch.Generator(device=cuda).manual_seed(70)
    grads = [torch.randn((9, 1 + i), generator=gen, device=cuda)
             for i in range(70)]
    before = fim_diag.LAUNCHES
    got = ops.fim_diag_update_leaves(grads, None, 0.0, mode="on")
    assert fim_diag.LAUNCHES == before + 2
    for a, g in zip(got, grads):
        torch.testing.assert_close(a, ref.fim_diag_ref(g, None, 0.0),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,D", [(5, 512), (21, 4096), (21, 10_001), (9, 64),
                                 (9, 12_300), (21, 206_922), (64, 5000),
                                 (1, 1)])
def test_gram_kernel_matches_plain(cuda, n, D):
    gen = torch.Generator(device=cuda).manual_seed(n + D)
    basis = torch.randn((n, D), generator=gen, device=cuda)
    before = vlbfgs.LAUNCHES
    got = ops.vlbfgs_gram(basis, mode="on")
    assert vlbfgs.LAUNCHES == before + 1
    _assert_gram_close(got, basis)
    assert torch.equal(got, ops.vlbfgs_gram(basis, mode="on"))


def _gram_err(got, want):
    """max over (i, j) of |got_ij - want_ij| / sqrt(want_ii want_jj)."""
    d = want.diagonal().sqrt()
    scale = torch.outer(d, d).clamp_min(torch.finfo(want.dtype).tiny)
    return float(((got.to(want.dtype) - want).abs() / scale).max())


def _assert_gram_close(got, basis):
    """Each entry within 1e-5 of its Cauchy-Schwarz scale of the f64
    product of the basis (so a history's small entries are held as tightly
    as their rows allow), and exactly symmetric."""
    b = basis.double()
    assert _gram_err(got, b @ b.T) <= 1e-5
    assert torch.equal(got, got.T)


def _history(cuda, shapes, m, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    s = [torch.randn((m, *sh), generator=gen, device=cuda) * 1e-2
         for sh in shapes]
    y = [a * (0.5 + 1.5 * torch.rand(a.shape, generator=gen, device=cuda))
         for a in s]
    g = [torch.randn(sh, generator=gen, device=cuda) for sh in shapes]
    return s, y, g


def _basis(s, y, g):
    m = s[0].shape[0]
    return torch.cat([torch.cat([a.reshape(m, -1) for a in s], 1),
                      torch.cat([a.reshape(m, -1) for a in y], 1),
                      torch.cat([a.reshape(-1) for a in g])[None]])


def _gram_leaves_check(s, y, g, launches=1):
    m = s[0].shape[0]
    before = vlbfgs.LAUNCHES
    got = ops.vlbfgs_gram_leaves(s, y, g, mode="on")
    assert vlbfgs.LAUNCHES == before + launches
    _assert_gram_close(got, _basis(s, y, g))
    assert torch.equal(got, ops.vlbfgs_gram_leaves(s, y, g, mode="on"))
    return got


@pytest.mark.parametrize("m", [1, 3, 10])
def test_gram_leaves_cnn_history_one_launch(cuda, m):
    """Read in place from an m-slot history of the CNN's 8 leaves: at
    m = 10 the (10,) leaf's odd rows start 8 bytes off a 16-byte boundary."""
    _gram_leaves_check(*_history(cuda, _cnn_shapes(), m, seed=m))


def test_gram_leaves_narrow_leaves_and_misaligned_bases(cuda):
    shapes = [(1,), (10,), (3, 3), (7, 5), (4097,)]
    s, y, g = _history(cuda, shapes, 4, seed=11)
    # a view one element into a buffer: every row of that group is off
    buf = torch.randn((4 * 4097 + 1,), device=cuda)
    s[-1] = buf[1:].view(4, 4097)
    _gram_leaves_check(s, y, g)


def test_gram_leaves_match_the_basis_entry_point(cuda):
    """The history read in place and the same basis materialised go
    through one kernel: equal to the same tolerance, each deterministic."""
    s, y, g = _history(cuda, _cnn_shapes(), 10, seed=3)
    got = _gram_leaves_check(s, y, g)
    flat = ops.vlbfgs_gram(_basis(s, y, g), mode="on")
    assert _gram_err(got, flat) <= 1e-5


def test_gram_leaves_on_two_streams_at_once(cuda):
    """Launches on two streams may overlap: each stream has its own pair
    of counters, so both Grams are right and each equals its one-stream
    result bit for bit."""
    shapes = _cnn_shapes()
    runs = [_history(cuda, shapes, 10, seed=20 + k) for k in range(2)]
    alone = [ops.vlbfgs_gram_leaves(*h, mode="on") for h in runs]
    streams = [torch.cuda.Stream(cuda) for _ in runs]
    torch.cuda.synchronize(cuda)
    outs = [[] for _ in runs]
    for _ in range(20):
        for k, (st, h) in enumerate(zip(streams, runs)):
            with torch.cuda.stream(st):
                outs[k].append(ops.vlbfgs_gram_leaves(*h, mode="on"))
    torch.cuda.synchronize(cuda)
    keys = {key for key in vlbfgs._TICKETS if key[0] == alone[0].device}
    assert {(alone[0].device, st.cuda_stream) for st in streams} <= keys
    for k, h in enumerate(runs):
        _assert_gram_close(alone[k], _basis(*h))
        for got in outs[k]:
            assert torch.equal(got, alone[k])


def test_gram_leaves_beyond_one_table_and_empty(cuda):
    """70 leaves: two launches, summed; empty leaves launch nothing."""
    s, y, g = _history(cuda, [(3 + i,) for i in range(70)], 2, seed=70)
    _gram_leaves_check(s, y, g, launches=2)
    before = vlbfgs.LAUNCHES
    zero = ops.vlbfgs_gram_leaves([torch.zeros((2, 0), device=cuda)],
                                  [torch.zeros((2, 0), device=cuda)],
                                  [torch.zeros((0,), device=cuda)], mode="on")
    assert vlbfgs.LAUNCHES == before
    assert torch.equal(zero, torch.zeros((5, 5), device=cuda))


def _bf16_history(cuda, shapes, m, seed):
    """An m-slot bf16 history (s, y) of ``shapes`` beside an f32 g."""
    s, y, g = _history(cuda, shapes, m, seed)
    return [a.bfloat16() for a in s], [a.bfloat16() for a in y], g


# bf16 rows of n columns start 2n bytes apart: (10,) puts odd rows 4 bytes
# and rows 2 mod 4 8 bytes off 16 (the element-wise and 8-byte copies);
# (7, 5), (3,), (33, 129) and (4097,) leave ragged tails in every slab
BF16_SHAPES = [[(10,), (7, 5), (3,), (33, 129), (4097,), (1,)],
               [(64, 4096), (4096,), (512, 128), (49_152 // 8, 16)]]


@pytest.mark.parametrize("m", [1, 4, 10])
@pytest.mark.parametrize("shapes", BF16_SHAPES, ids=["ragged", "llm_like"])
def test_gram_leaves_bf16_history_read_in_place(cuda, m, shapes):
    """A bf16 history beside an f32 g, read in place in one launch: each
    entry within 1e-5 of its Cauchy-Schwarz scale of the f64 product of
    the same (exactly widened) values, held against the plain version the
    same way, exactly symmetric and deterministic."""
    s, y, g = _bf16_history(cuda, shapes, m, seed=100 + m)
    basis = _basis([a.float() for a in s], [a.float() for a in y], g)
    before = vlbfgs.LAUNCHES
    got = ops.vlbfgs_gram_leaves(s, y, g, mode="on")
    assert vlbfgs.LAUNCHES == before + 1
    _assert_gram_close(got, basis)
    assert torch.equal(got, ops.vlbfgs_gram_leaves(s, y, g, mode="on"))
    plain = ops.vlbfgs_gram_leaves(s, y, g, mode="off")
    assert _gram_err(got, plain.double()) <= 1e-5
    # the f32 history of the same values gives the same Gram
    f32 = ops.vlbfgs_gram_leaves([a.float() for a in s],
                                 [a.float() for a in y], g, mode="on")
    assert _gram_err(got, f32.double()) <= 1e-5


def test_gram_bf16_misaligned_bases_and_groups(cuda):
    """bf16 rows whose group starts one element into its buffer (2 bytes
    off: every row element by element), an all-bf16 basis through the
    basis entry point, and a bf16 g beside an f32 history."""
    shapes = [(5,), (4097,), (129,)]
    s, y, g = _bf16_history(cuda, shapes, 3, seed=7)
    buf = torch.randn((3 * 4097 + 1,), device=cuda).bfloat16()
    s[1] = buf[1:].view(3, 4097)
    basis = _basis([a.float() for a in s], [a.float() for a in y], g)
    _assert_gram_close(ops.vlbfgs_gram_leaves(s, y, g, mode="on"), basis)
    flat = basis.bfloat16()
    _assert_gram_close(ops.vlbfgs_gram(flat, mode="on"), flat.float())
    s32 = [a.float() for a in s]
    y32 = [a.float() for a in y]
    gb = [a.bfloat16() for a in g]
    _assert_gram_close(ops.vlbfgs_gram_leaves(s32, y32, gb, mode="on"),
                       _basis(s32, y32, [a.float() for a in gb]))
    with pytest.raises(ValueError, match="one dtype"):
        vlbfgs.gram_leaves([s[0], s32[1], s[2]], y, g)


def test_flash_attention_refuses_inputs_that_require_grad(cuda):
    """The kernel has no backward: with grad mode on and an input that
    requires grad the wrapper raises instead of returning a result with no
    graph; under no_grad, or with plain inputs, it runs."""
    q, k, v = _qkv(cuda, 1, 4, 2, 128, 64, torch.bfloat16, 3)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.flash_attention(q.requires_grad_(), k, v, mode="on")
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, mode="on")
    assert not out.requires_grad
    assert torch.equal(out, ops.flash_attention(q.detach(), k, v, mode="on"))


def test_llm_train_step_kernels_auto_beside_off(cuda):
    """The LLM train step at the granite smoke config in f32 on the card:
    3 fim_lbfgs steps with kernels="auto" launch the Gram once a step and
    nothing else; the kernels="off" twin from the same init on the same
    batches launches nothing.  Step 1 is bit-identical (an empty history
    gives the steepest-descent direction whatever the Gram reads); later
    steps differ only by the Gram's f32 summation order: losses within
    1e-5 and dir_norm within 1e-4 relative.  The attention gradients are
    non-zero (the loss runs the plain attention)."""
    from repro_torch.configs import granite_8b
    from repro_torch.data.synthetic import zipf_tokens
    from repro_torch.launch import train
    from repro_torch.models import model

    cfg = granite_8b.smoke_config().replace(remat=True)
    ocfg = train.opt_config(cfg)
    toks = torch.from_numpy(zipf_tokens(4, 128, cfg.vocab_size, seed=5)).to(cuda)
    runs = {}
    for mode in ("auto", "off"):
        params, opt = train.init_train_state(
            cfg, ocfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
        step = train.make_train_step(cfg, ocfg, n_micro=2, kernels=mode)
        before = (vlbfgs.LAUNCHES, flash_attention.LAUNCHES)
        stats = []
        for _ in range(3):
            params, opt, st = step(params, opt, {"tokens": toks})
            stats.append({k: float(v) for k, v in st.items()})
        runs[mode] = (stats, (vlbfgs.LAUNCHES - before[0],
                              flash_attention.LAUNCHES - before[1]))
    (auto, auto_n), (off, off_n) = runs["auto"], runs["off"]
    assert auto_n == (3, 0) and off_n == (0, 0)
    assert auto[0] == off[0]
    for a, o in zip(auto, off):
        assert np.isfinite(a["loss"])
        assert abs(a["loss"] - o["loss"]) <= 1e-5 * abs(o["loss"])
        assert abs(a["dir_norm"] - o["dir_norm"]) <= 1e-4 * o["dir_norm"]
    params = model.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    wq = params["layers"]["attn"]["wq"].requires_grad_()
    loss, _ = model.loss_fn(params, cfg, {"tokens": toks})
    (gq,) = torch.autograd.grad(loss, [wq])
    assert float(gq.abs().max()) > 0


@pytest.mark.parametrize("shape", [(7,), (1000,), (33, 129), (300, 17),
                                   (3, 3, 16, 32), (6272, 128)])
def test_int8_kernel_bit_identical_to_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(int(np.prod(shape)))
    x = torch.randn(shape, generator=gen, device=cuda) * 3.0
    u = torch.rand(shape, generator=gen, device=cuda)
    s = ref.int8_scale(x)
    assert float(s) == float(np.float32(float(x.abs().max())) / np.float32(127))
    before = codec_ops.LAUNCHES
    (got,), scales = codec_ops.int8_roundtrip_leaves([x], [u])
    assert codec_ops.LAUNCHES == before + 1
    want = ref.int8_roundtrip_ref(x, u, s)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(scales.view(torch.int32), s.reshape(1).view(torch.int32))


def _payload(dev, shapes, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randn(s, generator=gen, device=dev) * 0.05 for s in shapes]
    return xs, [torch.rand(s, generator=gen, device=dev) for s in shapes]


def _int8_payload_check(xs, us, pairs):
    """One call over the payload: ``pairs`` launch pairs, every leaf and
    scale bit-identical to the per-leaf plain version (NaN where it has
    NaN)."""
    before = codec_ops.LAUNCHES
    got, scales = codec_ops.int8_roundtrip_leaves(xs, us)
    assert codec_ops.LAUNCHES == before + pairs
    assert scales.shape == (len(xs),)
    for i, (x, u, g) in enumerate(zip(xs, us, got)):
        s = ref.int8_scale(x)
        want = ref.int8_roundtrip_ref(x, u, s)
        assert g.shape == x.shape
        if bool(torch.isnan(want).any()):
            torch.testing.assert_close(g, want, rtol=0, atol=0,
                                       equal_nan=True)
            torch.testing.assert_close(scales[i], s, rtol=0, atol=0,
                                       equal_nan=True)
        else:
            assert torch.equal(g.view(torch.int32), want.view(torch.int32)), i
            assert torch.equal(scales[i].view(torch.int32),
                               s.view(torch.int32)), i


def _cnn_payload_shapes():
    """The 16 leaves of fim_lbfgs's (g, Γ) payload on the F-MNIST CNN."""
    return _cnn_shapes() * 2


def test_int8_payload_one_launch_pair_bit_identical(cuda):
    xs, us = _payload(cuda, _cnn_payload_shapes(), 3)
    xs[8:] = [x.square() * 1e-2 for x in xs[8:]]   # Fisher-like Γ leaves
    _int8_payload_check(xs, us, 1)


def test_int8_payload_edge_leaves(cuda):
    """An all-zero leaf (the 1e-12 floor), one element, ragged tails at the
    block size, inf and NaN leaves (every output NaN, as the plain
    version's; -inf too), beside ordinary leaves."""
    shapes = [(5,), (1,), (2048,), (2049,), (4095,), (300, 17), (64,), (64,),
              (64,)]
    xs, us = _payload(cuda, shapes, 4)
    xs[0] = torch.zeros_like(xs[0])
    xs[6][3] = float("inf")
    xs[7][60] = float("nan")
    xs[8][0] = -float("inf")
    _int8_payload_check(xs, us, 1)
    got, scales = codec_ops.int8_roundtrip_leaves(xs[:1], us[:1])
    assert torch.equal(got[0], torch.zeros_like(xs[0]))
    assert float(scales[0]) == float(np.float32(1e-12) / np.float32(127))


def test_int8_payload_split_over_launch_pairs(cuda):
    """70 leaves: 64 in the first launch pair, 6 in the second."""
    shapes = [(1 + 97 * i,) for i in range(70)]
    xs, us = _payload(cuda, shapes, 5)
    assert codec_ops.INT8_MAX_LEAVES == 64
    _int8_payload_check(xs, us, 2)


def test_int8_ops_payload_equals_per_leaf_calls(cuda):
    """ops.int8_roundtrip_leaves (one launch pair, an empty leaf skipped)
    equals per-leaf ops.int8_roundtrip and the plain path from the same
    generator state, and leaves the generator where they do."""
    shapes = [(300, 17), (0,), (1000,), (3, 3, 16, 32)]
    xs, _ = _payload(cuda, shapes, 6)
    gens = [torch.Generator(device=cuda).manual_seed(9) for _ in range(3)]
    before = codec_ops.LAUNCHES
    whole = ops.int8_roundtrip_leaves(xs, gens[0], mode="on")
    assert codec_ops.LAUNCHES == before + 1
    per_leaf = [ops.int8_roundtrip(x, gens[1], mode="on") for x in xs]
    plain = ops.int8_roundtrip_leaves(xs, gens[2], mode="off")
    for a, b, c in zip(whole, per_leaf, plain):
        assert a.shape == b.shape == c.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert torch.equal(gens[0].get_state(), gens[2].get_state())


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        fim_diag.fim_diag(torch.zeros((4, 8), device=cuda, dtype=torch.float16),
                          torch.zeros(8, device=cuda), 0.0)
    with pytest.raises(ValueError):
        vlbfgs.gram(torch.zeros((65, 8), device=cuda))
    with pytest.raises(ValueError, match="B ="):
        fim_diag.fim_diag_leaves([torch.zeros((4, 8), device=cuda),
                                  torch.zeros((5, 8), device=cuda)], None, 0.0)
    with pytest.raises(ValueError, match="old diagonal"):
        fim_diag.fim_diag_leaves([torch.zeros((4, 8), device=cuda)],
                                 [torch.zeros(7, device=cuda)], 0.0)
    with pytest.raises(ValueError, match="rows"):
        vlbfgs.gram_leaves([torch.zeros((32, 3), device=cuda)],
                           [torch.zeros((32, 3), device=cuda)],
                           [torch.zeros(3, device=cuda)])
    with pytest.raises(ValueError, match="contiguous f32"):
        vlbfgs.gram_leaves([torch.zeros((2, 3), device=cuda)],
                           [torch.zeros((2, 4), device=cuda)],
                           [torch.zeros(3, device=cuda)])
    with pytest.raises(ValueError, match="shaped"):
        codec_ops.int8_roundtrip_leaves([torch.zeros(4, device=cuda)],
                                        [torch.zeros(5, device=cuda)])
    with pytest.raises(ValueError, match="non-empty"):
        codec_ops.int8_roundtrip_leaves([torch.zeros(0, device=cuda)],
                                        [torch.zeros(0, device=cuda)])
    with pytest.raises(ValueError, match="f32"):
        codec_ops.int8_roundtrip_leaves(
            [torch.zeros(4, device=cuda, dtype=torch.float64)],
            [torch.zeros(4, device=cuda)])
    with pytest.raises(ValueError, match="one u a leaf"):
        codec_ops.int8_roundtrip_leaves([torch.zeros(4, device=cuda)], [])


TOPK_CASES = [(8, 2), (35, 4), (1000, 100), (5000, 1), (2048, 2048),
              (1537, 700), (1024, 1), (4097, 1), (4097, 4097), (4096, 4095),
              (100_003, 10_001), (206_922, 20_693), (413_844, 41_385)]


def _topk_check(x, k):
    """One call, on the cluster path iff n is within its capacity."""
    _, capacity = codec_ops.cluster_shape(x.device)
    before = codec_ops.TOPK_LAUNCHES, codec_ops.TOPK_CLUSTER_LAUNCHES
    got = ops.topk_select(x, k, mode="on")
    assert (codec_ops.TOPK_LAUNCHES, codec_ops.TOPK_CLUSTER_LAUNCHES) == (
        before[0] + 1, before[1] + int(x.numel() <= capacity))
    want = ref.topk_select_ref(x, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int(torch.count_nonzero(got)) == min(k, int(torch.count_nonzero(x)))
    return got


@pytest.mark.parametrize("n,k", TOPK_CASES)
def test_topk_kernel_bit_identical_to_plain(cuda, n, k):
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    x = torch.randn((n,), generator=gen, device=cuda) * 1e-2
    got = _topk_check(x, k)
    assert int(torch.count_nonzero(got)) == k


def test_topk_kernel_ties_zeros_and_signed_zeros(cuda):
    flat = torch.tensor([3.0, -1.0, 1.0, 1.0, -3.0, 1.0, 0.5, -1.0],
                        device=cuda)
    for k in range(1, 9):
        _topk_check(flat, k)
    # many exact ties across tiles, exact zeros and -0.0 kept with its sign
    gen = torch.Generator(device=cuda).manual_seed(5)
    n = 3 * 4096 + 77
    levels = torch.tensor([0.0, -0.0, 1.0, -1.0, 1.25, 2.0], device=cuda)
    x = levels[torch.randint(0, 6, (n,), generator=gen, device=cuda)]
    for k in (1, 100, 4096, 5000, n // 2, n - 1, n):
        got = ops.topk_select(x, k, mode="on")
        want = ref.topk_select_ref(x, k)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k
    zero = x == 0
    out = ops.topk_select(x, n, mode="on")
    assert torch.equal(torch.signbit(out[zero]), torch.signbit(x[zero]))
    assert bool(torch.signbit(x[zero]).any())


def test_topk_cluster_capacity_holds_the_main_path(cuda):
    """The card places a cluster of 16 (or 8), and the one-launch path takes
    fim_lbfgs's (g, Γ) payload of the F-MNIST CNN."""
    cluster, capacity = codec_ops.cluster_shape(cuda)
    assert cluster in (8, 16)
    assert capacity >= 413_844


@pytest.mark.parametrize("k_of", ["one", "tenth", "all"])
def test_topk_kernel_above_the_cluster_capacity(cuda, k_of):
    """n above the capacity runs the four-launch path, bit-identical."""
    _, capacity = codec_ops.cluster_shape(cuda)
    n = capacity + 4097
    x = torch.randn((n,), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda) * 1e-2
    before = codec_ops.TOPK_CLUSTER_LAUNCHES
    _topk_check(x, {"one": 1, "tenth": -(-n // 10), "all": n}[k_of])
    assert codec_ops.TOPK_CLUSTER_LAUNCHES == before


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("n,k", [(8, 3), (33, 0), (57, 20), (1000, 100),
                                 (4097, 4097), (206_922, 20_693),
                                 (413_844, 41_385)])
def test_topk_cluster_sizes_and_paths_agree(cuda, cluster, n, k):
    """Both cluster sizes (where the card places them) and the four-launch
    path give the plain version's output: ragged chunks (n = 33 and 57 at
    8 blocks leave chunks of 0 and 1 elements), k = 0 and k = n."""
    placed, capacity = codec_ops.cluster_shape(cuda, cluster)
    if placed != cluster:
        pytest.skip(f"this card places no cluster of {cluster} blocks")
    x = torch.randn((n,), generator=torch.Generator(device=cuda).manual_seed(n),
                    device=cuda) * 1e-2
    want = ref.topk_select_ref(x, k)
    for got in (codec_ops.topk_select_cluster(x, k, cluster),
                codec_ops.topk_select_tiles(x, k)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("offset", [1, 2, 3, 4])
def test_topk_cluster_reads_misaligned_views(cuda, offset):
    """A view that starts 4, 8 or 12 bytes past a 16-byte boundary: the
    chunks' ragged ends are loaded by threads, the rest by bulk copies."""
    n = 100_003
    buf = torch.randn((n + offset,),
                      generator=torch.Generator(device=cuda).manual_seed(offset),
                      device=cuda)
    x = buf[offset:]
    for k in (1, 10_001, n):
        _topk_check(x, k)


def test_topk_one_bucket_input(cuda):
    """Every element in one bucket: the select is all ties, across every
    chunk of the cluster."""
    n = 206_922
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = (1.0 + torch.rand((n,), generator=gen, device=cuda) * 0.4) * torch.where(
        torch.rand((n,), generator=gen, device=cuda) < 0.5, -1.0, 1.0)
    assert int(((x.abs().view(torch.int32) >> 22).unique()).numel()) == 1
    for k in (0, 1, 20_693, n - 1, n):
        _topk_check(x, k)


def test_topk_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    with pytest.raises(ValueError, match="CUDA"):
        codec_ops.topk_select(torch.ones(8), 2)
    with pytest.raises(ValueError, match="f32"):
        codec_ops.topk_select(torch.ones(8, device=cuda, dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="contiguous"):
        codec_ops.topk_select(torch.ones(16, device=cuda)[::2], 2)
    with pytest.raises(ValueError, match="k <= n"):
        codec_ops.topk_select(torch.ones(8, device=cuda), 9)


# B, H, KV, S, hd, causal, window: tests/test_kernels.py's FLASH_CASES,
# then hubert's hd 80 (MHA, non-causal), granite's hd 128 (GQA 4), a window
# at hd 128, and ragged S (no multiple of the 64-row tile), down to S = 1;
# then the edges of the bf16 kernel's 128-row and 128-key tiles at each
# head dim, a window that is no multiple of its tile, and the head maps of
# qwen3-moe (64 q heads on 4 KV heads) and dbrx (48 on 8)
FLASH_CASES = [(1, 4, 2, 256, 64, True, 0), (2, 8, 8, 128, 32, True, 0),
               (1, 8, 1, 256, 64, True, 0), (1, 4, 4, 256, 64, True, 96),
               (1, 2, 1, 128, 64, False, 0),
               (2, 16, 16, 512, 80, False, 0), (1, 32, 8, 512, 128, True, 0),
               (1, 8, 2, 1024, 128, True, 256),
               (1, 4, 2, 200, 80, True, 0), (1, 4, 2, 200, 80, False, 0),
               (1, 4, 2, 1000, 128, True, 96), (1, 2, 1, 37, 32, True, 5),
               (1, 2, 2, 300, 64, False, 64), (1, 2, 1, 1, 64, True, 0),
               (1, 4, 2, 127, 64, True, 0), (1, 4, 2, 128, 128, False, 0),
               (1, 4, 2, 129, 80, True, 0), (1, 2, 1, 255, 128, True, 0),
               (1, 2, 2, 257, 32, False, 0), (1, 4, 1, 1000, 128, True, 100),
               (1, 64, 4, 512, 128, True, 0), (1, 48, 8, 512, 128, True, 0)]
FLASH_TOLS = [("float32", (2e-5, 2e-5)), ("bfloat16", (2.0 ** -7, 1e-5))]


def _qkv(dev, B, H, KV, S, hd, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]


def _flash_check(q, k, v, causal, window, tol):
    """One launch, on the tensor-core kernel iff bf16, within ``tol`` of the
    plain version."""
    before = flash_attention.LAUNCHES, flash_attention.TC_LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, window=window, mode="on")
    tc = int(q.dtype == torch.bfloat16)
    assert (flash_attention.LAUNCHES, flash_attention.TC_LAUNCHES) == (
        before[0] + 1, before[1] + tc)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("dtype,tol", FLASH_TOLS)
@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, H, KV, S, hd, causal,
                                              window, dtype, tol):
    q, k, v = _qkv(cuda, B, H, KV, S, hd, getattr(torch, dtype), S + H + hd)
    _flash_check(q, k, v, causal, window, tol)


@pytest.mark.parametrize("dtype,tol", FLASH_TOLS)
@pytest.mark.parametrize("B,H,KV,S,hd,causal,window",
                         [(1, 8, 2, 1000, 128, True, 0),
                          (1, 4, 4, 300, 80, False, 0)])
def test_flash_attention_kernel_large_logits(cuda, B, H, KV, S, hd, causal,
                                             window, dtype, tol):
    """q x 8: scores of tens, so the running max moves often and far and
    the rescale (alpha) carries the result."""
    q, k, v = _qkv(cuda, B, H, KV, S, hd, getattr(torch, dtype), S + hd)
    _flash_check(q * 8, k, v, causal, window, tol)


def test_flash_attention_kernel_reads_strided_views(cuda):
    """The model's (B, S, H, hd) tensors, transposed to (B, H, S, hd) views:
    read in place, the output in the same layout, equal to the contiguous
    call."""
    B, S, H, KV, hd = 2, 333, 8, 2, 128
    q, k, v = _qkv(cuda, B, H, KV, S, hd, torch.bfloat16, 7)
    qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert not qv.is_contiguous()
    got = flash_attention.flash_attention(qv, kv, vv, causal=True)
    assert got.transpose(1, 2).is_contiguous()
    assert torch.equal(got, flash_attention.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "dbrx_132b"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_matches_the_plain_dispatch(cuda, arch, cf):
    """models.moe.moe_apply on the card (the index_put scatter into the
    capacity buffer, the batched SwiGLU, the gather) against
    chip_smoke.moe_apply_plain (per expert: gather by index, SwiGLU,
    index_add by gate) at the smoke config's width in f32 over Zipf-picked
    rows: the keep mask and the dropped share equal, the output within
    1e-5 of its scale (the same products, summed by other shapes)."""
    import importlib
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import RouteRecorder, moe_apply_plain
    from repro_torch.data.synthetic import zipf_tokens
    from repro_torch.models import moe
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").smoke_config()
    cfg = cfg.replace(capacity_factor=cf)
    gen = torch.Generator(device=cuda).manual_seed(3)
    p = moe.moe_init(gen, cfg)
    table = torch.randn((64, cfg.d_model), generator=gen, device=cuda)
    x = table[torch.from_numpy(zipf_tokens(2, 256, 64, seed=3)).to(cuda).long()]
    with RouteRecorder() as rec:
        out, (_, dropped) = moe.moe_apply(p, cfg, x)
    want, keep, want_dropped = moe_apply_plain(p, cfg, x)
    torch.cuda.synchronize()
    assert torch.equal(rec.keep[0], keep) and not bool(keep.all())
    assert float(dropped) == float(want_dropped)
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_flash_attention_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 4, 2, 64, 64, torch.float32, 0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_attention.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_attention.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_attention.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention(*_qkv(cuda, 1, 4, 2, 64, 96,
                                              torch.float32, 0))
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention.flash_attention(*_qkv(cuda, 1, 4, 3, 64, 64,
                                              torch.float32, 0))
    with pytest.raises(ValueError, match="layout"):
        flash_attention.flash_attention(q.transpose(2, 3), k, v)
    wide = torch.zeros((1, 4, 64, 65), device=cuda)
    with pytest.raises(ValueError, match="layout"):   # rows of 65 floats
        flash_attention.flash_attention(wide[..., 1:], k, v)


def _edge_fingerprint(run) -> dict:
    """tests/test_determinism.py's fingerprint of an edge run."""
    return {
        "ledger": run.ledger.summary(),
        "drops": [tuple(sorted(d.dropped)) for d in run.edge.decisions],
        "excluded": [tuple(sorted(d.excluded)) for d in run.edge.decisions],
        "cohorts": [tuple(sorted(d.selected)) for d in run.edge.decisions],
        "bandwidths": [tuple(np.asarray(d.bandwidth()).tolist())
                       for d in run.edge.decisions],
        "codecs": [tuple(None if d.codec_for(i) is None
                         else d.codec_for(i).spec() for i in d.selected)
                   for d in run.edge.decisions],
        "clock_s": run.edge.clock.now,
        "energy_j": run.edge.energy_j,
    }


def test_adaptive_codec_edge_run_kernels_off_beside_auto(cuda):
    """fim_lbfgs under the adaptive_codec policy (per-client top-k at the
    ratio the channel schedules) at the reduced CNN: kernels="auto" runs
    fim_diag, the Gram and topk_select at per-client k, kernels="off"
    none of them, and the simulation's fingerprint is the same."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.paper_models import reduced
    from repro_torch.data.synthetic import make_classification
    from repro_torch.edge import ChannelConfig, DeviceConfig, EdgeConfig
    from repro_torch.fed.server import FederatedRun

    edge = EdgeConfig(
        channel=ChannelConfig(bandwidth_hz=2e5, snr_db_mean=10.0,
                              snr_db_std=3.0, fading="rayleigh",
                              server_rate_bps=50e6),
        device=DeviceConfig(flops_per_s_mean=2e9, flops_per_s_sigma=1.0),
        scheduler="adaptive_codec", adaptive_ratio=0.25,
        adaptive_ratio_floor=0.02, deadline_s=5.0, enforce_deadline_s=1.4)
    mcfg = reduced(FMNIST_CNN)
    train, test = make_classification(mcfg, n_train=300, n_test=100, seed=0,
                                      noise=0.5)
    prints, launches = [], []
    for kernels in ("auto", "off"):
        fcfg = FedConfig(num_clients=8, participation=1.0, local_epochs=1,
                         batch_size=32, noniid_l=2, seed=0, max_step_norm=0.5,
                         fim_damping=0.05, fim_ema=0.9, kernels=kernels,
                         edge=edge)
        run = FederatedRun(mcfg, fcfg, train, test, "fim_lbfgs",
                           device=cuda)
        before = (fim_diag.LAUNCHES, vlbfgs.LAUNCHES, codec_ops.TOPK_LAUNCHES)
        hist = run.run(rounds=3, eval_every=3)
        torch.cuda.synchronize()
        launches.append((fim_diag.LAUNCHES - before[0],
                         vlbfgs.LAUNCHES - before[1],
                         codec_ops.TOPK_LAUNCHES - before[2]))
        prints.append(_edge_fingerprint(run))
        assert all(np.isfinite(h["loss"]) for h in hist if "loss" in h)
    assert prints[0] == prints[1]
    assert launches[1] == (0, 0, 0)
    landed = sum(len(d.survivors) for d in run.edge.decisions)
    coded = sum(1 for d in run.edge.decisions for i in d.survivors
                if d.codec_for(i) is not None)
    steps = sum(1 for d in run.edge.decisions if d.survivors)
    assert launches[0] == (landed, steps, coded)
    ks = {c for row in prints[0]["codecs"] for c in row if c is not None}
    assert len(ks) >= 2, ks


def test_cohort_fisher_one_launch_a_64_matrices(cuda):
    """The cohort path's Γ at the F-MNIST CNN's full width: K = 20 slots of
    8 leaves are 160 (B, D) matrices in ceil(160 / 64) = 3 launches, each
    slot within 1e-5 of the plain version (the oracle) on the same
    per-example gradients."""
    from repro_torch.core import fim
    from repro_torch.utils.pytree import tree_map

    K, B = 20, 8
    params = tree_map(lambda p: p.to(cuda),
                      cnn.init(FMNIST_CNN, torch.Generator().manual_seed(0)))
    gen = torch.Generator(device=cuda).manual_seed(1)
    xs = torch.rand((K, B, 28, 28, 1), generator=gen, device=cuda)
    ys = torch.randint(0, 10, (K, B), generator=gen, device=cuda)
    pel = cnn.per_example_loss_fn(FMNIST_CNN)
    before = fim_diag.LAUNCHES
    got = fim.cohort_per_example_diag(pel, params, xs, ys, kernels="on")
    torch.cuda.synchronize()
    assert fim_diag.LAUNCHES == before + 3
    want = fim.cohort_per_example_diag(pel, params, xs, ys, kernels="off")
    assert fim_diag.LAUNCHES == before + 3
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert a.shape[0] == K
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", ["uniform", "bandwidth_opt", "energy_opt"])
def test_fleet_device_backend_on_the_card_matches_exact(cuda, policy):
    """The fleet engine's fused float64 backend on the card against the
    numpy ``exact`` backend: the same cohorts and drop counts, clock,
    energy and batteries within rtol 1e-9."""
    from repro_torch.edge import (ChannelConfig, DeviceConfig, EdgeConfig,
                                  FleetEngine)

    cfg = EdgeConfig(
        channel=ChannelConfig(bandwidth_hz=2e5, snr_db_mean=10.0,
                              snr_db_std=3.0, fading="rayleigh",
                              server_rate_bps=50e6),
        device=DeviceConfig(flops_per_s_mean=2e9, flops_per_s_sigma=1.0,
                            battery_j=50.0),
        scheduler=policy, deadline_s=5.0, min_clients=1,
        enforce_deadline_s=3.0, reallocate=True)
    engines = [FleetEngine(cfg, 3000, up_bytes=80_000.0, flops=1e9,
                           down_bytes=40_000.0, backend=b, device=cuda)
               for b in ("exact", "jit")]
    ex, jt = engines
    for _ in range(4):
        ra, rb = ex.run_round(300), jt.run_round(300)
        assert np.array_equal(ex.last_decision.selected,
                              jt.last_decision.selected)
        assert ra["dropped"] == rb["dropped"]
        assert np.isclose(ra["wall_s"], rb["wall_s"], rtol=1e-9, atol=0)
    assert np.isclose(ex.clock_s, jt.clock_s, rtol=1e-9, atol=0)
    assert np.isclose(ex.energy_j, jt.energy_j, rtol=1e-9, atol=0)
    assert np.allclose(ex.state.battery_j, jt.state.battery_j, rtol=1e-9,
                       atol=0)
