"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card.  Marked ``cuda``: on a host without a CUDA device every test skips
with the reason.  This file imports neither JAX nor the reference, so it
runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fim_diag and the Gram sum in other orders than the plain
versions (f32 accumulation), so 1e-5 relative (the Gram relative to its
largest entry, against an f64 plain product); int8 and the top-k select
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


@pytest.mark.parametrize("n,D", [(5, 512), (21, 4096), (21, 10_001), (9, 64),
                                 (9, 12_300), (21, 206_922), (64, 5000),
                                 (1, 1)])
def test_gram_kernel_matches_plain(cuda, n, D):
    gen = torch.Generator(device=cuda).manual_seed(n + D)
    basis = torch.randn((n, D), generator=gen, device=cuda)
    before = vlbfgs.LAUNCHES
    got = ops.vlbfgs_gram(basis, mode="on")
    assert vlbfgs.LAUNCHES == before + 1
    want = ref.vlbfgs_gram_ref(basis.double()).float()
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got / scale, want / scale, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, got.T)


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
    shapes = [tuple(p.shape) for p in tree_leaves(
        cnn.init(FMNIST_CNN, torch.Generator().manual_seed(0)))]
    return shapes + shapes


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
# head dim, and a window that is no multiple of its tile
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
               (1, 2, 2, 257, 32, False, 0), (1, 4, 1, 1000, 128, True, 100)]
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
