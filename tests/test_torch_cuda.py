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

from repro_torch.kernels import (codec_ops, fim_diag,  # noqa: E402
                                 flash_attention, ops, ref, vlbfgs)

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
    got = codec_ops.int8_roundtrip(x, u, s)
    assert codec_ops.LAUNCHES == before + 1
    want = ref.int8_roundtrip_ref(x, u, s)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        fim_diag.fim_diag(torch.zeros((4, 8), device=cuda, dtype=torch.float16),
                          torch.zeros(8, device=cuda), 0.0)
    with pytest.raises(ValueError):
        vlbfgs.gram(torch.zeros((65, 8), device=cuda))
    with pytest.raises(ValueError):
        codec_ops.int8_roundtrip(torch.zeros(4, device=cuda),
                                 torch.zeros(5, device=cuda),
                                 torch.ones((), device=cuda))


TOPK_CASES = [(8, 2), (35, 4), (1000, 100), (5000, 1), (2048, 2048),
              (1537, 700), (1024, 1), (4097, 1), (4097, 4097), (4096, 4095),
              (100_003, 10_001), (206_922, 20_693), (413_844, 41_385)]


def _topk_check(x, k):
    before = codec_ops.TOPK_LAUNCHES
    got = ops.topk_select(x, k, mode="on")
    assert codec_ops.TOPK_LAUNCHES == before + 1
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
