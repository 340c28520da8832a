"""The port's kernel layer: plain versions against the reference's oracles
on the CPU, and the device/mode dispatch table.  The hand-written CUDA
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances follow ``tests/test_kernels.py``: fim_diag 1e-5 (f32) / 5e-2
(bf16, 8-bit mantissa inputs), Gram 1e-5 relative to its largest entry;
the int8 round-trip and its scale are exact (bit-identical); flash
attention 2e-5 (f32) / 5e-2 (bf16 output, one bf16 ulp at |out| ~ 2).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro.kernels import codec_ops as rcodec  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.kernels import (codec_ops, fim_diag,  # noqa: E402
                                 flash_attention, ops, ref, vlbfgs)

FIM_SHAPES = [(8, 256), (64, 1000), (256, 4096), (5, 131), (300, 3000),
              (300, 5000), (257, 2049)]
GRAM_SHAPES = [(5, 512), (21, 4096), (21, 10_001), (9, 64), (9, 12_300)]
INT8_SHAPES = [(7,), (1000,), (33, 129), (4096,), (300, 17), (3, 3, 16, 16)]
# tests/test_kernels.py's FLASH_CASES: B, H, KV, S, hd, causal, window
FLASH_CASES = [(1, 4, 2, 256, 64, True, 0), (2, 8, 8, 128, 32, True, 0),
               (1, 8, 1, 256, 64, True, 0), (1, 4, 4, 256, 64, True, 96),
               (1, 2, 1, 128, 64, False, 0)]


# ------------------------------------------------------ plain vs reference
@pytest.mark.parametrize("B,D", FIM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fim_diag_plain_matches_reference(B, D, dtype):
    rng = np.random.default_rng(B * D)
    g = rng.normal(size=(B, D)).astype(np.float32)
    old = rng.uniform(size=D).astype(np.float32)
    if dtype == "bfloat16":
        g_np = g.astype(ml_dtypes.bfloat16)
        g_t = torch.from_numpy(g_np.astype(np.float32)).to(torch.bfloat16)
        tol = 5e-2
    else:
        g_np, g_t, tol = g, torch.from_numpy(g), 1e-5
    want = np.asarray(rops.fim_diag_update(jnp.asarray(g_np), jnp.asarray(old),
                                           0.9, force_kernel=True))
    got = ops.fim_diag_update(g_t, torch.from_numpy(old), 0.9).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("n,D", GRAM_SHAPES)
def test_gram_plain_matches_reference(n, D):
    basis = np.random.default_rng(n + D).normal(size=(n, D)).astype(np.float32)
    want = np.asarray(rops.vlbfgs_gram(jnp.asarray(basis), force_kernel=True))
    got = ops.vlbfgs_gram(torch.from_numpy(basis)).numpy()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_plain_bit_identical_to_reference(shape):
    rng = np.random.default_rng(int(np.prod(shape)))
    x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    u = rng.uniform(size=shape).astype(np.float32)
    r_scale = rref.int8_scale(jnp.asarray(x))
    p_scale = ref.int8_scale(torch.from_numpy(x))
    # the scale: correctly rounded max|x| / 127, as numpy computes it
    assert np.float32(p_scale.numpy()) == np.float32(np.asarray(r_scale))
    assert np.float32(p_scale.numpy()) == np.abs(x).max() / np.float32(127)
    want = np.asarray(rcodec.int8_roundtrip(jnp.asarray(x), jnp.asarray(u),
                                            r_scale, interpret=True))
    got = ref.int8_roundtrip_ref(torch.from_numpy(x), torch.from_numpy(u),
                                 p_scale).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_int8_scale_bit_identical_on_many_magnitudes():
    """One division per tensor, over 20k magnitudes spanning 1e-30..1e30:
    a multiply by the f32 reciprocal of 127 would miss some of them."""
    rng = np.random.default_rng(0)
    mags = (10.0 ** rng.uniform(-30, 30, size=20_000)).astype(np.float32)
    want = np.maximum(mags, np.float32(1e-12)) / np.float32(127)
    got = np.array([float(ref.int8_scale(torch.tensor([m, -m / 2])))
                    for m in mags[:2000]], np.float32)
    np.testing.assert_array_equal(got, want[:2000])
    # the same expression elementwise over all of them
    x = torch.from_numpy(mags)
    vec = torch.clamp_min(x, 1e-12) / torch.full((), 127.0)
    np.testing.assert_array_equal(vec.numpy(), want)


def test_int8_scale_of_all_zero_tensor():
    z = torch.zeros(5)
    assert float(ref.int8_scale(z)) == float(rref.int8_scale(jnp.zeros(5)))
    assert torch.equal(ref.int8_roundtrip_ref(z, torch.rand(5)), z)


def _qkv(B, H, KV, S, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, S, hd)).astype(np.float32),
            rng.normal(size=(B, KV, S, hd)).astype(np.float32),
            rng.normal(size=(B, KV, S, hd)).astype(np.float32))


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", FLASH_CASES)
def test_flash_attention_plain_matches_reference_and_its_kernel(
        B, H, KV, S, hd, causal, window):
    """The plain version against the reference's oracle and its Pallas
    kernel in interpret mode, at S <= 128 or a multiple of 128 (where the
    Pallas kernel is defined, see the ragged test below)."""
    q, k, v = _qkv(B, H, KV, S, hd, S + H)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                              window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (rref.flash_attention_ref(jq, jk, jv, causal=causal, window=window),
                 rops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                      force_kernel=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_attention_plain_bf16_matches_reference():
    q, k, v = _qkv(1, 4, 2, 128, 64, 0)
    jb = [jnp.asarray(a.astype(ml_dtypes.bfloat16)) for a in (q, k, v)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ops.flash_attention(*tb)
    assert got.dtype == torch.bfloat16
    for want in (rref.flash_attention_ref(*jb),
                 rops.flash_attention(*jb, force_kernel=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96)])
def test_flash_attention_plain_ragged_s_matches_the_oracle(causal, window):
    """S = 200 (> 128, no multiple of 128): against the reference's oracle
    only, since its Pallas kernel reads NaN there (its padded tail tile is
    not masked by ``kpos < S``; a reference caveat, see ROADMAP)."""
    q, k, v = _qkv(1, 4, 2, 200, 80, 200)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                              window=window).numpy()
    want = rref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                                    window=window)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------- dispatch
def test_resolve_table_on_cpu():
    assert ops.resolve("auto", "cpu") == "plain"
    assert ops.resolve("off", "cpu") == "plain"
    assert ops.resolve("auto", "cuda") == "kernel"
    assert ops.resolve("on", "cuda") == "kernel"
    assert ops.resolve("off", "cuda") == "plain"
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ops.resolve("on", "cpu")
    with pytest.raises(ValueError, match="kernels mode"):
        ops.resolve("sometimes", "cpu")


@pytest.mark.parametrize("m,D", [(1, 512), (4, 4097), (10, 12_300)])
def test_gram_leaves_plain_mixed_dtypes_matches_pallas_bf16(m, D):
    """The plain Gram over a bf16 history (s, y) beside an f32 g against
    the Pallas kernel on the same values as one bf16 (2m+1, D) basis
    (``force_kernel``, interpret mode on the CPU), which casts each tile
    to f32 in the kernel: g's row is bf16 there and its exact f32 widening
    here, so the two compute one function.  Each entry within 1e-5 of its
    Cauchy-Schwarz scale, sqrt(G_ii G_jj); the leaves cut D into three
    with a ragged last one, and the plain version's column blocks cut
    them again (``block``)."""
    rng = np.random.default_rng(m * D)
    basis = rng.normal(size=(2 * m + 1, D)).astype(ml_dtypes.bfloat16)
    want = np.asarray(rops.vlbfgs_gram(jnp.asarray(basis), force_kernel=True),
                      np.float64)
    b = torch.from_numpy(basis.astype(np.float32)).bfloat16()
    cuts = [0, D // 3, D // 3 + D // 2, D]
    s = [b[:m, a:c].contiguous() for a, c in zip(cuts, cuts[1:])]
    y = [b[m:2 * m, a:c].contiguous() for a, c in zip(cuts, cuts[1:])]
    g = [b[2 * m, a:c].float() for a, c in zip(cuts, cuts[1:])]
    for got in (ops.vlbfgs_gram_leaves(s, y, g),
                ref.vlbfgs_gram_leaves_ref(s, y, g, block=1000)):
        d = np.sqrt(np.diagonal(want))
        err = np.abs(got.numpy() - want) / np.outer(d, d)
        assert err.max() <= 1e-5
    assert ops.vlbfgs_gram(b).dtype == torch.float32
    np.testing.assert_allclose(ops.vlbfgs_gram(b).numpy(),
                               ops.vlbfgs_gram_leaves(s, y, g).numpy(),
                               rtol=1e-5, atol=1e-5 * float(want.max()))


def test_on_with_cpu_tensors_raises_everywhere():
    g = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        ops.fim_diag_update(g, torch.zeros(8), 0.0, mode="on")
    with pytest.raises(ValueError):
        ops.vlbfgs_gram(torch.zeros((3, 8)), mode="on")
    with pytest.raises(ValueError):
        ops.int8_roundtrip(torch.ones(8), torch.Generator(), mode="on")
    with pytest.raises(ValueError):
        ops.flash_attention(torch.zeros((1, 2, 4, 32)), torch.zeros((1, 1, 4, 32)),
                            torch.zeros((1, 1, 4, 32)), mode="on")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches on CUDA tensors only; it never runs the plain
    version itself."""
    with pytest.raises(ValueError, match="CUDA"):
        fim_diag.fim_diag(torch.zeros((2, 3)), torch.zeros(3), 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        vlbfgs.gram(torch.zeros((3, 5)))
    with pytest.raises(ValueError, match="CUDA"):
        codec_ops.int8_roundtrip_leaves([torch.zeros(3)], [torch.zeros(3)])
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(torch.zeros((1, 2, 4, 32)),
                                        torch.zeros((1, 1, 4, 32)),
                                        torch.zeros((1, 1, 4, 32)))


def test_flash_attention_modes_agree_on_the_cpu():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 64, 32, 1))
    outs = [ops.flash_attention(q, k, v, causal=False, window=16, mode=m)
            for m in ("auto", "off")]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], ref.flash_attention_ref(q, k, v, causal=False,
                                                        window=16))


def test_int8_modes_agree_and_draw_the_same_stream():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=257)
                         .astype(np.float32))
    outs = [ops.int8_roundtrip(x, torch.Generator().manual_seed(3), mode=m)
            for m in ("auto", "off")]
    assert torch.equal(outs[0], outs[1])
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(outs[0], ref.int8_roundtrip_ref(x, u, ref.int8_scale(x)))
