"""The bf16 tensor-core flash kernel's arithmetic (``csrc/flash_attention.cu``,
``tc::flash_tc_kernel``), emulated in plain torch on the CPU and held against
the reference (``repro.kernels.ref.flash_attention_ref``, and its Pallas kernel
in interpret mode where that kernel is defined: S <= 128 or a multiple of 128)
at the bound the card holds the kernel to: one bf16 ulp, |got - want| <=
2^-7 |want| + 1e-5.

The emulation does what the kernel does, in its order: 128-key tiles; S = Q K^T
from bf16 operands with f32 products and sums; the masks with the finite -1e30
on the unscaled S; the online max, rescale and sum in f32, with hd^-0.5 (times
log2 e) applied in f32 after the product, inside the exponent: p = 2^(s c -
m c), one fused multiply-add, and p = 0 while a row has met no live key
(m = -1e30); P split as P_hi = bf16(P),
P_lo = bf16(P - P_hi), both multiplied by the bf16 V tile into one f32
accumulator; O / max(l, 1e-30) rounded to bf16 once.  The control runs the
same with a single bf16 P, the usual tensor-core design: it must break the
bound, or the split would not be needed.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402

BLOCK_N = 128            # keys per tile (tc::kBN)
NEG_INF = -1e30
RTOL, ATOL = 2.0 ** -7, 1e-5   # chip_smoke.py's FLASH_BF16_RTOL / ATOL

# B, H, KV, S, hd, causal, window
CASES = [(1, 4, 2, 512, 64, True, 0), (1, 4, 4, 512, 80, False, 0),
         (1, 4, 2, 300, 128, True, 96), (1, 4, 2, 1000, 128, True, 0),
         (1, 4, 4, 200, 32, False, 0), (1, 2, 1, 4096, 128, True, 0),
         (1, 2, 1, 37, 32, True, 5), (1, 4, 1, 1000, 128, True, 100),
         (2, 4, 2, 128, 64, False, 0), (1, 2, 2, 256, 80, True, 200)]


def emulate(q, k, v, causal: bool, window: int, split: bool = True):
    """The kernel's arithmetic on bf16 q (B,H,S,hd), k, v (B,KV,S,hd) ->
    bf16 (B,H,S,hd).  ``split=False`` rounds P to bf16 once instead."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    c = np.float32(np.float32(hd ** -0.5) * np.float32(math.log2(math.e)))
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    qpos = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), NEG_INF)
    lsum = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, BLOCK_N):
        kt, vt = kf[:, :, k0:k0 + BLOCK_N], vf[:, :, k0:k0 + BLOCK_N]
        s = qf @ kt.transpose(-1, -2)
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        live = torch.ones((S, kt.shape[2]), dtype=torch.bool)
        if causal:
            live &= qpos >= kpos
        if window:
            live &= kpos > qpos - window
        s = torch.where(live, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * float(c))
        mc = torch.where(m_new == NEG_INF, 0.0, m_new * float(c))
        # fma(s, c, -mc): the product is exact in f64, then one rounding to f32
        p = torch.exp2((s.double() * float(c) - mc.double()).float())
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vt
        if split:
            pv = pv + (p - p_hi).bfloat16().float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / lsum.clamp_min(1e-30)).bfloat16()


def _inputs(B, H, KV, S, hd, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32).astype(ml_dtypes.bfloat16)
              for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]
    return arrays, [torch.from_numpy(a.astype(np.float32)).bfloat16() for a in arrays]


def _outside(got, want) -> torch.Tensor:
    """Outputs past the one-ulp bound."""
    got, want = got.float(), torch.from_numpy(np.array(want, np.float32))
    return (got - want).abs() > RTOL * want.abs() + ATOL


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", CASES)
def test_kernel_arithmetic_within_one_bf16_ulp_of_reference(B, H, KV, S, hd,
                                                            causal, window):
    jax_in, torch_in = _inputs(B, H, KV, S, hd, S * 7 + hd)
    got = emulate(*torch_in, causal, window)
    assert torch.isfinite(got.float()).all()
    jq, jk, jv = map(jnp.asarray, jax_in)
    wants = [rref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)]
    if S <= 128 or S % 128 == 0:
        wants.append(rops.flash_attention(jq, jk, jv, causal=causal,
                                          window=window, force_kernel=True))
    for want in wants:
        want = np.asarray(want.astype(jnp.float32))
        assert int(_outside(got, want).sum()) == 0


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", CASES)
def test_single_bf16_p_breaks_the_bound(B, H, KV, S, hd, causal, window):
    """The control: P rounded to bf16 once misses the bound on a share of
    the outputs (6-11 % in these cases), where the split misses none."""
    jax_in, torch_in = _inputs(B, H, KV, S, hd, S * 7 + hd)
    want = np.asarray(rref.flash_attention_ref(
        *map(jnp.asarray, jax_in), causal=causal, window=window).astype(jnp.float32))
    outside = _outside(emulate(*torch_in, causal, window, split=False), want)
    assert float(outside.float().mean()) > 0.01
