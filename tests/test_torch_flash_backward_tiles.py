"""The bf16 flash backward's arithmetic (``csrc/flash_attention.cu``,
``tc::flash_bwd_dq_kernel`` and ``tc::flash_bwd_dkdv_kernel``), emulated in
plain torch on the CPU and held against an f64 reference and against the
plain path it replaces (autograd through ``models.attention._chunked_attention``
on the same bf16 inputs).

The emulation does what the kernels do, in their tiles: from the forward's
f32 output and log-sum-exp, D = rowsum(dO o O) in f32; the dQ pass over
128-row q tiles and 64-key steps from the first key the window keeps to the
last the causal mask keeps; the dK/dV pass over 128-key tiles and 64-row q
steps of each of the G query heads, from the first query that sees the
tile to the last; in both, S from bf16 operands with f32 sums, P = 2^(S c -
lse log2 e) with the finite masks, dP likewise, dS = P o (dP - D), and P and
dS entering their products as bf16 hi + lo; dq, dk, dv rounded once.  Its
norm-relative error against the f64 reference must be within 1.1x the
plain path's own: both round once to bf16 (~1.6e-3 of the norm), and the
split leaves the error before that rounding far below it (the emulation
reads 1.000x; the card test holds the kernel to 1.5x).  The control feeds P
and dS as one bf16 each, the usual tensor-core design, which adds an error
of the rounding's own size: it must exceed 1.2x (it reads ~1.4x), or the
split would not be needed.
"""
import math

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro_torch.configs import granite_8b  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import attention  # noqa: E402

BLK, STEP = 128, 64      # tc::kBwdBlk, tc::kBwdStep
NEG_INF = -1e30
BF16 = torch.bfloat16

# B, H, KV, S, hd, causal, window
CASES = [(1, 4, 1, 256, 64, True, 0), (1, 4, 4, 200, 32, False, 0),
         (1, 2, 1, 300, 128, True, 96), (1, 8, 2, 384, 64, True, 0),
         (1, 2, 2, 190, 80, False, 50), (2, 4, 2, 128, 32, True, 0),
         (1, 2, 1, 37, 32, True, 5)]


def _live(qpos, kpos, S, causal, window):
    live = (kpos < S) & (qpos < S)
    if causal:
        live = live & (qpos >= kpos)
    if window:
        live = live & (kpos > qpos - window)
    return live


def _split(x, split: bool):
    hi = x.to(BF16).float()
    return (hi, (x - hi).to(BF16).float()) if split else (hi, torch.zeros_like(x))


def _forward_saved(q, k, v, causal, window):
    """The forward's f32 output and natural log-sum-exp (f32)."""
    G = q.shape[1] // k.shape[1]
    S, hd = q.shape[2], q.shape[3]
    kf = k.float().repeat_interleave(G, 1)
    vf = v.float().repeat_interleave(G, 1)
    s = (q.float() @ kf.transpose(-1, -2)) * hd ** -0.5
    pos = torch.arange(S)
    s = torch.where(_live(pos[:, None], pos[None, :], S, causal, window), s,
                    NEG_INF)
    lse = torch.logsumexp(s, -1)
    return torch.softmax(s, -1) @ vf, lse


def emulate_backward(q, k, v, dout, causal, window, split=True):
    """The kernels' arithmetic -> dq, dk, dv in bf16."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = hd ** -0.5
    c = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    o32, lse = _forward_saved(q, k, v, causal, window)
    l2 = lse * math.log2(math.e)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    dsum = (dof * o32).sum(-1)
    dq = torch.zeros((B, H, S, hd))
    dk = torch.zeros((B, KV, S, hd))
    dv = torch.zeros((B, KV, S, hd))
    for b in range(B):
        for h in range(H):
            kvh = h // G
            for q0 in range(0, S, BLK):
                q_last = min(q0 + BLK, S) - 1
                k_first = max(0, q0 - window + 1) if window else 0
                k_last = q_last if causal else S - 1
                rows = torch.arange(q0, min(q0 + BLK, S))
                for k0 in range(k_first // STEP * STEP, k_last + 1, STEP):
                    cols = torch.arange(k0, min(k0 + STEP, S))
                    s = qf[b, h, rows] @ kf[b, kvh, cols].T
                    p = torch.exp2(s * c - l2[b, h, rows, None])
                    p = torch.where(_live(rows[:, None], cols[None, :], S,
                                          causal, window), p, 0.0)
                    dp = dof[b, h, rows] @ vf[b, kvh, cols].T
                    ds = p * (dp - dsum[b, h, rows, None])
                    hi, lo = _split(ds, split)
                    dq[b, h, rows] += hi @ kf[b, kvh, cols] + lo @ kf[b, kvh, cols]
        for kvh in range(KV):
            for k0 in range(0, S, BLK):
                k_last = min(k0 + BLK, S) - 1
                q_first = k0 if causal else 0
                q_last = min(S - 1, k_last + window - 1) if window else S - 1
                keys = torch.arange(k0, k_last + 1)
                for g in range(G):
                    h = kvh * G + g
                    for q0 in range(q_first // STEP * STEP, q_last + 1, STEP):
                        rows = torch.arange(q0, min(q0 + STEP, S))
                        st = kf[b, kvh, keys] @ qf[b, h, rows].T
                        pt = torch.exp2(st * c - l2[b, h, None, rows])
                        pt = torch.where(_live(rows[None, :], keys[:, None], S,
                                               causal, window), pt, 0.0)
                        hi, lo = _split(pt, split)
                        dv[b, kvh, keys] += hi @ dof[b, h, rows] + lo @ dof[b, h, rows]
                        dpt = vf[b, kvh, keys] @ dof[b, h, rows].T
                        dst = pt * (dpt - dsum[b, h, None, rows])
                        hi, lo = _split(dst, split)
                        dk[b, kvh, keys] += hi @ qf[b, h, rows] + lo @ qf[b, h, rows]
    return (dq * scale).to(BF16), (dk * scale).to(BF16), dv.to(BF16)


def _f64_grads(q, k, v, dout, causal, window):
    """The exact gradients of the bf16 inputs' attention, in f64."""
    G = q.shape[1] // k.shape[1]
    S, hd = q.shape[2], q.shape[3]
    ins = [t.double().requires_grad_() for t in (q, k, v)]
    s = (ins[0] @ ins[1].repeat_interleave(G, 1).transpose(-1, -2)) * hd ** -0.5
    pos = torch.arange(S)
    s = torch.where(_live(pos[:, None], pos[None, :], S, causal, window), s,
                    NEG_INF)
    out = torch.softmax(s, -1) @ ins[2].repeat_interleave(G, 1)
    return torch.autograd.grad(out, ins, dout.double())


def _plain_grads(q, k, v, dout, causal, window):
    """Autograd through the chunked plain path on the same bf16 inputs."""
    H, KV, hd = q.shape[1], k.shape[1], q.shape[3]
    cfg = granite_8b.smoke_config().replace(
        num_heads=H, num_kv_heads=KV, head_dim=hd, dtype="bfloat16",
        attn_variant="sliding_window" if window else "full",
        window=window or 4096)
    ins = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
    out = attention._chunked_attention(*ins, cfg, torch.arange(q.shape[2]),
                                       causal)
    return [g.transpose(1, 2) for g in torch.autograd.grad(
        out, ins, dout.transpose(1, 2))]


def _inputs(B, H, KV, S, hd, seed):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen).to(BF16)
               for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))
    dout = torch.randn((B, H, S, hd), generator=gen).to(BF16)
    return q, k, v, dout


def _rel(got, want):
    return float((got.double() - want).norm() / want.norm())


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", CASES)
def test_backward_arithmetic_as_accurate_as_the_plain_path(B, H, KV, S, hd,
                                                           causal, window):
    q, k, v, dout = _inputs(B, H, KV, S, hd, S + hd)
    exact = _f64_grads(q, k, v, dout, causal, window)
    plain = _plain_grads(q, k, v, dout, causal, window)
    got = emulate_backward(q, k, v, dout, causal, window)
    for name, g, p, x in zip("qkv", got, plain, exact):
        assert g.dtype == BF16 and bool(torch.isfinite(g.float()).all())
        assert _rel(g, x) <= 1.1 * _rel(p, x), (name, _rel(g, x), _rel(p, x))


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", CASES[:4])
def test_single_bf16_p_and_ds_break_the_bound(B, H, KV, S, hd, causal,
                                              window):
    q, k, v, dout = _inputs(B, H, KV, S, hd, S + hd)
    exact = _f64_grads(q, k, v, dout, causal, window)
    plain = _plain_grads(q, k, v, dout, causal, window)
    got = emulate_backward(q, k, v, dout, causal, window, split=False)
    assert all(_rel(g, x) > 1.2 * _rel(p, x)
               for g, p, x in zip(got, plain, exact))


def test_row_padding_mirrors_the_kernel():
    """The wrapper pads lse and D to the kernels' 128-row tiles."""
    src = (flash_attention._build.CSRC / "flash_attention.cu").read_text()
    assert f"constexpr int kBwdBlk = {BLK};" in src
    assert f"constexpr int kBwdStep = {STEP};" in src
    assert f"constexpr int kBM = {flash_attention.ROW_PAD};" in src
