"""Plain PyTorch versions of the hand-written kernels.

They run for CPU tensors, under ``kernels="off"``, and in ``chip_smoke.py``
as the reference each CUDA kernel is held against.  Each restates the
matching oracle of ``repro.kernels.ref``; the int8 pair (given the same
``x`` and ``u``) and the top-k select are bit-identical to it.
"""
from __future__ import annotations

import torch

# Radix-bucket geometry of the top-k select (the reference's
# ``repro.kernels.ref`` constants): nonnegative f32 magnitudes order like
# their bit patterns, so the top 32 - TOPK_SHIFT = 10 bits (sign 0, the 8
# exponent bits, 1 mantissa bit) are an order-preserving radix with 512
# reachable buckets; csrc/topk.cu uses the same two numbers.
TOPK_BUCKETS = 512
TOPK_SHIFT = 22
# the masked score of attention (finite, as the reference's: see
# csrc/flash_attention.cu for why not -inf)
NEG_INF = -1e30


def fim_diag_ref(grads: torch.Tensor, old_diag: torch.Tensor | None,
                 ema: float) -> torch.Tensor:
    """grads: (B, D) per-example (or per-microbatch) gradients;
    old_diag: (D,) f32 EMA state, or None for zeros.  Returns
    ema*old + (1-ema)*mean(g²) (with None, (1-ema)*mean(g²): the same
    values, since ema*0 + x is x)."""
    meansq = torch.mean(torch.square(grads.float()), dim=0)
    if old_diag is None:
        return (1.0 - ema) * meansq
    return ema * old_diag.float() + (1.0 - ema) * meansq


def vlbfgs_gram_ref(basis: torch.Tensor) -> torch.Tensor:
    """basis: (n, D) rows [s_0..s_{m-1}, y_0..y_{m-1}, g].
    Returns the (n, n) Gram matrix in f32."""
    b = basis.float()
    return b @ b.T


def int8_scale(x: torch.Tensor) -> torch.Tensor:
    """max|x|/127 (floored at 1e-12/127 for all-zero tensors), as a 0-d
    f32 tensor on x's device.

    The divisor is a device tensor on purpose: PyTorch's CUDA division by
    a Python scalar multiplies by the f32 reciprocal, which is not the
    correctly rounded quotient the reference (and numpy) computes."""
    amax = torch.clamp_min(torch.amax(torch.abs(x.float())), 1e-12)
    return amax / torch.full((), 127.0, dtype=torch.float32, device=x.device)


def int8_quantize(x: torch.Tensor, u: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """The int8 levels as integral f32 values in [-127, 127]:
    clip(floor(x/s) + (u < x/s - floor(x/s)), -127, 127)."""
    q = x.float() / scale
    lo = torch.floor(q)
    rnd = lo + (u.float() < (q - lo)).float()
    return torch.clamp(rnd, -127.0, 127.0)


def int8_roundtrip_ref(x: torch.Tensor, u: torch.Tensor,
                       scale: torch.Tensor | None = None) -> torch.Tensor:
    """Per-tensor symmetric int8 with stochastic rounding, dequantized."""
    s = int8_scale(x) if scale is None else scale
    return int8_quantize(x, u, s) * s


def topk_select_ref(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Zero all but the k largest-|x| entries of a 1-D payload by the
    bucketed threshold select: threshold bucket t is the largest with
    count(bucket >= t) >= k, and ties on t break by index order, so
    exactly k survive for 1 <= k <= n.  A kept -0.0 keeps its sign; the
    dropped entries are +0.0."""
    bucket = (torch.abs(flat.float()).view(torch.int32) >> TOPK_SHIFT).long()
    hist = torch.bincount(bucket, minlength=TOPK_BUCKETS)
    ge = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    ids = torch.arange(TOPK_BUCKETS, device=flat.device)
    t = torch.max(torch.where(ge >= k, ids, torch.zeros_like(ids)))
    need = k - (ge[t] - hist[t])
    tie = (bucket == t).long()
    rank = torch.cumsum(tie, 0) - tie        # exclusive index-order rank
    keep = (bucket > t) | ((tie == 1) & (rank < need))
    return torch.where(keep, flat, torch.zeros_like(flat))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd); GQA by head folding (query
    head h reads KV head h // (H/KV)).  Scores in f32 from q scaled by
    hd**-0.5 first, masked with the finite -1e30; f32 softmax; returns
    (B, H, S, hd) in q's dtype."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qf = q.reshape(B, KV, G, S, hd).float() * hd ** -0.5
    scores = torch.einsum("bkgqh,bksh->bkgqs", qf, k.float())
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", probs, v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)
