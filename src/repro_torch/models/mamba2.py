"""Mamba-2 (SSD, state-space duality) mixer: the chunked scan and the
one-step decode (port of ``repro.models.mamba2``).

The chunked SSD algorithm of Dao & Gu (arXiv:2405.21060): the sequence is
split into chunks of length Q (``cfg.ssm_chunk``, halved until it divides
S); within a chunk the recurrence is a masked quadratic form, and a Python
loop over the chunks (the reference's ``lax.scan``) carries the (heads,
head_dim, state) SSM state.  Decode is the dual recurrent form:
state <- exp(dt*A) * state + dt * B (x) x.  The conv and the SSM state are
f32 whatever the activation dtype.

One deliberate difference: the intra-chunk decay exp(cs_i - cs_j) is
taken after the mask (``-inf`` above the diagonal), where the reference
exponentiates first and masks after.  The forward is the same number; the
reference's gradient is NaN once a chunk's sum of dt passes f32's exp
range (~88: 0 * inf in the masked entries' backward), which the full
configs' 256-step chunks reach.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import constrain, dense_init, rms_norm
from repro_torch.utils import sharding as shd


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_state


def mamba_init(generator: torch.Generator, cfg, stack: int | None = None) -> dict:
    d = cfg.d_model
    d_in, nh, N = _dims(cfg)
    conv_ch = d_in + 2 * N  # x, B, C go through the depthwise conv
    lead = (stack,) if stack else ()
    dtype, dev = cfg.activation_dtype, generator.device
    conv_w = torch.randn(lead + (cfg.ssm_conv, conv_ch), generator=generator,
                         device=dev)
    return {
        # order: [z (d_in), x (d_in), B (N), C (N), dt (nh)]
        "in_proj": dense_init(generator, lead + (d, 2 * d_in + 2 * N + nh), dtype),
        "conv_w": conv_w.mul_(0.1).to(dtype),
        "A_log": torch.zeros(lead + (nh,), device=dev),
        "D": torch.ones(lead + (nh,), device=dev),
        "dt_bias": torch.zeros(lead + (nh,), device=dev),
        "norm": torch.ones(lead + (d_in,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, lead + (d_in, d), dtype),
    }


def mamba_axes(stack: int | None = None) -> dict:
    """The logical axes of ``mamba_init``'s tree."""
    pre = "layers," if stack else ""
    return {"in_proj": pre + "embed,ssm_inner", "conv_w": pre + "conv,ssm_inner",
            "A_log": pre + "ssm_heads", "D": pre + "ssm_heads",
            "dt_bias": pre + "ssm_heads", "norm": pre + "ssm_inner",
            "out_proj": pre + "ssm_inner,embed"}


def _split_proj(cfg, zxbcdt):
    d_in, _, N = _dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * N],
            zxbcdt[..., 2 * d_in + 2 * N:])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` at every x
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq, f32, then SiLU, cast back.
    xBC: (B, S, ch); conv_w: (K, ch).  Correlation convention: conv_w[K-1]
    multiplies the current step, as the decode window in ``mamba_decode``
    lays it out."""
    K, S = conv_w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(K):  # K is 4: unrolled taps
        out = out + pad[:, i:i + S].float() * conv_w[i].float()
    return F.silu(out).to(xBC.dtype)


class MambaState(NamedTuple):
    ssm: torch.Tensor    # (B, nh, hd, N) f32
    conv: torch.Tensor   # (B, K-1, conv_ch) f32, the last K-1 conv inputs


def state_init(cfg, batch: int, device) -> MambaState:
    d_in, nh, N = _dims(cfg)
    return MambaState(
        ssm=torch.zeros((batch, nh, cfg.ssm_head_dim, N), device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * N), device=device),
    )


def state_axes() -> MambaState:
    return MambaState(ssm="batch,ssm_heads,head_dim,ssm_state",
                      conv="batch,conv,ssm_inner")


def _chunk(state, xs_q, B_q, C_q, dt_q, dA_q):
    """One chunk of SSD: (state (B,nh,hd,N), inputs (B,Q,nh,hd) (B,Q,N)
    (B,Q,N) (B,Q,nh) (B,Q,nh)) -> (new state, y (B,Q,nh,hd))."""
    Q = dA_q.shape[1]
    cs = torch.cumsum(dA_q, dim=1)                           # (B,Q,nh)
    total = cs[:, -1]                                        # (B,nh)
    # inter-chunk: the carried state's contribution
    y_inter = torch.einsum("bqn,bhdn->bqhd", C_q, state) * torch.exp(cs)[..., None]
    # intra-chunk masked quadratic form; decay[i, j] = exp(cs_i - cs_j), i >= j
    mask = torch.ones((Q, Q), dtype=torch.bool, device=cs.device).tril()
    diff = cs[:, :, None, :] - cs[:, None, :, :]             # (B,Q,Q,nh)
    decay = torch.exp(torch.where(mask[None, :, :, None], diff, -torch.inf))
    scores = torch.einsum("bin,bjn->bij", C_q, B_q)[..., None] * decay
    dtx = dt_q[..., None] * xs_q                             # (B,Q,nh,hd)
    y_intra = torch.einsum("bijh,bjhd->bihd", scores, dtx)
    # the state: the old one decayed across the chunk, plus the chunk's
    # outer products
    w = torch.exp(total[:, None, :] - cs)[..., None] * dtx   # (B,Q,nh,hd)
    state = (state * torch.exp(total)[:, :, None, None]
             + torch.einsum("bqhd,bqn->bhdn", w, B_q))
    return state, y_inter + y_intra


def mamba_apply(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD. x: (B,S,d) -> (B,S,d).  On a mesh (DTensor x) the
    projections run on DTensors and the SSD between them on each rank's
    rows (``_ssd_on_local_rows``)."""
    zxbcdt = x @ p["in_proj"]
    if shd.is_dtensor(zxbcdt):
        y = _ssd_on_local_rows(p, cfg, zxbcdt, x.dtype)
    else:
        y = _ssd(p["conv_w"], p["A_log"], p["D"], p["dt_bias"], p["norm"],
                 zxbcdt, cfg=cfg, dtype=x.dtype)
    return constrain(y @ p["out_proj"], "batch,seq,embed")


_SSD_PARAMS = ("conv_w", "A_log", "D", "dt_bias", "norm")


def _ssd(conv_w, A_log, D, dt_bias, norm, zxbcdt, *, cfg, dtype):
    """The SSD between the projections: (B,S, 2·d_in+2N+nh) -> the gated,
    normed (B,S,d_in) in ``dtype``."""
    B, S, _ = zxbcdt.shape
    d_in, nh, N = _dims(cfg)
    hd = cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    while S % Q:
        Q //= 2

    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC, conv_w)
    xs = xBC[..., :d_in].reshape(B, S, nh, hd)
    Bm = xBC[..., d_in:d_in + N].float()                     # (B,S,N)
    Cm = xBC[..., d_in + N:].float()                         # (B,S,N)
    dt = _softplus(dt.float() + dt_bias)                     # (B,S,nh)
    dA = dt * -torch.exp(A_log)                              # (B,S,nh)
    xs_f = xs.float()

    state = torch.zeros((B, nh, hd, N), device=zxbcdt.device)
    ys = []
    for c in range(0, S, Q):
        q = slice(c, c + Q)
        state, y = _chunk(state, xs_f[:, q], Bm[:, q], Cm[:, q], dt[:, q],
                          dA[:, q])
        ys.append(y)
    y = torch.cat(ys, dim=1) + D[None, None, :, None] * xs_f
    return rms_norm(y.reshape(B, S, d_in).to(dtype), norm) * F.silu(z)


def _ssd_on_local_rows(p, cfg, zxbcdt, dtype):
    """``_ssd`` as a ``local_map``: the scan is independent over the batch,
    so each rank runs it on its rows, the projection gathered over the
    other mesh dims (its last dim packs z, x, B, C and dt, which a model
    shard would split across their boundaries) and the SSD's parameters
    replicated; their gradients are partial sums over the mesh dims that
    split the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rows = [Shard(0) if p_.is_shard(0) else Replicate()
            for p_ in zxbcdt.placements]
    rep = [Replicate()] * len(rows)
    grad = [Partial() if p_.is_shard() else Replicate() for p_ in rows]
    fn = local_map(
        lambda *a: _ssd(*a, cfg=cfg, dtype=dtype), out_placements=rows,
        in_placements=(rep,) * len(_SSD_PARAMS) + (rows,),
        in_grad_placements=(grad,) * len(_SSD_PARAMS) + (rows,),
        device_mesh=zxbcdt.device_mesh, redistribute_inputs=True)
    return fn(*(p[k] for k in _SSD_PARAMS), zxbcdt)


def mamba_decode(p, cfg, x: torch.Tensor, state: MambaState):
    """One-token decode. x: (B, 1, d) -> (out (B, 1, d), new MambaState)."""
    B = x.shape[0]
    d_in, nh, N = _dims(cfg)
    hd = cfg.ssm_head_dim

    z, xBC, dt = _split_proj(cfg, (x @ p["in_proj"])[:, 0])
    # the conv over the last K inputs (the oldest first, the current last)
    window = torch.cat([state.conv, xBC[:, None].float()], dim=1)   # (B,K,ch)
    xBC_c = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"].float()))
    xs = xBC_c[..., :d_in].reshape(B, nh, hd)
    Bm = xBC_c[..., d_in:d_in + N]
    Cm = xBC_c[..., d_in + N:]
    dt = _softplus(dt.float() + p["dt_bias"])                       # (B,nh)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))                     # (B,nh)

    ssm = state.ssm * dA[:, :, None, None] + torch.einsum(
        "bhd,bn->bhdn", dt[..., None] * xs, Bm)
    y = torch.einsum("bhdn,bn->bhd", ssm, Cm) + p["D"][None, :, None] * xs
    y = rms_norm(y.reshape(B, d_in).to(x.dtype), p["norm"]) * F.silu(z)
    return (y @ p["out_proj"])[:, None], MambaState(ssm=ssm, conv=window[:, 1:])


def decode_in_place(p, cfg, x: torch.Tensor, state: MambaState) -> torch.Tensor:
    """``mamba_decode`` writing the new state into ``state``'s tensors (a
    layer's views of a stacked cache), as ``attn_decode`` writes the KV
    cache: -> out (B, 1, d)."""
    out, new = mamba_decode(p, cfg, x, state)
    state.ssm.copy_(new.ssm)
    state.conv.copy_(new.conv)
    return out
