"""Shared model layers: norms, RoPE, SwiGLU MLP, parameter initializers
(port of ``repro.models.layers``; ``rms_norm`` carries the reference's
custom backward).

Parameters are plain dicts of tensors in the reference's layout: dense
weights ``(in, out)`` applied as ``x @ W``, stacked layers with a leading
``num_layers`` dim.  Each ``*_init`` has an ``*_axes`` twin beside it that
returns the matching tree of logical-axis strings (``utils/sharding.py``;
leaves with a stacked-layer dim prefix ``"layers"``), and ``use_mesh`` /
``constrain`` are the reference's activation constraints on a
``DeviceMesh``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.utils import sharding as shd

# ---------------------------------------------------------------------------
# Activation sharding constraint helper (identity outside a mesh context)
# ---------------------------------------------------------------------------
_CURRENT_MESH = None


class use_mesh:
    """Context manager installing the ``DeviceMesh`` that ``constrain``
    and the MoE's expert-parallel path read."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        global _CURRENT_MESH
        self._prev, _CURRENT_MESH = _CURRENT_MESH, self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _CURRENT_MESH
        _CURRENT_MESH = self._prev
        return False


def current_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _CURRENT_MESH


def constrain(x, axes: str, rules=None):
    """``x`` redistributed to the placements of its logical ``axes`` (under
    ``rules`` over ``DEFAULT_RULES``) on the current mesh; the identity
    with no mesh set or on a plain tensor."""
    if _CURRENT_MESH is None or not shd.is_dtensor(x):
        return x
    placements = shd.placements_for(x.shape, axes, _CURRENT_MESH, rules)
    if list(x.placements) == list(placements):
        return x
    return _Constrain.apply(x, tuple(placements))


class _Constrain(torch.autograd.Function):
    """``x.redistribute(placements)`` whose backward sends the cotangent
    back to x's placements with each ``Partial`` read as ``Replicate``:
    the cotangent of each rank's partial sum is the whole cotangent of the
    reduced value (Megatron's all-reduce, whose backward is the identity).
    DTensor's own backward would give a Partial cotangent, and every
    weight gradient upstream of it would then be a full-size partial sum
    on each model rank."""

    @staticmethod
    def forward(ctx, x, placements):
        from torch.distributed.tensor import Replicate

        ctx.src = [Replicate() if p.is_partial() else p for p in x.placements]
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return shd.to_placements(g, ctx.src), None


def split_heads(x, heads: int, axes: str):
    """(..., S, heads·hd) -> (..., S, heads, hd).  On a mesh the last dim is
    first laid out as ``axes`` lays out (..., S, heads): sharded whole heads
    at a time, or replicated where the head count does not divide the
    model axis (DTensor cannot split a shard across a head)."""
    lead, f = tuple(x.shape[:-1]), x.shape[-1]
    if _CURRENT_MESH is not None and shd.is_dtensor(x):
        x = shd.to_placements(x, shd.placements_for(lead + (heads,), axes,
                                                    _CURRENT_MESH))
    return x.reshape(lead + (heads, f // heads))


# ---------------------------------------------------------------------------
# Initializers (torch's generator gives other draws than JAX's threefry;
# parity tests carry the reference's draws across with utils.convert)
# ---------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               in_axis: int = -2) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights, drawn in f32 on the generator's
    device, then cast."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w.div_(math.sqrt(shape[in_axis])).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def _rms_inv(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(...,) f32 inverse root of the mean square of x's last dim."""
    xf = x.float()
    var = torch.einsum("...d,...d->...", xf, xf) / x.shape[-1]
    return torch.rsqrt(var + eps)


class _RmsNorm(torch.autograd.Function):
    """The reference's custom-VJP ``rms_norm`` (``_rms_fwd``/``_rms_bwd``):
    autograd through the forward would round its bf16 cotangents at other
    places."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        inv = _rms_inv(x, eps)
        ctx.save_for_backward(x, scale, inv)
        return (x * inv[..., None].to(x.dtype)) * scale

    @staticmethod
    def backward(ctx, g):
        x, scale, inv = ctx.saved_tensors
        d = x.shape[-1]
        gs = g * scale                                          # (..., d)
        # <gs, x> per position, f32-accumulated
        dot = torch.einsum("...d,...d->...", gs.float(), x.float())
        coef = (inv ** 3) * dot / d                             # (...,) f32
        dx = gs * inv[..., None].to(x.dtype) - x * coef[..., None].to(x.dtype)
        xn = x * inv[..., None].to(x.dtype)
        dscale = (g * xn).float().sum(dim=tuple(range(g.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: the mean square taken in f32, the inverse root cast to
    ``x.dtype``, then ``x * inv * scale`` in ``x.dtype``; its backward is
    the reference's custom VJP line for line: cotangents in the activation
    dtype, f32 per-position ``inv`` and ``<g·scale, x>``, ``dscale``
    summed in f32, then cast.  On a mesh (DTensor x) each rank normalises
    its own rows (``_rms_norm_local``)."""
    if shd.is_dtensor(x):
        return _rms_norm_local(x, scale, eps)
    return _RmsNorm.apply(x, scale, eps)


def _rms_norm_local(x, scale, eps: float):
    """``rms_norm`` of a DTensor as a ``local_map``: a norm over the last
    dim is local to each shard of the others (the last dim is gathered
    first where it is sharded), so each rank runs the plain function on
    its rows; DTensor's own propagation through the per-row dot would
    flatten a batch dim sharded over "data" with a head dim sharded over
    "model" into one strided shard, which is slow to plan.  The scale's
    gradient is a partial sum over the mesh dims that split the rows."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    last = x.dim() - 1
    pl = [Replicate() if p.is_partial() or p.is_shard(last) else p
          for p in x.placements]
    rep = [Replicate()] * len(pl)
    grad_scale = [Partial() if p.is_shard() else Replicate() for p in pl]
    return local_map(lambda a, s: _RmsNorm.apply(a, s, eps),
                     out_placements=pl, in_placements=(pl, rep),
                     in_grad_placements=(pl, grad_scale),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(
                         x, scale)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Rotates
    the two halves of hd (not interleaved pairs), in f32, cast back."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs      # (...,S,1,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, dtype,
             stack: int | None = None) -> dict:
    lead = (stack,) if stack else ()
    return {
        "wi": dense_init(generator, lead + (d_model, d_ff), dtype),
        "wg": dense_init(generator, lead + (d_model, d_ff), dtype),
        "wo": dense_init(generator, lead + (d_ff, d_model), dtype),
    }


def mlp_axes(stack: int | None = None) -> dict:
    """The logical axes of ``mlp_init``'s tree."""
    pre = "layers," if stack else ""
    return {"wi": pre + "embed,mlp", "wg": pre + "embed,mlp",
            "wo": pre + "mlp,embed"}


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = (x @ p["wi"]) * F.silu(x @ p["wg"])
    if h.dim() != 3:
        return h @ p["wo"]
    h = constrain(h, "batch,seq,mlp")
    return constrain(h @ p["wo"], "batch,seq,embed")
