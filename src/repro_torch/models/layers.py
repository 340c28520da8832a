"""Shared model layers: norms, RoPE, SwiGLU MLP, parameter initializers
(port of ``repro.models.layers``, forward only).

Parameters are plain dicts of tensors in the reference's layout: dense
weights ``(in, out)`` applied as ``x @ W``, stacked layers with a leading
``num_layers`` dim.  The reference's logical sharding axes and its
activation constraints (``constrain``, ``use_mesh``) wait for the launch
slice of the port.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: the mean square taken in f32, the inverse root cast to
    ``x.dtype``, then ``x * inv * scale`` in ``x.dtype`` (the forward of
    the reference's custom-VJP ``rms_norm``)."""
    xf = x.float()
    var = torch.einsum("...d,...d->...", xf, xf) / x.shape[-1]
    inv = torch.rsqrt(var + eps)
    return (x * inv[..., None].to(x.dtype)) * scale


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


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = (x @ p["wi"]) * F.silu(x @ p["wg"])
    return h @ p["wo"]
