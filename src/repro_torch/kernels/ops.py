"""Dispatch between the hand-written CUDA kernels and their plain
PyTorch versions.

Every wrapper takes the reference's ``mode`` knob (``FedConfig.kernels``,
or the ``kernels`` keyword of the model's prefill) and picks the path by
the device of the tensor it is given:

  ============  ===================  ===================  ============
  tensor        ``"auto"``           ``"on"``             ``"off"``
  ============  ===================  ===================  ============
  CUDA          hand-written kernel  hand-written kernel  plain
  CPU           plain                ValueError           plain
  ============  ===================  ===================  ============

A CUDA tensor under ``"auto"``/``"on"`` launches the kernel or raises: a
build or launch failure is never caught to fall back to the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import codec_ops as _codec
from repro_torch.kernels import fim_diag as _fim
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import vlbfgs as _vl

MODES = ("auto", "on", "off")


def resolve(mode: str, device) -> str:
    """-> "kernel" | "plain" for a tensor on ``device``."""
    if mode not in MODES:
        raise ValueError(f"kernels mode must be one of {MODES}, got {mode!r}")
    if mode == "off":
        return "plain"
    if torch.device(device).type == "cuda":
        return "kernel"
    if mode == "on":
        raise ValueError(
            f"kernels='on' needs a CUDA tensor: there is no hand-written "
            f"kernel for device {torch.device(device).type!r}")
    return "plain"


def fim_diag_update(grads, old_diag, ema: float, mode: str = "auto"):
    """Fused Γ update: ema*old + (1-ema)*mean_b g².  grads: (B, D)."""
    if resolve(mode, grads.device) == "plain":
        return ref.fim_diag_ref(grads, old_diag, ema)
    return _fim.fim_diag(grads, old_diag, ema)


def fim_diag_update_leaves(grads, olds, ema: float,
                           mode: str = "auto") -> list:
    """The fused Γ update of every (B, D_i) leaf of one client: the kernel
    takes all leaves in one launch; the plain version runs
    ``ref.fim_diag_ref`` a leaf.  ``olds``: (D_i,) f32 tensors, or None for
    zeros (with ``ema`` 0 the result is then exactly mean_b g²)."""
    grads = list(grads)
    if not grads:
        return []
    if resolve(mode, grads[0].device) == "plain":
        olds = [None] * len(grads) if olds is None else list(olds)
        return [ref.fim_diag_ref(g, o, ema) for g, o in zip(grads, olds,
                                                             strict=True)]
    return _fim.fim_diag_leaves(grads, olds, ema)


def vlbfgs_gram(basis, mode: str = "auto"):
    """(2m+1, D) basis -> (2m+1, 2m+1) Gram matrix."""
    if resolve(mode, basis.device) == "plain":
        return ref.vlbfgs_gram_ref(basis)
    return _vl.gram(basis)


def vlbfgs_gram_leaves(s_leaves, y_leaves, g_leaves, mode: str = "auto"):
    """Gram matrix of the basis [s_0.., y_0.., g] of a history kept a leaf:
    s and y leaves (m, *shape_i) in slot order, g leaves *shape_i, all f32.
    The kernel reads them in place in one launch; the plain version
    concatenates the (2m+1, D) basis in leaf order and runs
    ``ref.vlbfgs_gram_ref``."""
    s_leaves, y_leaves, g_leaves = list(s_leaves), list(y_leaves), list(g_leaves)
    if resolve(mode, g_leaves[0].device) == "plain":
        def rows(leaves):
            return torch.cat([x.reshape(x.shape[0], -1) for x in leaves], 1)

        basis = torch.cat([rows(s_leaves), rows(y_leaves),
                           torch.cat([x.reshape(-1) for x in g_leaves])[None]])
        return ref.vlbfgs_gram_ref(basis)
    return _vl.gram_leaves(s_leaves, y_leaves, g_leaves)


def int8_uniforms(x, generator: torch.Generator) -> torch.Tensor:
    """The rounding uniforms of one int8 round-trip: one ``torch.rand``
    draw shaped like ``x`` from ``generator``."""
    return torch.rand(x.shape, generator=generator, device=x.device)


def int8_roundtrip_leaves(leaves, generator: torch.Generator,
                          mode: str = "auto") -> list:
    """Int8 stochastic-rounding quantize+dequantize of every leaf of one
    payload, each with its own scale.

    Draws the rounding uniforms from ``generator`` the same way on every
    path (``int8_uniforms``, once a non-empty leaf, in leaf order), so
    kernel and plain version round identically (bit for bit).  The kernel
    takes all leaves in one launch pair and computes the scales itself;
    the plain version computes ``ref.int8_scale`` a leaf.  An empty leaf
    comes back as ``x.float()``."""
    leaves = list(leaves)
    us = [int8_uniforms(x, generator) if x.numel() else None for x in leaves]
    live = [i for i, u in enumerate(us) if u is not None]
    out = [x.float() for x in leaves]
    if not live:
        return out
    if resolve(mode, leaves[live[0]].device) == "plain":
        for i in live:
            out[i] = ref.int8_roundtrip_ref(leaves[i], us[i],
                                            ref.int8_scale(leaves[i]))
        return out
    sent, _ = _codec.int8_roundtrip_leaves(
        [leaves[i].float().contiguous() for i in live], [us[i] for i in live])
    for i, t in zip(live, sent):
        out[i] = t
    return out


def int8_roundtrip(x, generator: torch.Generator, mode: str = "auto"):
    """``int8_roundtrip_leaves`` of the one-leaf payload ``[x]``."""
    return int8_roundtrip_leaves([x], generator, mode)[0]


def topk_select(flat, k: int, mode: str = "auto"):
    """Zero all but the ``k`` largest-|x| entries of a 1-D payload by the
    bucketed threshold select (exactly ``k`` survive, ties on the
    threshold bucket broken by index: the codec's ``wire_bytes`` billing
    invariant).  ``k`` is a host int in [0, n]."""
    if not 0 <= k <= flat.numel():
        raise ValueError(f"topk_select needs 0 <= k <= n = {flat.numel()}, "
                         f"got {k}")
    if resolve(mode, flat.device) == "plain":
        return ref.topk_select_ref(flat, k)
    return _codec.topk_select(flat, k)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    mode: str = "auto"):
    """(B,H,S,hd) x (B,KV,S,hd) -> (B,H,S,hd): GQA attention with f32
    softmax, causal and sliding-window masks (``window`` 0 = none)."""
    if resolve(mode, q.device) == "plain":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)
