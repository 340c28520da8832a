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

from collections.abc import Sequence

import torch

from repro_torch.kernels import codec_ops as _codec
from repro_torch.kernels import fim_diag as _fim
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import vlbfgs as _vl

MODES = ("auto", "on", "off")


def resolve(mode: str, device: torch.device | str) -> str:
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


def fim_diag_update_leaves(grads: Sequence[torch.Tensor],
                           olds: Sequence[torch.Tensor] | None, ema: float,
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
    """(2m+1, D) basis (f32 or bf16) -> (2m+1, 2m+1) f32 Gram matrix."""
    if resolve(mode, basis.device) == "plain":
        return ref.vlbfgs_gram_ref(basis)
    return _vl.gram(basis)


def vlbfgs_gram_leaves(s_leaves, y_leaves, g_leaves, mode: str = "auto"):
    """Gram matrix of the basis [s_0.., y_0.., g] of a history kept a leaf:
    s and y leaves (m, *shape_i) in slot order, g leaves *shape_i; each
    group f32 or bf16 (a bf16 history beside an f32 gradient).  The kernel
    reads them in place in one launch; the plain version,
    ``ref.vlbfgs_gram_leaves_ref``, sums f32 products a leaf and a column
    block at a time."""
    s_leaves, y_leaves, g_leaves = list(s_leaves), list(y_leaves), list(g_leaves)
    if resolve(mode, g_leaves[0].device) == "plain":
        return ref.vlbfgs_gram_leaves_ref(s_leaves, y_leaves, g_leaves)
    return _vl.gram_leaves(s_leaves, y_leaves, g_leaves)


def vlbfgs_gram_leaves_sharded(s_leaves, y_leaves, g_leaves, leaf_sum,
                               mode: str = "auto"):
    """The Gram matrix of a history laid out on a mesh, from each rank's
    local shards (``vlbfgs_gram_leaves``' arguments, each leaf this rank's
    shard; s, y and g of a leaf sharded alike): the leaves that share a
    replication factor go through one ``vlbfgs_gram_leaves`` call (the
    kernel launches once a group, at most one a distinct factor), each
    group's partial weighted by ``leaf_sum.weights`` (1 / the ranks that
    hold the same shard), the partials summed, then ONE all-reduce of the
    (2m+1)² f32 matrix over the whole mesh (``utils.sharding.LeafSum``):
    Theorem 3's O(m²) exchange."""
    s_leaves, y_leaves, g_leaves = list(s_leaves), list(y_leaves), list(g_leaves)
    groups: dict[float, list[int]] = {}
    for i, w in enumerate(leaf_sum.weights):
        groups.setdefault(w, []).append(i)
    total = None
    for w, idx in groups.items():
        part = vlbfgs_gram_leaves([s_leaves[i] for i in idx],
                                  [y_leaves[i] for i in idx],
                                  [g_leaves[i] for i in idx], mode=mode)
        part = part * w if w != 1.0 else part
        total = part if total is None else total + part
    return leaf_sum.all_reduce(total)


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
    softmax, causal and sliding-window masks (``window`` 0 = none).

    Differentiable on every path; no result is ever cut from autograd.
    The plain version (``ref.flash_attention_ref``) is differentiated by
    autograd.  On the kernel path, with grad mode on and q, k or v
    requiring grad, the bf16 kernel runs forward and backward
    (``flash_attention._FlashAttention``); inputs its backward does not
    take (f32, another head dim: ``flash_takes_grad``) raise there, and a
    model routes them to its plain chunked attention
    (``models.attention.attn_apply``)."""
    if resolve(mode, q.device) == "plain":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def flash_takes_grad(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the flash kernel's backward takes attention on q, k and v
    of this dtype and head dim (bf16, a head dim the kernels have): where
    it does not, a model's attention under autograd runs the plain
    chunked path."""
    return _fa.backward_takes(dtype, head_dim)
