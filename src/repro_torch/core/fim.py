"""Diagonal empirical Fisher Information Matrix (paper Sec. IV-A, Eq. 9).

Port of ``repro.core.fim``: the exact per-example diagonal (vmapped
per-example gradients, mean of squares) and the microbatch proxy, both
through the fused Γ op over every leaf at once
(``kernels.ops.fim_diag_update_leaves``), plus the EMA
state and the smoothing y_t = (Γ̄ + λI) s_t of Alg. 1 line 8.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad, vmap

from repro_torch.kernels import ops as kernel_ops
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.utils.sharding import LeafSum


class FimState(NamedTuple):
    diag: object          # tree like params — EMA of the diagonal Fisher
    steps: torch.Tensor   # () int32


def init(params, dtype=torch.float32) -> FimState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return FimState(
        diag=tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                            device=p.device), params),
        steps=torch.zeros((), dtype=torch.int32, device=device),
    )


def _diag_tree(g2_tree, batch_leading: bool, kernels: str):
    """Mean over the leading axis of the squares of every leaf of a
    gradient tree, through one fused Γ call for the whole tree (one kernel
    launch on the card); with no old and ema=0 it is exactly mean_b g².
    ``batch_leading``: leaves are (B, ...) per-example gradients, else
    one gradient (a B=1 instance)."""
    leaves = tree_leaves(g2_tree)
    mats = [(g.reshape(g.shape[0], -1) if batch_leading
             else g.reshape(1, -1)).contiguous() for g in leaves]
    outs = kernel_ops.fim_diag_update_leaves(mats, None, 0.0, mode=kernels)
    return tree_unflatten(g2_tree, [
        o.reshape(g.shape[1:] if batch_leading else g.shape)
        for o, g in zip(outs, leaves)])


def per_example_diag(per_example_loss: Callable, params, xs, ys,
                     kernels: str = "off"):
    """Exact diagonal empirical Fisher: mean over the batch of squared
    per-example gradients.  ``per_example_loss(params, x, y) -> scalar``."""
    grads = vmap(grad(per_example_loss), in_dims=(None, 0, 0))(params, xs, ys)
    return _diag_tree(grads, True, kernels)


def microbatch_diag(grad_tree, kernels: str = "off"):
    """Squared (micro)batch gradient — one term of the accumulation mean
    (a B=1 instance of the same fused Γ op)."""
    return _diag_tree(grad_tree, False, kernels)


def _cohort_diag_tree(g_tree, batch_leading: bool, kernels: str):
    """``_diag_tree`` of every slot of a stacked cohort tree (leaves
    (K, B, ...) per-example gradients, or (K, ...) gradients) in ONE fused
    Γ call over all K·L matrices, each one slot's leaf viewed where it
    lies: the kernel takes up to 64 of them a launch.  -> leaves (K, ...)."""
    leaves = [g.contiguous() for g in tree_leaves(g_tree)]
    k = leaves[0].shape[0] if leaves else 0
    mats = [(g[i].reshape(g.shape[1], -1) if batch_leading
             else g[i].reshape(1, -1)) for g in leaves for i in range(k)]
    outs = kernel_ops.fim_diag_update_leaves(mats, None, 0.0, mode=kernels)
    shapes = [g.shape[2:] if batch_leading else g.shape[1:] for g in leaves]
    return tree_unflatten(g_tree, [
        torch.stack([o.reshape(shape) for o in outs[j * k:(j + 1) * k]])
        for j, shape in enumerate(shapes)])


def cohort_per_example_diag(per_example_loss: Callable, params, xs, ys,
                            kernels: str = "off"):
    """``per_example_diag`` of every slot of a stacked cohort: ``xs``
    (K, B, ...), ``ys`` (K, B) -> leaves (K, ...).  The per-example
    gradients come from one vmap over K of the vmap over B (leaves
    (K, B, ...)); Γ runs outside the vmap, which cannot batch through the
    kernel's launch, as one fused call for the whole cohort."""
    per_slot = vmap(grad(per_example_loss), in_dims=(None, 0, 0))
    grads = vmap(per_slot, in_dims=(None, 0, 0))(params, xs, ys)
    return _cohort_diag_tree(grads, True, kernels)


def cohort_microbatch_diag(grad_tree, kernels: str = "off"):
    """``microbatch_diag`` of every slot of stacked (K, ...) gradients, in
    one fused Γ call."""
    return _cohort_diag_tree(grad_tree, False, kernels)


def _ema(first, old, new, ema: float):
    new = new.to(old.dtype)
    return torch.where(first, new, ema * old + (1.0 - ema) * new)


def update(state: FimState, new_diag, ema: float) -> FimState:
    """EMA accumulation of the Fisher diagonal; the first step takes the
    new diagonal as is (no bias toward the zero init)."""
    first = state.steps == 0
    return FimState(diag=tree_map(lambda o, n: _ema(first, o, n, ema),
                                  state.diag, new_diag),
                    steps=state.steps + 1)


def update_(state: FimState, new_diag, ema: float) -> FimState:
    """``update`` written into ``state.diag``'s buffers in place, a leaf at
    a time (the same numbers; the returned state holds those buffers)."""
    first = state.steps == 0
    for old, new in zip(tree_leaves(state.diag), tree_leaves(new_diag),
                        strict=True):
        old.copy_(_ema(first, old, new, ema))
    return FimState(diag=state.diag, steps=state.steps + 1)


def mean_diag(state: FimState, leaf_sum=None) -> torch.Tensor:
    """Mean of the Fisher diagonal across all parameters (f32 scalar).
    ``leaf_sum`` (``utils.sharding.LeafSum``; ``LeafSum.local``, the tree
    held whole, when None): the leaves are this rank's shards of a tree
    laid out on a mesh (one scalar all-reduce)."""
    if leaf_sum is None:
        leaf_sum = LeafSum.local(state.diag)
    total = leaf_sum.weighted([d.float().sum() for d in tree_leaves(state.diag)])
    return total / float(max(leaf_sum.numel, 1))


def smooth_y(state: FimState, s, damping: float, rel_damping: float = 0.1,
             leaf_sum=None):
    """Paper Alg. 1 line 8: y_t = B̄_t s_t with B̄ = Γ̄ + λ_t I, where
    λ_t = damping + rel_damping·mean(Γ̄) (see ``repro.core.fim.smooth_y``
    for why the relative term is there)."""
    lam = damping + rel_damping * mean_diag(state, leaf_sum)
    return tree_map(lambda d, si: ((d + lam) * si.float()).to(si.dtype),
                    state.diag, s)
