"""Diagonal empirical Fisher Information Matrix (paper Sec. IV-A, Eq. 9).

Port of ``repro.core.fim``: the exact per-example diagonal (vmapped
per-example gradients, mean of squares) and the microbatch proxy, both
through the fused Γ op (``kernels.ops.fim_diag_update``), plus the EMA
state and the smoothing y_t = (Γ̄ + λI) s_t of Alg. 1 line 8.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad, vmap

from repro_torch.kernels import ops as kernel_ops
from repro_torch.utils.pytree import tree_leaves, tree_map


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


def _leaf_diag(g2: torch.Tensor, kernels: str) -> torch.Tensor:
    """(B, D) per-example gradients -> (D,) mean of squares through the
    fused Γ op; with old=0 and ema=0 it is exactly mean_b g²."""
    zeros = torch.zeros((g2.shape[1],), dtype=torch.float32, device=g2.device)
    return kernel_ops.fim_diag_update(g2.contiguous(), zeros, 0.0,
                                      mode=kernels)


def per_example_diag(per_example_loss: Callable, params, xs, ys,
                     kernels: str = "off"):
    """Exact diagonal empirical Fisher: mean over the batch of squared
    per-example gradients.  ``per_example_loss(params, x, y) -> scalar``."""
    grads = vmap(grad(per_example_loss), in_dims=(None, 0, 0))(params, xs, ys)
    return tree_map(
        lambda g: _leaf_diag(g.reshape(g.shape[0], -1),
                             kernels).reshape(g.shape[1:]), grads)


def microbatch_diag(grad_tree, kernels: str = "off"):
    """Squared (micro)batch gradient — one term of the accumulation mean
    (a B=1 instance of the same fused Γ op)."""
    return tree_map(
        lambda g: _leaf_diag(g.reshape(1, -1), kernels).reshape(g.shape),
        grad_tree)


def update(state: FimState, new_diag, ema: float) -> FimState:
    """EMA accumulation of the Fisher diagonal; the first step takes the
    new diagonal as is (no bias toward the zero init)."""
    first = state.steps == 0

    def upd(old, new):
        new = new.to(old.dtype)
        return torch.where(first, new, ema * old + (1.0 - ema) * new)

    return FimState(diag=tree_map(upd, state.diag, new_diag),
                    steps=state.steps + 1)


def mean_diag(state: FimState) -> torch.Tensor:
    """Mean of the Fisher diagonal across all parameters (f32 scalar)."""
    leaves = tree_leaves(state.diag)
    total = torch.stack([d.float().sum() for d in leaves]).sum()
    return total / float(max(sum(d.numel() for d in leaves), 1))


def smooth_y(state: FimState, s, damping: float, rel_damping: float = 0.1):
    """Paper Alg. 1 line 8: y_t = B̄_t s_t with B̄ = Γ̄ + λ_t I, where
    λ_t = damping + rel_damping·mean(Γ̄) (see ``repro.core.fim.smooth_y``
    for why the relative term is there)."""
    lam = damping + rel_damping * mean_diag(state)
    return tree_map(lambda d, si: ((d + lam) * si.float()).to(si.dtype),
                    state.diag, s)
