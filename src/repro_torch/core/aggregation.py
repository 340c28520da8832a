"""Federated aggregation rules (port of ``repro.core.aggregation``).

``weighted_mean`` is FedAvg's Eq. (1) (n_k/n weighting); ``grouped_mean``
is FedOVA's Eq. (11).  Both take *stacked* client trees (leading client
dim).
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import tree_map


def _bcast(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return w.reshape((-1,) + (1,) * (x.dim() - 1))


def weighted_mean(stacked_params, weights: torch.Tensor):
    """stacked_params: tree with leading K dim; weights: (K,) >= 0."""
    w = weights.float()
    total = torch.clamp_min(torch.sum(w), 1e-12)
    return tree_map(
        lambda x: (torch.sum(x.float() * _bcast(w, x), dim=0) / total).to(x.dtype),
        stacked_params)


def grouped_mean(prev_params, stacked_params, contributed: torch.Tensor):
    """FedOVA Eq. (11): the mean over contributors, or prev where no one
    contributed.  contributed: (K,) float mask."""
    c = contributed.float()
    total = torch.sum(c)

    def leaf(prev, x):
        mean = torch.sum(x.float() * _bcast(c, x), dim=0) / torch.clamp_min(total, 1.0)
        return torch.where(total > 0, mean.to(prev.dtype), prev)

    return tree_map(leaf, prev_params, stacked_params)


def delta_mean(global_params, stacked_client_params, weights: torch.Tensor):
    """FedAvg in delta form: w + mean_k n_k/n (w_k - w)."""
    mean = weighted_mean(stacked_client_params, weights)
    return tree_map(
        lambda g, m: (g.float() + (m.float() - g.float())).to(g.dtype),
        global_params, mean)
