"""The paper's comparison optimizers (Table II): FedAvg-SGD, FedAvg-Adam
and FedDANE (port of ``repro.core.baselines``).

State counters stay 0-d device tensors, so an update never waits for the
device.  ``feddane_inner_grad`` is applied by ``fed/client.py`` during
the local epochs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.utils.pytree import tree_axpy, tree_leaves, tree_map


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


# ---------------------------------------------------------------------------
# FedAvg-SGD
# ---------------------------------------------------------------------------
class SgdState(NamedTuple):
    momentum: object
    step: torch.Tensor


def sgd_init(params, momentum: float = 0.0) -> SgdState:
    """Zero f32 velocity; ``momentum`` is the reference's argument (the
    coefficient is ``sgd_update``'s), taken so that callers read the same."""
    return SgdState(momentum=_zeros_f32(params), step=_step0(params))


def sgd_axes(param_axes) -> SgdState:
    """Logical sharding axes of ``sgd_init``'s state."""
    return SgdState(momentum=param_axes, step="")


def sgd_update(state: SgdState, params, grad, lr: float,
               momentum: float = 0.0):
    vel = tree_map(lambda v, g: momentum * v + g.float(), state.momentum, grad)
    return tree_axpy(-lr, vel, params), SgdState(vel, state.step + 1), {}


# ---------------------------------------------------------------------------
# FedAvg-Adam
# ---------------------------------------------------------------------------
class AdamState(NamedTuple):
    mu: object
    nu: object
    step: torch.Tensor


def adam_init(params) -> AdamState:
    return AdamState(mu=_zeros_f32(params), nu=_zeros_f32(params),
                     step=_step0(params))


def adam_axes(param_axes) -> AdamState:
    """Logical sharding axes of ``adam_init``'s state."""
    return AdamState(mu=param_axes, nu=param_axes, step="")


def adam_update(state: AdamState, params, grad, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Bias-corrected Adam, in the reference's order of operations:
    ``(m / bc1) / (sqrt(v / bc2) + eps)`` with ``bc = 1 - b ** t`` in f32."""
    t = state.step + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grad)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                  state.nu, grad)
    tf = t.float()
    bc1 = 1 - torch.pow(torch.full_like(tf, b1), tf)
    bc2 = 1 - torch.pow(torch.full_like(tf, b2), tf)
    upd = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
    return tree_axpy(-lr, upd, params), AdamState(mu, nu, t), {}


# ---------------------------------------------------------------------------
# FedDANE (Li et al., Asilomar 2019)
# ---------------------------------------------------------------------------
class DaneState(NamedTuple):
    step: torch.Tensor


def dane_init(params) -> DaneState:
    return DaneState(step=_step0(params))


def feddane_inner_grad(local_grad, local_grad_at_start, global_grad, params,
                       start_params, mu: float):
    """Gradient of the DANE local subproblem
        F_k(w) - (∇F_k(w_t) - ∇f(w_t))·w + (μ/2)‖w - w_t‖²
    i.e.  ∇F_k(w) - ∇F_k(w_t) + ∇f(w_t) + μ (w - w_t)."""
    return tree_map(
        lambda g, g0, gg, w, w0: g - g0 + gg + mu * (w - w0).to(g.dtype),
        local_grad, local_grad_at_start, global_grad, params, start_params)


def dane_update(state: DaneState, params, avg_client_params):
    """Server step: the average of the clients' inner solutions."""
    return avg_client_params, DaneState(state.step + 1), {}


# ---------------------------------------------------------------------------
# Uniform optimizer facade
# ---------------------------------------------------------------------------
def make(name: str, params, fed_cfg):
    """-> (state, update_fn(state, params, grad, fim_diag) -> (params,
    state, stats)); the Fisher diagonal is ignored by the first-order
    baselines.  ``fim_lbfgs`` takes its knobs from ``fed_cfg`` as the
    reference's façade does, and its Gram's kernel mode from
    ``fed_cfg.kernels``."""
    from repro_torch.core import fim_lbfgs

    if name == "fim_lbfgs":
        ocfg = fim_lbfgs.FimLbfgsConfig(
            learning_rate=fed_cfg.second_order_lr, m=fed_cfg.lbfgs_m,
            damping=fed_cfg.fim_damping, fim_ema=fed_cfg.fim_ema,
            max_step_norm=fed_cfg.max_step_norm, kernels=fed_cfg.kernels)
        state = fim_lbfgs.init(params, ocfg)

        def upd(state, params, grad, fim_diag):
            return fim_lbfgs.update(state, params, grad, fim_diag, ocfg)

        return state, upd
    if name == "fedavg_sgd":
        return sgd_init(params), lambda s, p, g, f: sgd_update(
            s, p, g, fed_cfg.learning_rate)
    if name == "fedavg_adam":
        return adam_init(params), lambda s, p, g, f: adam_update(
            s, p, g, fed_cfg.learning_rate)
    raise ValueError(f"unknown optimizer {name!r}")
