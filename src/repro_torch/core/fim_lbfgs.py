"""FIM-based Approximate L-BFGS — the paper's Algorithm 1 (port of
``repro.core.fim_lbfgs``).

Server view of one round, given the aggregated ḡ and Γ̄:
  1. direction p_t = -H_t ḡ via the vector-free two-loop
  2. ω_{t+1} = ω_t + η p_t;  s_t = η p_t (with the trust-region clip)
  3. y_t = (Γ̄ + λI) s_t      — the FIM smoothing of Alg. 1 line 8
  4. push (s_t, y_t) unless the curvature test <s,y> > ε‖s‖‖y‖ fails
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import fim, lbfgs
from repro_torch.utils.pytree import tree_axpy, tree_dot, tree_map, tree_norm


class FimLbfgsConfig(NamedTuple):
    learning_rate: float = 0.05
    m: int = 10
    damping: float = 1e-3
    rel_damping: float = 0.1
    fim_ema: float = 0.95
    curvature_eps: float = 1e-8
    max_step_norm: float = 0.0      # 0 disables step clipping
    history_dtype: torch.dtype = torch.float32
    state_dtype: torch.dtype = torch.float32
    kernels: str = "off"            # CUDA Gram kernel (kernels.ops); the
                                    # federated strategy passes
                                    # FedConfig.kernels


class FimLbfgsState(NamedTuple):
    history: lbfgs.History
    fim: fim.FimState
    step: torch.Tensor


def init(params, cfg: FimLbfgsConfig) -> FimLbfgsState:
    hist = lbfgs.init(params, cfg.m, dtype=cfg.history_dtype)
    return FimLbfgsState(
        history=hist,
        fim=fim.init(params, dtype=cfg.state_dtype),
        step=torch.zeros((), dtype=torch.int32, device=hist.idx.device),
    )


def update(state: FimLbfgsState, params, grad, fim_diag, cfg: FimLbfgsConfig,
           learning_rate: Optional[float] = None):
    """One server round given aggregated ḡ and Γ̄.
    Returns (params, state, stats); stats are 0-d device tensors."""
    lr = cfg.learning_rate if learning_rate is None else learning_rate

    fim_state = fim.update(state.fim, fim_diag, cfg.fim_ema)

    # Alg. 1 line 6: p_t = -H_t ḡ (the Gram matrix runs through the CUDA
    # kernel when cfg.kernels enables it for the tensors' device)
    p = lbfgs.direction(state.history, grad, kernels=cfg.kernels)

    p_norm = tree_norm(p)
    if cfg.max_step_norm:
        # trust region on the actual step ||η p_t|| (not the raw direction)
        pn = p_norm * lr
        # (a tensor numerator: `float / tensor` would multiply by the
        # reciprocal, one rounding away from the reference's quotient)
        scale = torch.clamp_max(torch.full_like(pn, cfg.max_step_norm)
                                / torch.clamp_min(pn, 1e-12), 1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=p_norm.device)

    # Alg. 1 line 7: ω_{t+1} = ω_t + η p_t
    s = tree_map(lambda pi: (lr * scale * pi.float()).to(pi.dtype), p)
    new_params = tree_axpy(1.0, s, params)

    # Alg. 1 line 8: y_t = B̄_t s_t  with B̄ = Γ̄ + λI
    y = fim.smooth_y(fim_state, s, cfg.damping, cfg.rel_damping)

    # curvature safeguard (Lemma 1 bounds): skip degenerate pairs
    sy = tree_dot(s, y)
    sn, yn = tree_norm(s), tree_norm(y)
    ok = sy > cfg.curvature_eps * sn * yn

    pushed = lbfgs.push(state.history, s, y)
    history = tree_map(lambda new, old: torch.where(ok, new, old),
                       pushed, state.history)

    stats = {
        "dir_norm": p_norm,
        "step_norm": sn,
        "sy": sy,
        "pair_accepted": ok.float(),
        "grad_norm": tree_norm(grad),
    }
    return new_params, FimLbfgsState(history, fim_state, state.step + 1), stats
