"""FIM-based Approximate L-BFGS — the paper's Algorithm 1 (port of
``repro.core.fim_lbfgs``).

Server view of one round, given the aggregated ḡ and Γ̄:
  1. direction p_t = -H_t ḡ via the vector-free two-loop
  2. ω_{t+1} = ω_t + η p_t;  s_t = η p_t (with the trust-region clip)
  3. y_t = (Γ̄ + λI) s_t      — the FIM smoothing of Alg. 1 line 8
  4. push (s_t, y_t) unless the curvature test <s,y> > ε‖s‖‖y‖ fails

``update(..., tracer=)`` marks each part as a span of the tracer's current
step (``obs.Tracer.wall_span``): ``server.fim_ema``, ``lbfgs.direction``'s
``server.gram``, ``server.two_loop`` and ``server.combine``, then
``server.step``, ``server.smooth_y``, ``server.curvature`` and
``server.push``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import fim, lbfgs
from repro_torch.obs import NULL_TRACER
from repro_torch.utils.pytree import tree_axpy, tree_map
from repro_torch.utils.sharding import LeafSum


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


def state_axes(param_axes, cfg: FimLbfgsConfig) -> FimLbfgsState:
    """Logical sharding axes of the state: the history gets a leading
    "history" axis; the Fisher diagonal shards like the parameters."""
    hist = tree_map(lambda a: ("history," + a) if a else "history", param_axes)
    return FimLbfgsState(
        history=lbfgs.History(s=hist, y=hist, idx="", count=""),
        fim=fim.FimState(diag=param_axes, steps=""),
        step="",
    )


def update(state: FimLbfgsState, params, grad, fim_diag, cfg: FimLbfgsConfig,
           learning_rate: Optional[float] = None, donate: bool = False,
           leaf_sum=None, tracer=NULL_TRACER):
    """One server round given aggregated ḡ and Γ̄.
    Returns (params, state, stats); stats are 0-d device tensors.

    ``donate``: ``state`` is the caller's to give up (the counterpart of
    the reference trainer donating its optimizer state to the jitted
    step): the Fisher EMA and the accepted (s, y) pair are written into
    its buffers in place (``lbfgs.push_``), so neither the (m, ...)
    history nor the diagonal is copied; the numbers are those of the
    functional update, bit for bit.  The federated strategies keep the
    functional update (their callers copy and compare states).

    ``leaf_sum`` (``utils.sharding.LeafSum``; ``LeafSum.local(grad)``, the
    trees held whole, when None): every tree is this rank's shards of a
    tree laid out on a mesh, all sharded alike (the ZeRO-1 layout of
    ``launch/train.py``'s sharded step); the step then runs on the shards,
    and its only communication is the Gram's one (2m+1)² all-reduce and
    the scalar all-reduces of its norms, dots and mean(Γ̄).

    ``tracer``: the step's spans (module docstring), on ``tracer.step``."""
    lr = cfg.learning_rate if learning_rate is None else learning_rate
    if leaf_sum is None:
        leaf_sum = LeafSum.local(grad)
    step = tracer.step

    with tracer.wall_span("server.fim_ema", round_id=step):
        fim_state = (fim.update_ if donate else fim.update)(
            state.fim, fim_diag, cfg.fim_ema)

    # Alg. 1 line 6: p_t = -H_t ḡ (the Gram matrix runs through the CUDA
    # kernel when cfg.kernels enables it for the tensors' device)
    p = lbfgs.direction(state.history, grad, kernels=cfg.kernels,
                        leaf_sum=leaf_sum, tracer=tracer)

    with tracer.wall_span("server.step", round_id=step):
        pp, gg = leaf_sum.dots([(p, p), (grad, grad)])
        p_norm, grad_norm = torch.sqrt(pp), torch.sqrt(gg)
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
        del p
        new_params = tree_axpy(1.0, s, params)

    # Alg. 1 line 8: y_t = B̄_t s_t  with B̄ = Γ̄ + λI
    with tracer.wall_span("server.smooth_y", round_id=step):
        y = fim.smooth_y(fim_state, s, cfg.damping, cfg.rel_damping, leaf_sum)

    # curvature safeguard (Lemma 1 bounds): skip degenerate pairs
    with tracer.wall_span("server.curvature", round_id=step):
        sy, ss, yy = leaf_sum.dots([(s, y), (s, s), (y, y)])
        sn, yn = torch.sqrt(ss), torch.sqrt(yy)
        ok = sy > cfg.curvature_eps * sn * yn

    with tracer.wall_span("server.push", round_id=step):
        if donate:
            history = lbfgs.push_(state.history, s, y, ok)
        else:
            pushed = lbfgs.push(state.history, s, y)
            history = tree_map(lambda new, old: torch.where(ok, new, old),
                               pushed, state.history)

    stats = {
        "dir_norm": p_norm,
        "step_norm": sn,
        "sy": sy,
        "pair_accepted": ok.float(),
        "grad_norm": grad_norm,
    }
    return new_params, FimLbfgsState(history, fim_state, state.step + 1), stats
