"""LLM-scale step factories (port of ``repro.launch.train``): the
federated train step, its state, and the serving steps.

The train step is one *federated round* with the paper's Algorithm 1 as
its server step: microbatch cohorts (gradient accumulation) play the
client role, each computing a cohort gradient and its square (the
"microbatch" Fisher term of ``core/fim.py``); the accumulated means are
the server's ḡ and Γ̄, and ``core.fim_lbfgs.update`` takes the VL-BFGS
server step, its Gram matrix through the hand-written kernel on the card.
``optimizer="fedavg_sgd"|"fedavg_adam"`` swaps the server step for the
paper's baselines on the same data path (the Table II comparison at LLM
scale).  The reference's sharding axes and its dry-run shape helpers
(``abstract_params``, ``train_state_shapes``, ``abstract_cache``) wait for
the mesh slice (ROADMAP section 1, item 9).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import baselines, fim_lbfgs
from repro_torch.models import model as zoo
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

OPTIMIZERS = ("fim_lbfgs", "fedavg_adam", "fedavg_sgd")


def opt_config(cfg: ArchConfig, learning_rate: float = 0.05
               ) -> fim_lbfgs.FimLbfgsConfig:
    return fim_lbfgs.FimLbfgsConfig(
        learning_rate=learning_rate,
        m=cfg.lbfgs_m,
        damping=1e-2,
        max_step_norm=1.0,
        history_dtype=getattr(torch, cfg.lbfgs_dtype),
        # LLM-scale configs keep the Fisher EMA / step temporaries in the
        # accumulation dtype
        state_dtype=getattr(torch, cfg.grad_accum_dtype),
    )


def _check_optimizer(optimizer: str) -> None:
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {OPTIMIZERS}, got "
                         f"{optimizer!r}")


def make_train_step(cfg: ArchConfig, ocfg: fim_lbfgs.FimLbfgsConfig,
                    n_micro: int = 4, optimizer: str = "fim_lbfgs",
                    kernels: str = "auto"):
    """(params, opt_state, batch) -> (params, opt_state, stats).

    ``kernels`` is the Gram matrix's kernel mode (``kernels.ops.resolve``):
    under "auto" on the card each ``fim_lbfgs`` step launches the Gram
    kernel once.  The step takes ``opt_state`` over: ``fim_lbfgs``
    updates its buffers in place (``fim_lbfgs.update(..., donate=True)``,
    the counterpart of the reference's donated state), so the caller
    passes the state it got back last time and keeps no other reference
    to it.  ``params`` are not written; the step returns new ones."""
    _check_optimizer(optimizer)
    ocfg = ocfg._replace(kernels=kernels)
    accum_dtype = getattr(torch, cfg.grad_accum_dtype)

    def cohort_grads(params, micro, nm):
        """(gsum, gsqsum, lsum): the sums over the nm microbatches of the
        gradient, its square (both in the accumulation dtype) and the
        loss."""
        leaves = tree_leaves(params)
        gsum = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                for p in leaves]
        gsqsum = [torch.zeros_like(a) for a in gsum]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for j in range(nm):
            mb = tree_map(lambda x: x[j], micro)
            live = [p.detach().requires_grad_() for p in leaves]
            with torch.enable_grad():
                loss, _ = zoo.loss_fn(tree_unflatten(params, live), cfg, mb)
                grads = torch.autograd.grad(loss, live)
            for a, q, g in zip(gsum, gsqsum, grads, strict=True):
                a.add_(g)
                q.add_(torch.square(g.to(q.dtype)))
            del grads
            lsum = lsum + loss.detach()
        return gsum, gsqsum, lsum

    @torch.no_grad()
    def train_step(params, opt_state, batch):
        B = tree_leaves(batch)[0].shape[0]
        nm = min(n_micro, B)
        micro = tree_map(lambda x: x.reshape((nm, B // nm) + x.shape[1:]),
                         batch)
        gsum, gsqsum, lsum = cohort_grads(params, micro, nm)
        # the means, in place: ḡ and Γ̄ = the mean of the cohorts' g²
        for a in gsum + gsqsum:
            a.mul_(1.0 / nm)
        grad = tree_unflatten(params, gsum)
        fim_diag = tree_unflatten(params, gsqsum)
        del gsum, gsqsum

        if optimizer == "fim_lbfgs":
            new_params, new_state, stats = fim_lbfgs.update(
                opt_state, params, grad, fim_diag, ocfg, donate=True)
        elif optimizer == "fedavg_adam":
            new_params, new_state, stats = baselines.adam_update(
                opt_state, params, grad, ocfg.learning_rate)
        else:
            new_params, new_state, stats = baselines.sgd_update(
                opt_state, params, grad, ocfg.learning_rate)
        stats = dict(stats)
        stats["loss"] = lsum / nm
        return new_params, new_state, stats

    return train_step


def make_prefill_step(cfg: ArchConfig, kernels: str = "auto"):
    """(params, batch) -> last-position logits; ``kernels`` is the
    attention's kernel mode."""
    def prefill_step(params, batch):
        return zoo.prefill_fn(params, cfg, batch, kernels=kernels)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """(params, cache, token) -> (logits, cache), one greedy-decode step."""
    def serve_step(params, cache, token):
        return zoo.decode_fn(params, cfg, cache, token)

    return serve_step


def init_train_state(cfg: ArchConfig, ocfg, generator: torch.Generator
                     | None = None, optimizer: str = "fim_lbfgs",
                     device="cuda"):
    """-> (params, opt_state) on ``device`` (the card unless the caller
    asks for the CPU); params drawn from ``generator`` (seed 0 when None).
    The reference also returns the sharding axes, which wait for item 9."""
    _check_optimizer(optimizer)
    params = zoo.init(cfg, generator, device=resolve_device(device))
    if optimizer == "fim_lbfgs":
        opt_state = fim_lbfgs.init(params, ocfg)
    elif optimizer == "fedavg_adam":
        opt_state = baselines.adam_init(params)
    else:
        opt_state = baselines.sgd_init(params)
    return params, opt_state
