"""Client-side computation (paper Alg. 1 ClientUpdate / Alg. 2 Step 2);
port of ``repro.fed.client``.

The local solvers take their minibatches stacked on a leading axis
(``stack_batches``) and walk them in a Python loop where the reference
``lax.scan``s; nothing in the loop waits for the device, and the mean
loss comes back as a 0-d device tensor.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import baselines, fim
from repro_torch.utils.pytree import tree_map


def make_grad_fim_fn(loss_fn: Callable, per_example_loss: Callable | None,
                     fim_mode: str = "per_example", kernels: str = "off"):
    """Client update for Algorithm 1: returns (grad, Γ_k, loss).

    loss_fn(params, batch) -> scalar; per_example_loss(params, x, y) ->
    scalar (needed for the exact Eq. 9 diagonal).  ``kernels``
    (FedConfig.kernels) routes the Fisher square+mean through the fused
    CUDA op, all leaves in one launch (kernels.ops.fim_diag_update_leaves)."""
    value_grad = grad_and_value(loss_fn)

    def client_grad_fim(params, batch):
        grad, loss = value_grad(params, batch)
        if fim_mode == "per_example" and per_example_loss is not None:
            diag = fim.per_example_diag(per_example_loss, params,
                                        batch["x"], batch["y"],
                                        kernels=kernels)
        else:
            diag = fim.microbatch_diag(grad, kernels=kernels)
        return grad, diag, loss

    return client_grad_fim


def make_cohort_grad_fim_fn(loss_fn: Callable,
                            per_example_loss: Callable | None,
                            fim_mode: str = "per_example",
                            kernels: str = "off"):
    """``make_grad_fim_fn`` over a stacked cohort (the vmapped cohort
    path, fed/simulator.py): ``(params, {"x": (K, B, ...), "y": (K, B)})
    -> (grads, Γs, losses)`` with a leading K on every leaf.

    The reference vmaps its per-client fn; ``torch.func.vmap`` cannot
    batch through the Γ kernel (it launches through ctypes), so the
    gradients and losses are one vmap over K of ``grad_and_value``, and
    Γ of the whole cohort is one fused call outside it
    (``core.fim.cohort_per_example_diag`` / ``cohort_microbatch_diag``)."""
    value_grad = vmap(grad_and_value(loss_fn), in_dims=(None, 0))

    def cohort_grad_fim(params, cohort_batch):
        grads, losses = value_grad(params, cohort_batch)
        if fim_mode == "per_example" and per_example_loss is not None:
            diags = fim.cohort_per_example_diag(
                per_example_loss, params, cohort_batch["x"],
                cohort_batch["y"], kernels=kernels)
        else:
            diags = fim.cohort_microbatch_diag(grads, kernels=kernels)
        return grads, diags, losses

    return cohort_grad_fim


def _sgd_step(p, g, lr: float):
    return tree_map(lambda w, gi: w - lr * gi.to(w.dtype), p, g)


def _mean_loss(losses) -> torch.Tensor:
    return torch.mean(torch.stack(losses))


def _walk(batches):
    for i in range(batches["x"].shape[0]):
        yield {"x": batches["x"][i], "y": batches["y"][i]}


def make_local_sgd_fn(loss_fn: Callable):
    """FedAvg client: E epochs of minibatch SGD over stacked batches
    (leading ``n_batches`` dim).  Returns (params, mean loss)."""
    value_grad = grad_and_value(loss_fn)

    def local_sgd(params, batches, lr: float):
        losses = []
        for batch in _walk(batches):
            grad, loss = value_grad(params, batch)
            params = _sgd_step(params, grad, lr)
            losses.append(loss)
        return params, _mean_loss(losses)

    return local_sgd


def make_local_adam_fn(loss_fn: Callable):
    """FedAvg-based Adam client: E epochs of minibatch Adam locally (the
    paper's 'FedAvg-based Adam' baseline, Table II), from a fresh Adam
    state every round."""
    value_grad = grad_and_value(loss_fn)

    def local_adam(params, batches, lr: float):
        state = baselines.adam_init(params)
        losses = []
        for batch in _walk(batches):
            grad, loss = value_grad(params, batch)
            params, state, _ = baselines.adam_update(state, params, grad, lr)
            losses.append(loss)
        return params, _mean_loss(losses)

    return local_adam


def make_feddane_fn(loss_fn: Callable):
    """FedDANE client: inner SGD on the DANE-corrected local objective."""
    value_grad = grad_and_value(loss_fn)

    def local_dane(params, batches, global_grad, local_grad_at_start,
                   lr: float, mu: float):
        start = params
        losses = []
        for batch in _walk(batches):
            g, loss = value_grad(params, batch)
            g = baselines.feddane_inner_grad(g, local_grad_at_start,
                                             global_grad, params, start, mu)
            params = _sgd_step(params, g, lr)
            losses.append(loss)
        return params, _mean_loss(losses)

    return local_dane


def make_fedprox_fn(loss_fn: Callable):
    """FedProx client [Li et al., MLSys 2020]: inner SGD on the proximal
    objective  F_k(w) + (mu/2)||w - w_t||², which bounds local drift
    under non-IID data."""
    value_grad = grad_and_value(loss_fn)

    def local_prox(params, batches, lr: float, mu: float):
        start = params
        losses = []
        for batch in _walk(batches):
            g, loss = value_grad(params, batch)
            g = tree_map(lambda gi, w, w0: gi + mu * (w - w0).to(gi.dtype),
                         g, params, start)
            params = _sgd_step(params, g, lr)
            losses.append(loss)
        return params, _mean_loss(losses)

    return local_prox


def stack_batches(xs: torch.Tensor, ys: torch.Tensor, batch_size: int,
                  epochs: int, rng: np.random.Generator) -> dict:
    """E epochs of shuffled minibatches stacked on a leading axis: one
    ``rng.permutation(n)`` per epoch with the ragged tail dropped, the
    reference's draws call for call.  The batches are taken by indexing
    ``xs``/``ys`` where they lie: only the index table crosses from the
    host."""
    n = len(xs)
    bs = min(batch_size, n)
    nb = max(1, n // bs)
    rows = []
    for _ in range(epochs):
        order = rng.permutation(n)
        rows.extend(order[i * bs:(i + 1) * bs] for i in range(nb))
    idx = torch.from_numpy(np.stack(rows)).to(xs.device)
    return {"x": xs[idx], "y": ys[idx]}
