"""Client-side computation (paper Alg. 1 ClientUpdate); port of
``repro.fed.client.make_grad_fim_fn``.  The first-order clients (local
SGD, Adam, DANE, Prox) come with the strategies that use them."""
from __future__ import annotations

from typing import Callable

from torch.func import grad_and_value

from repro_torch.core import fim


def make_grad_fim_fn(loss_fn: Callable, per_example_loss: Callable | None,
                     fim_mode: str = "per_example", kernels: str = "off"):
    """Client update for Algorithm 1: returns (grad, Γ_k, loss).

    loss_fn(params, batch) -> scalar; per_example_loss(params, x, y) ->
    scalar (needed for the exact Eq. 9 diagonal).  ``kernels``
    (FedConfig.kernels) routes the Fisher square+mean through the fused
    CUDA op (kernels.ops.fim_diag_update)."""
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
