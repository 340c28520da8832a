"""Client compute cost model (the part of ``repro.edge.device`` the
strategies' round plans need; the device fleet comes with the edge
slice)."""
from __future__ import annotations


def flops_grad_fim(n_params: int, n_examples: int) -> float:
    """One full-batch gradient + Fisher-diagonal pass (Alg. 1 line 3-4):
    forward 2P + backward 4P + per-example squared-grad pass 2P."""
    return 8.0 * float(n_params) * float(n_examples)


def flops_local_sgd(n_params: int, n_examples: int, epochs: int) -> float:
    """E epochs of minibatch SGD: 6P per example per epoch."""
    return 6.0 * float(n_params) * float(n_examples) * float(max(epochs, 1))
