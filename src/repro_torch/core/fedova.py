"""FedOVA (paper Sec. IV-B, Algorithm 2); port of ``repro.core.fedova``.

An n-class task becomes n binary one-vs-all component classifiers,
stored stacked (every leaf has a leading ``n_classes`` axis); each client
trains only the components of the classes in its data, the server
averages each component over the clients that trained it (Eq. 11), and
inference is the arg-max over the components' confidences (Eq. 4).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import aggregation
from repro_torch.utils.pytree import tree_map


class OvaModel(NamedTuple):
    components: object   # tree, leaves (n_classes, ...): binary classifiers
    n_classes: int


def component(model: OvaModel, cls: int):
    """The parameters of component ``cls`` (views into the stack)."""
    return tree_map(lambda leaf: leaf[cls], model.components)


def predict(apply_fn: Callable, model: OvaModel, x: torch.Tensor):
    """Eq. (4): ŷ = argmax_i σ(f_i(x)).  apply_fn(params, x) -> (B, 1)
    logits."""
    logits = torch.stack([apply_fn(component(model, c), x)[:, 0]
                          for c in range(model.n_classes)])   # (n, B)
    return torch.argmax(torch.sigmoid(logits), dim=0)


def accuracy(apply_fn: Callable, model: OvaModel, x, y) -> torch.Tensor:
    return torch.mean((predict(apply_fn, model, x) == y).float())


def aggregate(model: OvaModel, client_components,
              client_masks: torch.Tensor) -> OvaModel:
    """Eq. (11): each component's mean over the clients that trained it,
    or its previous value where none did.

    client_components: tree with leaves (K, n_classes, ...);
    client_masks: (K, n_classes) — which components each client trained."""
    new = [aggregation.grouped_mean(
               component(model, c),
               tree_map(lambda leaf, cc=c: leaf[:, cc], client_components),
               client_masks[:, c])
           for c in range(model.n_classes)]
    return OvaModel(components=tree_map(lambda *ls: torch.stack(ls), *new),
                    n_classes=model.n_classes)
