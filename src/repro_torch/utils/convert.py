"""Carrying trees across from the reference package and back.

The reference's parameters and optimizer state, taken as numpy arrays
(``jax.tree.map(np.asarray, run.strategy.state_dict())``), become the
port's tensors with ``from_jax``; ``FedStrategy.load_state_dict`` then
fits them into the port's own structures.  JAX's threefry initialisation
cannot be reproduced in torch, so parity runs start both packages from
the reference's own draws this way.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax(tree, device="cpu"):
    """numpy leaves -> tensors on ``device``; dicts stay dicts, every
    tuple-like (the reference's NamedTuples included) becomes a plain
    tuple in field order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(from_jax(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def to_numpy(tree):
    """Tensor leaves -> numpy arrays, keeping the container types."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        kids = [to_numpy(v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*kids)
        return type(tree)(kids)
    return tree.detach().cpu().numpy()


def load_like(template, tree):
    """``tree``'s values in ``template``'s structure, device and dtypes.

    Dict children match by key; tuple children by position, so a plain
    tuple from ``from_jax`` fills the port's NamedTuple of the same field
    order."""
    if template is None:
        return None
    if isinstance(template, dict):
        if set(template) != set(tree):
            raise ValueError(f"state keys {sorted(tree)} do not match "
                             f"{sorted(template)}")
        return {k: load_like(template[k], tree[k]) for k in template}
    if isinstance(template, (tuple, list)):
        kids = [load_like(t, v) for t, v in zip(template, tree, strict=True)]
        if hasattr(template, "_fields"):
            return type(template)(*kids)
        return type(template)(kids)
    value = torch.as_tensor(tree)
    if tuple(value.shape) != tuple(template.shape):
        raise ValueError(f"state leaf of shape {tuple(value.shape)} does not "
                         f"fit {tuple(template.shape)}")
    return value.to(device=template.device, dtype=template.dtype).clone()
