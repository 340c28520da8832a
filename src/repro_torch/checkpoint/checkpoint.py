"""npz checkpointing of a tree of tensors and arrays (port of
``repro.checkpoint.checkpoint``).

Leaves are stored under their ``/``-joined tree path (dict keys, tuple
indices, NamedTuple field names); ``restore`` rebuilds into a
caller-supplied template and gives every leaf the template's dtype, shape
and device.  numpy has no bfloat16 (nor the float8 types), so such a
tensor is stored as the integer view of its bits, with its dtype recorded
under ``__viewdtype__/<key>``.  The write is atomic: a temporary file in
the target's directory, then a rename.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from repro_torch.utils.pytree import tree_unflatten

_VIEW = "__viewdtype__/"
# integer views by itemsize, for tensor dtypes numpy cannot hold: the
# tensor's view, the view stored, and the view torch reads back
_INT_VIEW = {1: (torch.uint8, np.uint8, np.uint8),
             2: (torch.int16, np.uint16, np.int16)}


def _flatten(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` in ``utils.pytree.tree_leaves`` order."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", range(len(tree)))
        items = [(str(n), t) for n, t in zip(names, tree, strict=True)]
    else:
        return {prefix: tree}
    out: dict = {}
    for name, sub in items:
        out.update(_flatten(sub, f"{prefix}/{name}" if prefix else name))
    return out


def _to_numpy(leaf) -> tuple[np.ndarray, str | None]:
    """-> (array, the tensor dtype's name when stored as an integer view)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), None
    t = leaf.detach().cpu()
    try:
        return t.numpy(), None
    except TypeError:   # bfloat16, float8: no numpy dtype
        as_int, stored, _ = _INT_VIEW[t.element_size()]
        name = str(t.dtype).removeprefix("torch.")
        return t.contiguous().view(as_int).numpy().view(stored), name


def save(path: str, tree) -> None:
    flat = {}
    for key, leaf in _flatten(tree).items():
        flat[key], viewed = _to_numpy(leaf)
        if viewed is not None:
            flat[_VIEW + key] = np.str_(viewed)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        np.savez(tmp, **flat)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    finally:
        for t in (tmp, tmp + ".npz"):
            if os.path.exists(t):
                os.remove(t)


def _fit(value: np.ndarray, viewed: str | None, template):
    """``value`` with ``template``'s dtype, shape and (tensors) device."""
    if viewed is not None:
        read = _INT_VIEW[value.dtype.itemsize][2]
        value = torch.from_numpy(value.view(read)).view(getattr(torch, viewed))
    if isinstance(template, torch.Tensor):
        return (torch.as_tensor(value).to(dtype=template.dtype)
                .reshape(template.shape).to(template.device))
    tmpl = np.asarray(template)
    return np.asarray(value).astype(tmpl.dtype).reshape(tmpl.shape)


def restore(path: str, template):
    flat = _flatten(template)
    with np.load(path) as data:
        missing = set(flat) - set(data.files)
        if missing:
            raise KeyError(
                f"checkpoint {path} missing keys: {sorted(missing)[:5]}...")
        leaves = [_fit(data[k], str(data[_VIEW + k]) if _VIEW + k in data.files
                       else None, t) for k, t in flat.items()]
    return tree_unflatten(template, leaves)
