"""Parameter trees as nested dicts/tuples of tensors, and their vector-space
algebra.

A tree is a tensor (a leaf), ``None`` (no leaves), a dict (children in
SORTED key order), or a tuple/list/NamedTuple (children in order) — the
leaf order of ``jax.tree.leaves``, so a flattened tree lines up element
for element with the reference's ``ravel_pytree``.  The algebra (dot, axpy,
norm) accumulates in f32 like ``repro.utils.pytree``.
"""
from __future__ import annotations

from typing import Callable, Iterator

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        kids = [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*kids)
        return type(tree)(kids)
    return fn(tree, *rest)


def tree_unflatten(template, leaves) -> object:
    """Rebuild ``template``'s structure from ``leaves`` (in leaf order)."""
    it: Iterator = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the template has")
    return out


def tree_dot(a, b) -> torch.Tensor:
    """<a, b> over every leaf, accumulated in f32."""
    parts = [torch.dot(x.reshape(-1).float(), y.reshape(-1).float())
             for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True)]
    return torch.stack(parts).sum()


def tree_axpy(alpha, x, y):
    """alpha * x + y, leaf-wise (keeps y's dtype)."""
    return tree_map(
        lambda xi, yi: (alpha * xi.float() + yi.float()).to(yi.dtype), x, y)


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def ravel(tree) -> tuple[torch.Tensor, Callable]:
    """-> (flat, unravel): every leaf flattened row-major and concatenated
    in leaf order (the layout of ``jax.flatten_util.ravel_pytree``), and
    the inverse that cuts a flat vector of that length back into
    ``tree``'s structure, shapes and dtypes."""
    leaves = tree_leaves(tree)
    shapes = [leaf.shape for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])

    def unravel(vec: torch.Tensor):
        parts = torch.split(vec, sizes)
        return tree_unflatten(tree, [p.reshape(s).to(d) for p, s, d in
                                     zip(parts, shapes, dtypes, strict=True)])

    return flat, unravel
