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


# elements of a non-f32 leaf that tree_dot casts to f32 at once
DOT_SLICE = 1 << 22


def _leaf_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> in f32.  f32 leaves contract whole; any other leaf (bf16)
    in slices of ``DOT_SLICE`` elements cast to f32 one at a time, so no
    f32 copy of the whole leaf is made."""
    x, y = x.reshape(-1), y.reshape(-1)
    if x.dtype == y.dtype == torch.float32:
        return torch.dot(x, y)
    parts = [torch.dot(x[i:i + DOT_SLICE].float(), y[i:i + DOT_SLICE].float())
             for i in range(0, x.numel(), DOT_SLICE)]
    if not parts:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    return torch.stack(parts).sum()


def tree_dot(a, b) -> torch.Tensor:
    """<a, b> over every leaf, accumulated in f32."""
    parts = [_leaf_dot(x, y)
             for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True)]
    return torch.stack(parts).sum()


def tree_axpy(alpha, x, y):
    """alpha * x + y, leaf-wise (keeps y's dtype)."""
    return tree_map(
        lambda xi, yi: (alpha * xi.float() + yi.float()).to(yi.dtype), x, y)


def tree_scale(alpha, x):
    """alpha * x, leaf-wise, in f32 and cast back to each leaf's dtype."""
    return tree_map(lambda xi: (alpha * xi.float()).to(xi.dtype), x)


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_mul(a, b):
    """Hadamard product (used for diagonal-FIM * vector products)."""
    return tree_map(lambda x, y: x * y, a, b)


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def tree_zeros_like(a, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), a)


def tree_ones_like(a, dtype=None):
    return tree_map(lambda x: torch.ones_like(x, dtype=dtype or x.dtype), a)


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def tree_size(a) -> int:
    """Total number of scalar parameters."""
    return sum(x.numel() for x in tree_leaves(a))


def _slot(index, device) -> torch.Tensor:
    """A history slot (a host int or a 0-d device tensor) as a (1,) long
    index on ``device``, so a device index never waits on the host."""
    return torch.as_tensor(index, device=device).long().reshape(1)


def tree_stack_push(buf, x, index):
    """Write tree ``x`` into slot ``index`` of a stacked (m, ...) buffer,
    functionally: a new buffer, ``x`` cast to its dtype."""
    return tree_map(lambda b, xi: b.index_copy(
        0, _slot(index, b.device), xi.to(b.dtype).unsqueeze(0)), buf, x)


def tree_stack_init(x, m: int, dtype=None):
    """Allocate an (m, ...) zero history buffer shaped like tree ``x``."""
    return tree_map(lambda xi: torch.zeros((m,) + tuple(xi.shape),
                                           dtype=dtype or xi.dtype,
                                           device=xi.device), x)


def tree_stack_index(buf, index):
    """Read slot ``index`` from a stacked history buffer."""
    return tree_map(lambda b: b.index_select(0, _slot(index, b.device))[0],
                    buf)


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
