"""Logical-axis sharding rules (t5x style) on a ``DeviceMesh`` (port of
``repro.utils.sharding``).

Every parameter / optimizer-state leaf is annotated with a logical-axis
string like ``"layers,heads,embed"``; the annotation tree mirrors the
parameter tree (``models.model.param_axes`` and the ``*_axes`` helpers
beside each ``init``).  A rule table maps logical axis names to mesh axis
names; ``spec_for`` also enforces divisibility: a dimension that does not
divide by its mesh axes' size falls back to replication for that
dimension only (phi4-mini's 24 query heads on a 16-way model axis).

``spec_for`` returns a plain tuple laid out like the reference's
``PartitionSpec`` (one entry a tensor dim: None, a mesh axis name, or a
tuple of them); ``placements_for`` turns it into one DTensor ``Placement``
a mesh dim (``Shard(d)`` where tensor dim d maps to that mesh axis,
``Replicate()`` elsewhere), and ``distribute_tree`` lays a tree out on the
mesh by those placements.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Union

import torch

MeshAxes = Union[None, str, tuple]

# Default logical -> mesh axis rules for the production meshes.
#   "data" axes carry the federated client cohorts (and the global batch);
#   "model" carries megatron/expert sharding.  The "pod" axis (multi-pod
#   mesh) extends the data axis: cohorts span pods.
DEFAULT_RULES: dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "clients": ("pod", "data"),
    "vocab": "model",
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv": "model",
    "experts": "model",
    "router_experts": None,   # router weights replicated (see models/moe.py)
    "expert_mlp": None,
    "expert_group": ("pod", "data"),
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "layers": None,
    "seq": None,
    "window": None,
    "cap": None,
    "conv": None,
    "history": None,  # L-BFGS (s, y) memory dimension
}

# ZeRO-1 rules for *optimizer state* (L-BFGS history, Fisher diag, moments):
# the embed dim also shards over the data/pod axes.  Parameters stay
# replicated across data (TP within a pod + DP), but the m-deep history of
# a 132B model cannot (20 x 2 x params bf16), so the optimizer state is
# sharded over every mesh axis and the round's update all-gathers the
# new parameters (ZeRO-1).
OPT_RULES: dict[str, MeshAxes] = dict(DEFAULT_RULES, embed=("pod", "data"))

# Full FSDP rules for the *parameters* of the >=100B architectures
# (dbrx-132b, qwen3-moe-235b): TP=16 alone leaves >16 GB of weights a
# chip, so the embed dim of every weight also shards over data/pod.
PARAM_RULES_FSDP: dict[str, MeshAxes] = dict(DEFAULT_RULES, embed=("pod", "data"))


def parse_axes(axes: Optional[str]) -> tuple:
    if axes is None or axes == "":
        return ()
    return tuple(a.strip() for a in axes.split(","))


def mesh_shape(mesh) -> dict:
    """-> {axis name: size}: a ``DeviceMesh`` adapted to the reference's
    interface, which reads any object with a ``.shape`` mapping (its
    tests pass such a stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape, strict=True))
    return dict(mesh.shape)


def spec_for(shape: Sequence[int], axes: Optional[str], mesh,
             rules: Optional[Mapping[str, MeshAxes]] = None) -> tuple:
    """The spec of ``shape`` annotated with logical ``axes``: a tuple with
    one entry a dim (None, a mesh axis name, or a tuple of names).

    Falls back to replication a dimension at a time when the dim's size
    does not divide the mesh axes' size, or when the mesh lacks the mapped
    axis (a single-pod mesh has no "pod"); no mesh axis is used twice."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    sizes = mesh_shape(mesh)
    names = parse_axes(axes)
    if len(names) != len(shape):
        raise ValueError(f"axes {names} do not match shape {tuple(shape)}")
    spec, used = [], set()
    for dim, name in zip(shape, names, strict=True):
        mesh_axes = rules.get(name)
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        if mesh_axes is not None:
            mesh_axes = tuple(a for a in mesh_axes if a in sizes and a not in used)
            if not mesh_axes:
                mesh_axes = None
        if mesh_axes is not None:
            size = math.prod(sizes[a] for a in mesh_axes)
            if size == 0 or dim % size != 0:
                mesh_axes = None
        if mesh_axes is None:
            spec.append(None)
        else:
            used.update(mesh_axes)
            spec.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    return tuple(spec)


def _leaves_map(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over a tree and its axes tree (dicts by key,
    tuples by position; a str is an axes leaf)."""
    if isinstance(tree, dict):
        return {k: _leaves_map(fn, tree[k], axes_tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        kids = [_leaves_map(fn, t, a) for t, a in zip(tree, axes_tree,
                                                       strict=True)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(kids)
    return fn(tree, axes_tree)


def specs_for_tree(tree_shapes, axes_tree, mesh, rules=None):
    """The spec of every leaf (anything with a ``.shape``) of a tree."""
    return _leaves_map(lambda x, ax: spec_for(x.shape, ax, mesh, rules),
                       tree_shapes, axes_tree)


def data_spec(mesh, *trailing: Optional[str]) -> tuple:
    """Batch-leading spec: batch over (pod, data), the rest as given."""
    sizes = mesh_shape(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    lead = batch_axes if len(batch_axes) > 1 else (
        batch_axes[0] if batch_axes else None)
    return (lead, *trailing)


def spec_placements(spec: tuple, mesh) -> list:
    """One ``Placement`` a mesh dim for a spec: ``Shard(d)`` on each mesh
    axis tensor dim d maps to (a dim mapped to ("pod", "data") is
    ``Shard(d)`` on both), ``Replicate()`` on the others and on an axis of
    size 1 (one shard is the whole tensor, and DTensor refuses some views
    of a dim "sharded" one way)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    names = list(sizes)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return out


def placements_for(shape: Sequence[int], axes: Optional[str], mesh,
                   rules: Optional[Mapping[str, MeshAxes]] = None) -> list:
    """The DTensor placements (one a mesh dim) of ``shape`` annotated with
    ``axes`` under ``rules``: ``spec_placements(spec_for(...))``."""
    return spec_placements(spec_for(shape, axes, mesh, rules), mesh)


def local_shape(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """The shape of one rank's shard under ``spec`` (every sharded dim
    divides: ``spec_for`` falls back to replication where it would not)."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, entry in zip(shape, spec, strict=True):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        out.append(dim // math.prod(sizes[a] for a in axes))
    return tuple(out)


def replication(spec: tuple, mesh) -> int:
    """The number of ranks that hold the same shard under ``spec``: the
    product of the sizes of the mesh axes the spec does not use."""
    sizes = mesh_shape(mesh)
    used = set()
    for entry in spec:
        if entry is not None:
            used.update((entry,) if isinstance(entry, str) else entry)
    return math.prod(s for a, s in sizes.items() if a not in used)


def shard_bytes(tree_shapes, axes_tree, mesh, rules=None) -> int:
    """Bytes one rank holds of a tree of tensors (real, meta or fake) laid
    out by ``rules``: the sum over leaves of itemsize x the local shape."""
    total = []

    def leaf(x, ax):
        spec = spec_for(x.shape, ax, mesh, rules)
        total.append(x.dtype.itemsize * math.prod(local_shape(x.shape, spec, mesh)))
    _leaves_map(leaf, tree_shapes, axes_tree)
    return sum(total)


def distribute(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``distribute_tensor(x, mesh, placements)`` for a tensor that already
    lies on the mesh's device type: ``distribute_tensor`` would copy one
    on another device over without a word (a card's state onto a CPU
    mesh), so that is refused."""
    from torch.distributed.tensor import distribute_tensor

    if x.device.type != mesh.device_type:
        raise ValueError(f"a {x.device.type} tensor on a {mesh.device_type} "
                         "mesh: make the mesh with device_type="
                         f"{x.device.type!r}")
    return distribute_tensor(x, mesh, placements)


def distribute_tree(tree, axes_tree, mesh, rules=None):
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` with the
    placements of its logical axes (``distribute``: each rank keeps its
    shard of the full tensor it is given)."""
    return _leaves_map(
        lambda x, ax: distribute(x, mesh, placements_for(x.shape, ax, mesh,
                                                          rules)),
        tree, axes_tree)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def to_placements(x: torch.Tensor, placements) -> torch.Tensor:
    """``x`` redistributed to ``placements`` (a no-op when it has them)."""
    if list(x.placements) == list(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def mesh_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over every rank of ``mesh``: ONE all-reduce over
    the mesh flattened to one dim (a functional collective, so
    ``CommDebugMode`` counts it)."""
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():   # the mesh's rank tables are real
        flat = mesh if mesh.ndim == 1 else mesh._flatten()
    return funcol.wait_tensor(funcol.all_reduce(x, "sum", flat))


class LeafSum:
    """Sums over a tree laid out on a mesh, computed from each rank's
    local shards: each leaf's local partial is weighted by 1 / (the number
    of ranks that hold the same shard), so a leaf replicated over "data"
    is not counted "data" times, and the weighted sum over the leaves is
    reduced by ONE all-reduce over the whole mesh.

    ``weights``: one a leaf in tree order; ``numel``: the global element
    count of the tree (``fim.mean_diag``'s divisor).  With no mesh
    (``local``: ``mesh`` None, every weight 1) the sums are the unsharded
    ones: a tree on one device is the one-group case of a sharded tree."""

    def __init__(self, weights, mesh, numel: int):
        self.weights = list(weights)
        self.mesh = mesh
        self.numel = numel

    @classmethod
    def local(cls, tree) -> "LeafSum":
        """The sums of a tree held whole on one device."""
        from repro_torch.utils.pytree import tree_leaves

        leaves = tree_leaves(tree)
        return cls([1.0] * len(leaves), None,
                   sum(math.prod(x.shape) for x in leaves))

    @classmethod
    def for_tree(cls, tree_shapes, axes_tree, mesh, rules=None) -> "LeafSum":
        """The weights of a tree laid out by ``rules`` on ``mesh``."""
        reps, sizes = [], []

        def leaf(x, ax):
            reps.append(replication(spec_for(x.shape, ax, mesh, rules), mesh))
            sizes.append(math.prod(x.shape))
        _leaves_map(leaf, tree_shapes, axes_tree)
        return cls([1.0 / r for r in reps], mesh, sum(sizes))

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mesh is None else mesh_all_reduce(x, self.mesh)

    def _total(self, parts) -> torch.Tensor:
        """sum_i w_i parts_i over the leaves, before the all-reduce (with
        every weight 1, ``torch.stack(parts).sum(0)``: the unsharded sum)."""
        return torch.stack([p * w if w != 1.0 else p
                            for p, w in zip(parts, self.weights,
                                            strict=True)]).sum(dim=0)

    def weighted(self, parts) -> torch.Tensor:
        """sum_i w_i parts_i (one 0-d or equal-shaped f32 tensor a leaf)
        over the mesh."""
        return self.all_reduce(self._total(parts))

    def dots(self, pairs) -> list:
        """[<a, b>] over the whole tree for each (a, b) of local trees, in
        f32 (each as ``pytree.tree_dot`` sums it), with one all-reduce for
        all of them."""
        from repro_torch.utils.pytree import _leaf_dot, tree_leaves

        totals = [self._total([_leaf_dot(x, y) for x, y in zip(
            tree_leaves(a), tree_leaves(b), strict=True)]) for a, b in pairs]
        return list(self.all_reduce(torch.stack(totals)).unbind(0))
