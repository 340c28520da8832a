"""The port's sharding layer against the reference on the CPU: the rule
tables and ``spec_for`` (``tests/test_sharding.py``'s five rule tests, each
also against ``repro.utils.sharding.spec_for`` on the same mesh stand-in),
and, for each of the ten assigned architectures at their FULL published
size, every leaf's logical axes, its spec on the 16 x 16 and 2 x 16 x 16
meshes under the three rule tables, and the bytes one rank holds.

The reference's trees come from ``repro.launch.train.abstract_params`` /
``train_state_shapes`` / ``abstract_cache`` (``eval_shape``: no devices),
the port's from its meta-device helpers; both once per module.  Every
comparison is exact: strings, specs, shapes, dtypes and byte counts.
"""
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro.configs import base as rbase  # noqa: E402
from repro.launch import train as rtrain  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import mamba2 as rmamba  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.utils import sharding as rshd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import attention, mamba2, model  # noqa: E402
from repro_torch.utils import sharding as shd  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULES = {"default": (None, None), "opt": (shd.OPT_RULES, rshd.OPT_RULES),
         "fsdp": (shd.PARAM_RULES_FSDP, rshd.PARAM_RULES_FSDP)}


def _same(shape, axes, mesh, rules=(None, None)):
    """The port's spec, checked equal to the reference's; -> it."""
    got = shd.spec_for(shape, axes, FakeMesh(mesh), rules[0])
    assert got == tuple(rshd.spec_for(shape, axes, FakeMesh(mesh), rules[1]))
    return got


# ---------------------------------------------------------------- the rules
def test_rule_tables_equal_the_reference():
    assert shd.DEFAULT_RULES == rshd.DEFAULT_RULES
    assert shd.OPT_RULES == rshd.OPT_RULES
    assert shd.PARAM_RULES_FSDP == rshd.PARAM_RULES_FSDP
    for axes in ("", None, "layers,heads,embed", " a , b"):
        assert shd.parse_axes(axes) == rshd.parse_axes(axes)


def test_spec_divisible():
    mesh = {"data": 16, "model": 16}
    assert _same((4096, 8192), "embed,mlp", mesh) == (None, "model")
    assert _same((49152, 4096), "vocab,embed", mesh) == ("model", None)


def test_spec_divisibility_fallback():
    """phi4's 24 heads don't divide 16 -> replicate that dim only."""
    mesh = {"data": 16, "model": 16}
    assert _same((2, 24, 128), "layers,heads,head_dim", mesh) == (None,) * 3
    assert _same((2, 48, 128), "layers,heads,head_dim", mesh) == (
        None, "model", None)


def test_missing_mesh_axis_dropped():
    mesh = {"data": 4, "model": 2}
    assert _same((8, 16), "batch,embed", mesh) == ("data", None)


def test_axis_not_reused():
    mesh = {"data": 2, "model": 2}
    assert _same((4, 4), "mlp,qkv", mesh) == ("model", None)


def test_opt_rules_shard_embed_over_data():
    mesh = {"data": 16, "model": 16}
    assert _same((10, 36, 4096, 14336), "history,layers,embed,mlp", mesh,
                 RULES["opt"]) == (None, None, "data", "model")


def test_placements_and_local_shapes_follow_the_spec():
    """A dim mapped to ("pod", "data") is Shard(d) on both mesh dims; the
    local shape divides each sharded dim by its axes' product; the
    replication is the product of the unused axes; data_spec as the
    reference's."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    spec = shd.spec_for((10, 4096, 14336), "history,embed,mlp", mesh,
                        shd.OPT_RULES)
    assert spec == (None, ("pod", "data"), "model")
    assert shd.spec_placements(spec, mesh) == [Shard(1), Shard(1), Shard(2)]
    assert shd.local_shape((10, 4096, 14336), spec, mesh) == (10, 128, 896)
    assert shd.replication(spec, mesh) == 1
    rep = shd.spec_for((4096,), "embed", mesh)
    assert shd.spec_placements(rep, mesh) == [Replicate()] * 3
    assert shd.replication(rep, mesh) == 512
    for m in (mesh, FakeMesh({"data": 4, "model": 2}), FakeMesh({"model": 2})):
        assert shd.data_spec(m, None) == tuple(rshd.data_spec(m, None))


def test_distribute_refuses_a_tensor_off_the_mesh_device():
    """``distribute_tensor`` would copy a tensor on another device type
    onto the mesh's without a word (a card's state onto a CPU mesh):
    ``distribute`` refuses it, and the debug mesh lies on the cards
    unless the caller asks for the CPU, as the production mesh does."""
    import inspect

    from repro_torch.launch import mesh as meshlib

    class CudaMesh:
        device_type = "cuda"

    with pytest.raises(ValueError, match="a cpu tensor on a cuda mesh"):
        shd.distribute(torch.zeros(4), CudaMesh(), [])
    for fn in (meshlib.make_debug_mesh, meshlib.make_production_mesh):
        assert inspect.signature(fn).parameters["device_type"].default == "cuda"


def test_local_leaf_sum_is_the_unsharded_sum():
    """``LeafSum.local``: no mesh, every weight 1, the tree's numel; its
    dots and weighted sums are ``tree_dot``'s and the plain sum, bit for
    bit (the unsharded server step is its one-group case)."""
    from repro_torch.utils.pytree import tree_dot

    rng = np.random.default_rng(0)
    a = {"w": torch.from_numpy(rng.normal(size=(6, 7)).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(size=(10,)).astype(np.float32)).bfloat16()}
    b = {k: v * 3 - 1 for k, v in a.items()}
    ls = shd.LeafSum.local(a)
    assert ls.mesh is None and ls.weights == [1.0, 1.0] and ls.numel == 52
    got = ls.dots([(a, b), (a, a)])
    assert torch.equal(got[0], tree_dot(a, b))
    assert torch.equal(got[1], tree_dot(a, a))
    parts = [v.float().sum() for v in tree_leaves(a)]
    assert torch.equal(ls.weighted(parts), torch.stack(parts).sum())


# ------------------------------------------------ the ten assigned archs
def _ref_paths(tree):
    """[(path, leaf)] of a reference tree, keys as plain names."""
    def name(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return getattr(k, attr)
        raise TypeError(k)
    return [(tuple(name(k) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_paths(tree, path=()):
    """[(path, leaf)] of a port tree, in leaf order (dict keys sorted,
    NamedTuples by field name)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_paths(tree[k], path + (k,))]
    if isinstance(tree, tuple):
        keys = tree._fields if hasattr(tree, "_fields") else range(len(tree))
        return [x for k, t in zip(keys, tree) for x in _port_paths(t, path + (k,))]
    return [(path, tree)]


@pytest.fixture(scope="module")
def trees():
    """arch -> {"ref": (params, axes, opt, opt_axes), "port": (...)} at
    full size: the reference's eval_shape trees, the port's meta ones."""
    out = {}
    for arch in rbase.ASSIGNED:
        rcfg, cfg = rbase.get(arch), base.get(arch)
        out[arch] = {
            "ref": rtrain.train_state_shapes(rcfg, rtrain.opt_config(rcfg)),
            "port": train.train_state_shapes(cfg, train.opt_config(cfg))}
    return out


def test_assigned_is_the_references():
    assert configs.ASSIGNED == base.ASSIGNED == rbase.ASSIGNED


@pytest.mark.parametrize("arch", rbase.ASSIGNED)
def test_axes_trees_and_meta_shapes_match_reference(trees, arch):
    """Params and fim_lbfgs state: every leaf's path, logical axes, shape
    and dtype the reference's, "layers," prefixes and Jamba's restacking
    included; the shape helpers allocate nothing (meta)."""
    ref, port = trees[arch]["ref"], trees[arch]["port"]
    for r_vals, p_vals in ((ref[0], port[0]), (ref[2], port[2])):
        rv, pv = _ref_paths(r_vals), _port_paths(p_vals)
        assert [p for p, _ in pv] == [p for p, _ in rv]
        for (_, p), (_, r) in zip(pv, rv):
            assert p.device.type == "meta"
            assert (tuple(p.shape), str(p.dtype)[6:]) == (tuple(r.shape),
                                                          str(r.dtype))
    for r_axes, p_axes in ((ref[1], port[1]), (ref[3], port[3])):
        assert _port_paths(p_axes) == _ref_paths(r_axes)
    cfg = base.get(arch)
    assert train.train_state_axes(cfg, train.opt_config(cfg)) == (port[1],
                                                                  port[3])
    assert model.param_axes(cfg) == port[1]
    for name, init_axes in (("fedavg_adam", baselines.adam_axes),
                            ("fedavg_sgd", baselines.sgd_axes)):
        r = rtrain.train_state_shapes(rbase.get(arch), None, name)[3]
        assert _port_paths(init_axes(port[1])) == _ref_paths(r)


@pytest.mark.parametrize("arch", rbase.ASSIGNED)
def test_specs_match_reference_on_both_meshes(trees, arch):
    """Every leaf's spec on 16x16 and 2x16x16 under DEFAULT_RULES,
    OPT_RULES and PARAM_RULES_FSDP, for the params and the fim_lbfgs
    state, is the reference's (``_same``)."""
    _, axes, opt, opt_axes = trees[arch]["port"]
    params = trees[arch]["port"][0]
    for mesh in MESHES.values():
        for rules in RULES.values():
            for tree, ax in ((params, axes), (opt, opt_axes)):
                for x, a in zip(tree_leaves(tree), tree_leaves(ax)):
                    _same(tuple(x.shape), a, mesh, rules)
            got = shd.specs_for_tree(params, axes, FakeMesh(mesh), rules[0])
            want = rshd.specs_for_tree(trees[arch]["ref"][0],
                                       trees[arch]["ref"][1], FakeMesh(mesh),
                                       rules[1])
            assert _spec_leaves(got) == [tuple(s) for s in jax.tree.leaves(
                want, is_leaf=lambda s: isinstance(s, rshd.P))]


def _spec_leaves(tree):
    """The specs of a spec tree in leaf order (a spec is a plain tuple; the
    containers are dicts and NamedTuples)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if hasattr(tree, "_fields"):
        return [x for t in tree for x in _spec_leaves(t)]
    return [tree]


def _ref_rank_bytes(shapes, axes, mesh, rules) -> int:
    """itemsize x prod(dim / shards) over the leaves, from the reference's
    specs."""
    total = 0
    for s, a in zip(jax.tree.leaves(shapes), jax.tree.leaves(axes)):
        spec = rshd.spec_for(s.shape, a, FakeMesh(mesh), rules)
        n = 1
        for dim, entry in zip(s.shape, spec):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= dim // math.prod(mesh[m] for m in names)
        total += n * np.dtype(s.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", rbase.ASSIGNED)
def test_rank_bytes_match_the_reference_specs(trees, arch):
    """The bytes one rank holds of the params (the arch's own rule table)
    and of the fim_lbfgs state (OPT_RULES), on both meshes: exactly the
    arithmetic over the reference's specs; and the LeafSum weights are
    1 / the ranks holding each leaf's shard."""
    rp, rax, ro, roax = trees[arch]["ref"]
    pp, pax, po, poax = trees[arch]["port"]
    cfg = base.get(arch)
    prules = (shd.PARAM_RULES_FSDP, rshd.PARAM_RULES_FSDP) if cfg.fsdp else (
        None, None)
    for mesh in MESHES.values():
        assert shd.shard_bytes(pp, pax, FakeMesh(mesh), prules[0]) == \
            _ref_rank_bytes(rp, rax, mesh, prules[1])
        assert shd.shard_bytes(po, poax, FakeMesh(mesh), shd.OPT_RULES) == \
            _ref_rank_bytes(ro, roax, mesh, rshd.OPT_RULES)
        ls = shd.LeafSum.for_tree(pp, pax, FakeMesh(mesh), shd.OPT_RULES)
        assert ls.numel == sum(math.prod(x.shape) for x in tree_leaves(pp))
        n = math.prod(mesh.values())
        for x, a, w in zip(tree_leaves(pp), tree_leaves(pax), ls.weights):
            spec = shd.spec_for(x.shape, a, FakeMesh(mesh), shd.OPT_RULES)
            held = math.prod(x.shape) // math.prod(
                shd.local_shape(x.shape, spec, FakeMesh(mesh)))
            assert w * n == held


def test_input_cache_and_state_axes_match_reference():
    """input_specs / input_axes for every arch and shape, the per-layer
    cache and state axes, and each arch's decode cache (meta) against the
    reference's abstract_cache: paths, axes, shapes and dtypes."""
    assert attention.cache_axes() == tuple(rattn.cache_axes())
    assert mamba2.state_axes() == tuple(rmamba.state_axes())
    for arch in rbase.ASSIGNED:
        rcfg, cfg = rbase.get(arch), base.get(arch)
        for shape_name, rshape in rbase.INPUT_SHAPES.items():
            shape = base.INPUT_SHAPES[shape_name]
            assert model.input_axes(cfg, shape) == rmodel.input_axes(rcfg,
                                                                     rshape)
            got = {k: (tuple(v.shape), str(v.dtype)[6:], v.device.type)
                   for k, v in model.input_specs(cfg, shape).items()}
            want = {k: (tuple(v.shape), str(v.dtype), "meta")
                    for k, v in rmodel.input_specs(rcfg, rshape).items()}
            assert got == want
        shape = base.INPUT_SHAPES["decode_32k"]
        if not model.supports_shape(cfg, shape)[0]:
            continue
        rcache, raxes = rtrain.abstract_cache(rcfg, 8, 64)
        cache, axes = train.abstract_cache(cfg, 8, 64)
        assert _port_paths(axes) == _ref_paths(raxes)
        assert [(p, tuple(x.shape), str(x.dtype)[6:], x.device.type)
                for p, x in _port_paths(cache)] == [
                    (p, tuple(x.shape), str(x.dtype), "meta")
                    for p, x in _ref_paths(rcache)]
