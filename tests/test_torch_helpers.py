"""The ported modules' small public helpers against the reference on the
CPU: FedOVA's ``init``, ``binary_labels``, ``client_class_mask`` and
``add_class`` (targets ``tests/test_fedova.py``), the optimizer façade
``core.baselines.make``, and the numpy streams ``labels_per_client`` and
``batches``.

The reference's draws are fed in through ``utils/convert.from_jax``.
Tolerances: labels, masks, stacked draws, partitions and batches exact;
three steps of each optimizer through ``make`` within 1e-5 of each
leaf's norm (f32 sums in other orders, as tests/test_torch_core.py holds
the server step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro.configs.base import FedConfig as RFedConfig  # noqa: E402
from repro.core import baselines as rbaselines  # noqa: E402
from repro.core import fedova as rfedova  # noqa: E402
from repro.data import partition as rpartition  # noqa: E402
from repro.data import synthetic as rsynthetic  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import baselines, fedova  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.utils.convert import from_jax  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_binary_labels_and_class_mask_match_reference():
    for y, n in (([0, 2, 2, 1], 4), ([3, 3, 3], 5), ([0, 1, 2, 3, 4], 5)):
        ry, py = jnp.asarray(y), torch.tensor(y)
        for cls in range(n):
            got, want = fedova.binary_labels(py, cls), rfedova.binary_labels(ry, cls)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(_np(got), _np(want))
        got, want = fedova.client_class_mask(py, n), rfedova.client_class_mask(ry, n)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), _np(want))


def _component(key):
    k1, k2 = jax.random.split(key)
    return {"w": jax.random.normal(k1, (6, 1)), "b": jax.random.normal(k2, (1,))}


class _RefDraws:
    """A port ``component_init`` that hands out the reference's draws for
    its keys, one a call, in order."""

    def __init__(self, keys):
        self.draws = [from_jax(jax.tree.map(np.asarray, _component(k)))
                      for k in keys]

    def __call__(self, generator):
        return self.draws.pop(0)


def test_init_and_add_class_stack_the_reference_draws():
    """init stacks one component a class (the reference's one key a
    class); add_class appends one and leaves the others and their
    predictions as they were (tests/test_fedova.py's smooth adaptation)."""
    key = jax.random.PRNGKey(3)
    want = rfedova.init(_component, 4, key)
    got = fedova.init(_RefDraws(jax.random.split(key, 4)), 4)
    assert got.n_classes == want.n_classes == 4
    for a, b in zip(tree_leaves(got.components), jax.tree.leaves(want.components)):
        np.testing.assert_array_equal(_np(a), _np(b))
    key5 = jax.random.PRNGKey(5)
    rbig = rfedova.add_class(want, _component, key5)
    big = fedova.add_class(got, _RefDraws([key5]))
    assert big.n_classes == rbig.n_classes == 5
    for a, b in zip(tree_leaves(big.components), jax.tree.leaves(rbig.components)):
        np.testing.assert_array_equal(_np(a), _np(b))

    def apply(p, x):
        return x @ p["w"] + p["b"]
    x = np.random.default_rng(0).normal(size=(32, 6)).astype(np.float32)
    logits = [apply(fedova.component(m, c), torch.from_numpy(x))
              for m in (got, big) for c in range(4)]
    for c in range(4):
        assert torch.equal(logits[c], logits[4 + c])
    np.testing.assert_array_equal(
        _np(fedova.predict(apply, big, torch.from_numpy(x))),
        _np(rfedova.predict(lambda p, x: x @ p["w"] + p["b"], rbig,
                            jnp.asarray(x))))


@pytest.mark.parametrize("name", ["fim_lbfgs", "fedavg_sgd", "fedavg_adam"])
def test_baselines_make_matches_reference(name):
    kw = dict(learning_rate=0.05, second_order_lr=0.5, lbfgs_m=3,
              max_step_norm=1.0, fim_damping=1e-2, fim_ema=0.9)
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(5, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    rstate, rupd = rbaselines.make(name, jax.tree.map(jnp.asarray, params),
                                   RFedConfig(**kw))
    state, upd = baselines.make(name, from_jax(params), FedConfig(**kw))
    rp, p = jax.tree.map(jnp.asarray, params), from_jax(params)
    rupd = jax.jit(rupd)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        f = {k: np.square(v) * 0.1 for k, v in g.items()}
        rp, rstate, _ = rupd(rstate, rp, jax.tree.map(jnp.asarray, g),
                             jax.tree.map(jnp.asarray, f))
        p, state, _ = upd(state, p, from_jax(g), from_jax(f))
    for a, b in zip(tree_leaves((p, state)), jax.tree.leaves((rp, rstate))):
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        assert np.linalg.norm(a - b) <= 1e-5 * max(np.linalg.norm(b), 1e-30)
    with pytest.raises(ValueError, match="unknown optimizer"):
        baselines.make("no-such", from_jax(params), FedConfig(**kw))


def test_labels_per_client_and_batches_are_the_reference_streams():
    labels = np.random.default_rng(1).integers(0, 10, size=600)
    parts = partition.noniid_partition(labels, 20, 2, 10, seed=4)
    assert partition.labels_per_client(labels, parts) == \
        rpartition.labels_per_client(labels, parts)
    x = np.arange(103 * 3, dtype=np.float32).reshape(103, 3)
    y = np.arange(103)
    got = list(synthetic.batches(x, y, 16, np.random.default_rng(7), epochs=2))
    want = list(rsynthetic.batches(x, y, 16, np.random.default_rng(7), epochs=2))
    assert len(got) == len(want) == 2 * (103 // 16)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
