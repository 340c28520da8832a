"""CNN parity: the port's ``models.cnn`` against ``repro.models.cnn`` from
the reference's own initial parameters (carried across with
``utils.convert.from_jax``).

Tolerances: f32 throughout; convolutions and matmuls sum in different
orders in XLA and PyTorch, so logits and losses agree to ~1e-6 relative,
and gradients (one more reduction over the batch) to 1e-4 relative /
1e-6 absolute.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro.configs import paper_models as rcfg  # noqa: E402
from repro.models import cnn as rcnn  # noqa: E402
from repro_torch.configs import paper_models as pcfg  # noqa: E402
from repro_torch.models import cnn as pcnn  # noqa: E402
from repro_torch.utils.convert import from_jax  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

CASES = [("fmnist_cnn", 6), ("kws_cnn", 5)]


def _rinit(rc, seed):
    """The reference's ``cnn.init`` jitted: the same draws, compiled once
    instead of op by op."""
    return jax.jit(lambda key: rcnn.init(rc, key)[0])(jax.random.PRNGKey(seed))


# the reference's functions of (params, cfg, ...) jitted with the config
# static, compiled once instead of op by op
_rjit = functools.partial(jax.jit, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _setup(name, batch, seed=0):
    rc = rcfg.reduced(rcfg.CNN_CONFIGS[name])
    pc = pcfg.reduced(pcfg.CNN_CONFIGS[name])
    rparams = _rinit(rc, seed)
    pparams = from_jax(jax.tree.map(np.asarray, rparams))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch,) + rc.input_shape).astype(np.float32)
    y = rng.integers(0, rc.num_classes, size=batch).astype(np.int64)
    return rc, pc, rparams, pparams, x, y


@pytest.mark.parametrize("name,batch", CASES)
def test_init_shapes_and_leaf_order_match(name, batch):
    rc, pc, rparams, _, _, _ = _setup(name, batch)
    ours = pcnn.init(pc, torch.Generator().manual_seed(0))
    ref_leaves = jax.tree.leaves(rparams)
    assert [tuple(t.shape) for t in tree_leaves(ours)] == \
        [tuple(a.shape) for a in ref_leaves]


@pytest.mark.parametrize("name,batch", CASES)
def test_logits_loss_accuracy_match(name, batch):
    rc, pc, rparams, pparams, x, y = _setup(name, batch)
    ref_logits = np.asarray(_rjit(rcnn.apply)(rparams, rc, jnp.asarray(x)))
    our_logits = pcnn.apply(pparams, pc, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(our_logits, ref_logits, rtol=1e-5, atol=1e-6)
    batch_r = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    batch_p = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    np.testing.assert_allclose(
        float(pcnn.softmax_loss(pparams, pc, batch_p)),
        float(_rjit(rcnn.softmax_loss)(rparams, rc, batch_r)), rtol=1e-6)
    yb = (y % 2).astype(np.int64)
    rb, pb = rc.binary(), pc.binary()
    rbp = _rinit(rb, 1)
    pbp = from_jax(jax.tree.map(np.asarray, rbp))
    np.testing.assert_allclose(
        float(pcnn.binary_loss(pbp, pb, {"x": batch_p["x"],
                                          "y": torch.from_numpy(yb)})),
        float(_rjit(rcnn.binary_loss)(rbp, rb, {"x": batch_r["x"],
                                          "y": jnp.asarray(yb)})), rtol=1e-6)
    assert float(pcnn.accuracy(pparams, pc, batch_p["x"], batch_p["y"])) == \
        float(_rjit(rcnn.accuracy)(rparams, rc, batch_r["x"], batch_r["y"]))


@pytest.mark.parametrize("name,batch", CASES)
def test_gradients_match(name, batch):
    rc, pc, rparams, pparams, x, y = _setup(name, batch)
    rgrad = _rjit(jax.grad(rcnn.softmax_loss))(
        rparams, rc, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    pgrad = torch.func.grad(pcnn.softmax_loss)(
        pparams, pc, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    for r, p in zip(jax.tree.leaves(rgrad), tree_leaves(pgrad), strict=True):
        np.testing.assert_allclose(p.numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-6)
    # the per-example closure is the batch loss on one example
    f_r = jax.jit(rcnn.per_example_loss_fn(rc))
    f_p = pcnn.per_example_loss_fn(pc)
    np.testing.assert_allclose(
        float(f_p(pparams, torch.from_numpy(x[0]), torch.from_numpy(y[:1])[0])),
        float(f_r(rparams, jnp.asarray(x[0]), jnp.asarray(y[0]))), rtol=1e-6)


def test_pool_padding_guard():
    """SAME pooling with a low-side pad (3x3 pool over extent 7) is not
    what ceil_mode computes, so the port refuses it instead of drifting."""
    x = torch.zeros((1, 1, 7, 7))
    with pytest.raises(ValueError, match="SAME pads"):
        pcnn._max_pool_same(x, (3, 3))
