"""The port's client and server steps against the reference on the CPU:
the FIM diagonal and the Algorithm-1 client function (g), the VL-BFGS
Gram paths and direction (e), and the FIM-L-BFGS server update over 12
steps (h).  Inputs are made with numpy from a seed and given to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import paper_models as rcfg  # noqa: E402
from repro.core import fim as rfim  # noqa: E402
from repro.core import fim_lbfgs as rfl  # noqa: E402
from repro.core import lbfgs as rlbfgs  # noqa: E402
from repro.fed import client as rclient  # noqa: E402
from repro.models import cnn as rcnn  # noqa: E402
from repro_torch.configs import paper_models as pcfg  # noqa: E402
from repro_torch.core import fim as pfim  # noqa: E402
from repro_torch.core import fim_lbfgs as pfl  # noqa: E402
from repro_torch.core import lbfgs as plbfgs  # noqa: E402
from repro_torch.fed import client as pclient  # noqa: E402
from repro_torch.models import cnn as pcnn  # noqa: E402
from repro_torch.utils.convert import from_jax  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

SHAPES = {"w": (6, 7), "b": (11,), "z": {"k": (3, 2, 2)}}


def _tree(rng, shapes, fn=None):
    fn = fn or (lambda s: rng.normal(size=s).astype(np.float32))
    return {k: _tree(rng, v, fn) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def _pt(tree):
    return from_jax(tree)


def _flat_np(tree):
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(tree)])


def _flat_pt(tree):
    return np.concatenate([x.numpy().ravel() for x in tree_leaves(tree)])


# --------------------------------------------------------- (g) client step
def _cnn_batch(seed=0, batch=12):
    rc = rcfg.reduced(rcfg.FMNIST_CNN)
    pc = pcfg.reduced(pcfg.FMNIST_CNN)
    # the reference's init jitted: the same draws, compiled once
    rparams = jax.jit(lambda key: rcnn.init(rc, key)[0])(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch,) + rc.input_shape).astype(np.float32)
    y = rng.integers(0, 10, size=batch).astype(np.int64)
    return rc, pc, rparams, from_jax(jax.tree.map(np.asarray, rparams)), x, y


def _assert_tree_close(ours, theirs, rtol, atol_frac):
    """Leafwise allclose with atol a fraction of each leaf's largest
    magnitude (Fisher entries span many decades)."""
    for p, r in zip(tree_leaves(ours), jax.tree.leaves(theirs), strict=True):
        r = np.asarray(r)
        atol = atol_frac * max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(p.detach().numpy(), r, rtol=rtol, atol=atol)


def test_per_example_diag_matches_reference():
    """Tolerance: per-example gradients of an f32 CNN sum in different
    orders in XLA and PyTorch; squared, they agree to 1e-4 relative."""
    rc, pc, rp, pp, x, y = _cnn_batch()
    want = jax.jit(lambda p, a, b: rfim.per_example_diag(
        rcnn.per_example_loss_fn(rc), p, a, b, kernels="off"))(
            rp, jnp.asarray(x), jnp.asarray(y))
    got = pfim.per_example_diag(pcnn.per_example_loss_fn(pc), pp,
                                torch.from_numpy(x), torch.from_numpy(y),
                                kernels="auto")
    _assert_tree_close(got, want, rtol=1e-4, atol_frac=1e-6)


@pytest.mark.parametrize("fim_mode", ["per_example", "microbatch"])
def test_grad_fim_fn_matches_reference(fim_mode):
    """(grad, Γ, loss) of the Algorithm-1 client; same tolerance reason
    as above, the loss to 1e-6 relative."""
    rc, pc, rp, pp, x, y = _cnn_batch(seed=1, batch=9)
    rfn = jax.jit(rclient.make_grad_fim_fn(
        lambda p, b: rcnn.softmax_loss(p, rc, b),
        rcnn.per_example_loss_fn(rc), fim_mode, kernels="auto"))
    pfn = pclient.make_grad_fim_fn(
        lambda p, b: pcnn.softmax_loss(p, pc, b),
        pcnn.per_example_loss_fn(pc), fim_mode, kernels="auto")
    rg, rd, rloss = rfn(rp, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    pg, pd, ploss = pfn(pp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=1e-6)
    _assert_tree_close(pg, rg, rtol=1e-4, atol_frac=1e-6)
    _assert_tree_close(pd, rd, rtol=1e-4, atol_frac=1e-6)


def test_fim_state_update_mean_and_smoothing():
    rng = np.random.default_rng(3)
    diags = [_tree(rng, SHAPES, lambda s: rng.uniform(size=s).astype(np.float32))
             for _ in range(3)]
    s = _tree(rng, SHAPES)
    rs = rfim.init(_jx(diags[0]))
    ps = pfim.init(_pt(diags[0]))
    for d in diags:
        rs = rfim.update(rs, _jx(d), 0.9)
        ps = pfim.update(ps, _pt(d), 0.9)
    assert int(ps.steps) == int(rs.steps) == 3
    _assert_tree_close(ps.diag, rs.diag, rtol=1e-6, atol_frac=1e-7)
    np.testing.assert_allclose(float(pfim.mean_diag(ps)),
                               float(rfim.mean_diag(rs)), rtol=1e-6)
    _assert_tree_close(pfim.smooth_y(ps, _pt(s), 1e-2),
                       rfim.smooth_y(rs, _jx(s), 1e-2), rtol=1e-6,
                       atol_frac=1e-7)


# ------------------------------------------------------- (e) VL-BFGS core
def _history(rng, m, n_pairs, shapes=SHAPES):
    """Reference and port histories after the same positive-curvature
    pushes (y = s * U(0.5, 2), so <s, y> > 0)."""
    zeros = _tree(rng, shapes, lambda s: np.zeros(s, np.float32))
    rh, ph = rlbfgs.init(_jx(zeros), m), plbfgs.init(_pt(zeros), m)
    for _ in range(n_pairs):
        s = _tree(rng, shapes)
        y = jax.tree.map(
            lambda a: (a * rng.uniform(0.5, 2.0, a.shape)).astype(np.float32), s)
        rh, ph = rlbfgs.push(rh, _jx(s), _jx(y)), plbfgs.push(ph, _pt(s), _pt(y))
    return rh, ph


@pytest.mark.parametrize("n_pairs", [0, 3, 7])
def test_gram_paths_agree(n_pairs):
    """Per-leaf gram_matrix == basis path == reference, to f32 rounding
    (1e-5 relative to the largest entry)."""
    rng = np.random.default_rng(n_pairs)
    rh, ph = _history(rng, 5, n_pairs)
    g = _tree(rng, SHAPES)
    assert int(ph.idx) == int(rh.idx) and int(ph.count) == int(rh.count)
    want = np.asarray(rlbfgs.gram_matrix(rh, _jx(g)))
    scale = max(np.abs(want).max(), 1.0)
    per_leaf = plbfgs.gram_matrix(ph, _pt(g)).numpy()
    basis = plbfgs._gram_via_kernel(ph, _pt(g), "auto").numpy()
    np.testing.assert_allclose(per_leaf / scale, want / scale, atol=1e-5)
    np.testing.assert_allclose(basis / scale, per_leaf / scale, atol=1e-5)


@pytest.mark.parametrize("n_pairs", [0, 1, 3, 5, 9])
def test_direction_matches_reference_two_loop(n_pairs):
    """Against the textbook f64 two-loop, at the reference test's
    tolerance (f32 Gram-space arithmetic: 2e-5 relative)."""
    rng = np.random.default_rng(n_pairs)
    m = 5
    zeros = _tree(rng, SHAPES, lambda s: np.zeros(s, np.float32))
    ph = plbfgs.init(_pt(zeros), m)
    pairs = []
    for _ in range(n_pairs):
        s = _tree(rng, SHAPES)
        y = tree_map(lambda a: a * rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
                     s)
        pairs.append((s, y))
        ph = plbfgs.push(ph, _pt(s), _pt(y))
    g = _tree(rng, SHAPES)
    p = plbfgs.direction(ph, _pt(g), kernels="auto")
    live = pairs[-m:]
    want = rlbfgs.reference_two_loop([_flat_np(s) for s, _ in live],
                                     [_flat_np(y) for _, y in live], _flat_np(g))
    np.testing.assert_allclose(_flat_pt(p), want, rtol=2e-5, atol=1e-6)
    # and the reference's Gram-space direction on the same history
    rh, _ = _history(np.random.default_rng(n_pairs), m, 0)
    for s, y in pairs:
        rh = rlbfgs.push(rh, _jx(s), _jx(y))
    np.testing.assert_allclose(_flat_pt(p), _flat_np(rlbfgs.direction(rh, _jx(g))),
                               rtol=2e-5, atol=1e-6)


# ----------------------------------------------- (h) FIM-L-BFGS server step
@pytest.mark.parametrize("eps,max_step", [(1e-8, 0.5), (0.9, 0.0)])
def test_fim_lbfgs_update_tracks_reference_over_12_steps(eps, max_step):
    """Params, stats and history idx/count step for step.  m=4 so the
    ring wraps; eps=0.9 makes the curvature guard reject some pairs;
    max_step=0.5 clips most steps.  Tolerance 1e-4 relative / 1e-6
    absolute: f32 sums in other orders, compounded over 12 steps."""
    rng = np.random.default_rng(11)
    kw = dict(learning_rate=0.7, m=4, curvature_eps=eps,
              max_step_norm=max_step, kernels="auto")
    rcfg_, pcfg_ = rfl.FimLbfgsConfig(**kw), pfl.FimLbfgsConfig(**kw)
    params = _tree(rng, SHAPES)
    rp, pp = _jx(params), _pt(params)
    rs, ps = rfl.init(rp, rcfg_), pfl.init(pp, pcfg_)
    # the reference's update jitted, as its cohort simulator runs it:
    # compiled once instead of op by op
    rupdate = jax.jit(rfl.update, static_argnums=4)
    accepted = []
    for _ in range(12):
        grad = _tree(rng, SHAPES)
        diag = _tree(rng, SHAPES,
                     lambda s: (rng.uniform(size=s) ** 3).astype(np.float32))
        rp, rs, rstats = rupdate(rs, rp, _jx(grad), _jx(diag), rcfg_)
        pp, ps, pstats = pfl.update(ps, pp, _pt(grad), _pt(diag), pcfg_)
        np.testing.assert_allclose(_flat_pt(pp), _flat_np(rp), rtol=1e-4,
                                   atol=1e-6)
        for k in rstats:
            np.testing.assert_allclose(float(pstats[k]), float(rstats[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        assert int(ps.history.idx) == int(rs.history.idx)
        assert int(ps.history.count) == int(rs.history.count)
        assert int(ps.step) == int(rs.step) and int(ps.fim.steps) == int(rs.fim.steps)
        accepted.append(float(pstats["pair_accepted"]))
    if eps > 0.5:
        assert 0 < sum(accepted) < 12  # the guard both accepted and rejected
