"""The port's LLM train step against the reference on the CPU: the pytree
helpers, ``rms_norm``'s custom backward, the LM and encoder losses with
their gradients, remat, ``launch/train.make_train_step`` over fim_lbfgs,
fedavg_adam and fedavg_sgd, and the donating server update.

Inputs are made with numpy from a seed; parameters are the reference's
own draws carried across with ``from_jax``.  Everything that is compared
with the reference computes in f32, except where a test says bf16.
Tolerances: the pytree algebra 1e-6 (one f32 op, or an f32 dot in
another order); ``rms_norm``'s gradients 1e-5 in f32, and in bf16 one bf16
ulp (2^-7) of the terms each cotangent is rounded from, with 90 % of dx
bit for bit the reference's; the losses 1e-5 relative, each gradient leaf
within 1e-4 of its norm (f32 sums in other orders through two layers and
the chunked cross-entropy, as tests/test_torch_llm.py holds logits); the
train step: per-step loss 1e-5 relative, each state leaf within 1e-4 of
its norm with the f32 history (the whole-slice tolerances of
tests/test_torch_fed.py), Adam's held step by step with its entries at
the eps floor counted (``_adam_close``), and with the bf16 history 1e-4
on the loss and 2e-3 of each leaf's norm: an f32 drift of ~1e-7 moves a
history entry across a bf16 rounding boundary now and then, one bf16 ulp
(2^-8 relative) each, and the next steps carry those into the params.
The reference's step runs op by op (see ``_train_pair``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro.configs import chameleon_34b as rchameleon  # noqa: E402
from repro.configs import granite_8b as rgranite  # noqa: E402
from repro.configs import hubert_xlarge as rhubert  # noqa: E402
from repro.core import fim_lbfgs as rfl  # noqa: E402
from repro.launch import train as rtrain  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro.utils import pytree as rpytree  # noqa: E402
from repro_torch.configs import chameleon_34b, granite_8b, hubert_xlarge  # noqa: E402
from repro_torch.core import fim_lbfgs  # noqa: E402
from repro_torch.data.synthetic import zipf_tokens  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers, model, transformer  # noqa: E402
from repro_torch.utils import pytree  # noqa: E402
from repro_torch.utils.convert import from_jax, load_like  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

F32 = np.float32
SMOKE = {"granite-8b": (granite_8b, rgranite),
         "chameleon-34b": (chameleon_34b, rchameleon),
         "hubert-xlarge": (hubert_xlarge, rhubert)}
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t).astype(F32)


def _leaf_close(got, want, frac):
    """||got - want|| <= frac * ||want||, in f64."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape
    assert np.linalg.norm(g - w) <= frac * max(np.linalg.norm(w), 1e-30), (
        np.linalg.norm(g - w), np.linalg.norm(w))


def _trees_close(got, want, frac):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _leaf_close(a, b, frac)


# ------------------------------------------------------------ pytree helpers
def _pair(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}

    def draw():
        return {"a": rng.normal(size=shapes["a"]).astype(F32),
                "b": {"c": rng.normal(size=shapes["b"]["c"]).astype(F32),
                      "d": rng.normal(size=shapes["b"]["d"]).astype(F32)}}
    return draw(), draw()


HELPERS = {
    "tree_scale": lambda m, a, b: m.tree_scale(0.37, a),
    "tree_add": lambda m, a, b: m.tree_add(a, b),
    "tree_sub": lambda m, a, b: m.tree_sub(a, b),
    "tree_mul": lambda m, a, b: m.tree_mul(a, b),
    "tree_axpy": lambda m, a, b: m.tree_axpy(-1.5, a, b),
    "tree_zeros_like": lambda m, a, b: m.tree_zeros_like(a),
    "tree_ones_like": lambda m, a, b: m.tree_ones_like(a),
    "tree_cast": lambda m, a, b: m.tree_cast(a, m_bf16(m)),
    "tree_stack_init": lambda m, a, b: m.tree_stack_init(a, 3),
    "tree_stack_push": lambda m, a, b: m.tree_stack_push(
        m.tree_stack_init(a, 3), b, 1),
    "tree_stack_index": lambda m, a, b: m.tree_stack_index(
        m.tree_stack_push(m.tree_stack_init(a, 3), b, 2), 2),
    "tree_dot": lambda m, a, b: m.tree_dot(a, b),
    "tree_norm": lambda m, a, b: m.tree_norm(a),
}


def m_bf16(module):
    return jnp.bfloat16 if module is rpytree else torch.bfloat16


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_pytree_helper_matches_reference(name):
    a, b = _pair(0)
    want = HELPERS[name](rpytree, jax.tree.map(jnp.asarray, a),
                         jax.tree.map(jnp.asarray, b))
    got = HELPERS[name](pytree, from_jax(a), from_jax(b))
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        assert str(x.dtype)[6:] == str(y.dtype)
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-6, atol=1e-6)
    assert pytree.tree_size(from_jax(a)) == rpytree.tree_size(a)


def test_pytree_stack_helpers_take_device_indices_and_bf16_dots():
    """A 0-d device index (the history's idx) reads and writes the same
    slot as a host int; a bf16 dot accumulates in f32 slice by slice, equal
    to the f32 dot of the widened values."""
    a, b = _pair(1)
    pa, pb = from_jax(a), from_jax(b)
    buf = pytree.tree_stack_init(pa, 4)
    for x, y in zip(tree_leaves(pytree.tree_stack_push(buf, pb, torch.tensor(3))),
                    tree_leaves(pytree.tree_stack_push(buf, pb, 3))):
        assert torch.equal(x, y)
    got = pytree.tree_stack_index(pytree.tree_stack_push(buf, pb, 3),
                                  torch.tensor(3, dtype=torch.int32))
    for x, y in zip(tree_leaves(got), tree_leaves(pb)):
        assert torch.equal(x, y)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=1000).astype(F32))
    xb = x.bfloat16()
    old = pytree.DOT_SLICE
    try:
        pytree.DOT_SLICE = 64          # 16 slices
        sliced = pytree.tree_dot([xb], [xb])
    finally:
        pytree.DOT_SLICE = old
    whole = torch.dot(xb.float(), xb.float())
    assert abs(float(sliced) - float(whole)) <= 1e-5 * float(whole)


# ------------------------------------------------------------------ rms_norm
def _rms_inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(3, 7, 64)) * 2.0).astype(F32)
    scale = rng.normal(size=(64,)).astype(F32)
    ct = rng.normal(size=(3, 7, 64)).astype(F32)
    return x, scale, ct


def _rms_grads_ref(x, scale, ct, dtype):
    def f(x, s):
        return jnp.sum(rlayers.rms_norm(x, s).astype(jnp.float32) * ct)
    jd = getattr(jnp, dtype)
    return jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(x, jd),
                                               jnp.asarray(scale, jd))


def _rms_grads_port(x, scale, ct, dtype):
    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(td).requires_grad_()
    st = torch.from_numpy(scale).to(td).requires_grad_()
    out = layers.rms_norm(xt, st)
    return torch.autograd.grad(out, (xt, st),
                               grad_outputs=torch.from_numpy(ct).to(td))


def test_rms_norm_gradients_match_reference_vjp_f32():
    x, scale, ct = _rms_inputs(0, "float32")
    want = _rms_grads_ref(x, scale, ct, "float32")
    got = _rms_grads_port(x, scale, ct, "float32")
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5)


def test_rms_norm_gradients_match_reference_vjp_bf16():
    """bf16 in, bf16 cotangents out, rounded where the reference rounds
    them.  Each entry lies within one bf16 ulp (2^-7) of the terms it is
    rounded from: dx = gs·inv - x·coef within 2^-7 (|gs·inv| + |x·coef|
    + |dx|), dscale within 2^-7 of the sum of |g·x̂| (the f32 inverse root
    itself may differ by an f32 ulp, XLA's rsqrt against torch's, which
    flips a row's bf16 inv now and then); and at least 90 % of dx is bit
    for bit the reference's, where autograd through the textbook f32 form,
    rounded once, matches far fewer (the control)."""
    x, scale, ct = _rms_inputs(1, "bfloat16")
    want = [_np(w) for w in _rms_grads_ref(x, scale, ct, "bfloat16")]
    dx, dscale = _rms_grads_port(x, scale, ct, "bfloat16")
    assert dx.dtype == dscale.dtype == torch.bfloat16
    xb = torch.from_numpy(x).bfloat16().float()
    sb = torch.from_numpy(scale).bfloat16().float()
    g = torch.from_numpy(ct).bfloat16().float()
    inv = torch.rsqrt((xb * xb).sum(-1) / x.shape[-1] + 1e-6)
    gs = g * sb
    coef = inv ** 3 * (gs * xb).sum(-1) / x.shape[-1]
    terms = ((gs * inv[..., None]).abs() + (xb * coef[..., None]).abs()).numpy()
    assert (np.abs(_np(dx) - want[0])
            <= 2.0 ** -7 * (terms + np.abs(want[0]))).all()
    xn = (xb * inv[..., None]).numpy()
    sum_terms = np.abs(g.numpy() * xn).sum(axis=(0, 1))
    assert (np.abs(_np(dscale) - want[1])
            <= 2.0 ** -7 * (sum_terms + np.abs(want[1]))).all()
    equal = float((_np(dx) == want[0]).mean())
    assert equal >= 0.9
    # control: the textbook f32 form's gradient, rounded to bf16 once
    xt, st = xb.clone().requires_grad_(), sb.clone().requires_grad_()
    plain = xt * torch.rsqrt((xt * xt).mean(-1, keepdim=True) + 1e-6) * st
    dx_plain, _ = torch.autograd.grad(plain, (xt, st), grad_outputs=g)
    assert float((_np(dx_plain.bfloat16()) == want[0]).mean()) < equal - 0.2


# -------------------------------------------------------------------- losses
def _configs(arch, **kw):
    port, ref = SMOKE[arch]
    return port.smoke_config().replace(**kw), ref.smoke_config().replace(**kw)


def _batch(cfg, B, S, seed):
    """(reference batch, port batch) from one numpy draw."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_embed":
        x = rng.normal(size=(B, S, cfg.d_model)).astype(F32)
        y = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
        return ({"features": jnp.asarray(x), "labels": jnp.asarray(y)},
                {"features": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    toks = zipf_tokens(B, S, cfg.vocab_size, seed=seed)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def _ref_params(rcfg, seed=0):
    return jax.jit(lambda key: rmodel.init(rcfg, key)[0])(jax.random.PRNGKey(seed))


def _port_value_and_grad(params, cfg, batch):
    leaves = [p.detach().clone().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = model.loss_fn(pytree.tree_unflatten(params, leaves), cfg,
                                  batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, pytree.tree_unflatten(params, list(grads))


@pytest.mark.parametrize("arch", sorted(SMOKE))
def test_loss_and_gradients_match_reference(arch, monkeypatch):
    """jax.value_and_grad(repro.models.model.loss_fn) against the port's
    loss and autograd, in f32, with LOSS_CHUNK cut to 64 in both so that
    S = 96 halves it to 32 (three chunks).  chameleon-34b runs qk_norm;
    hubert-xlarge is the encoder loss (per-frame labels, a given mask)."""
    monkeypatch.setattr(rtransformer, "LOSS_CHUNK", 64)
    monkeypatch.setattr(transformer, "LOSS_CHUNK", 64)
    cfg, rcfg = _configs(arch)
    rb, pb = _batch(cfg, 2, 96, seed=3)
    if cfg.is_encoder:     # a mask that drops a third of the frames
        mask = (np.arange(96) % 3 != 0).astype(F32)[None].repeat(2, 0)
        rb["mask"], pb["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    rparams = _ref_params(rcfg)
    (want, rmet), rgrad = jax.jit(jax.value_and_grad(
        lambda p, b: rmodel.loss_fn(p, rcfg, b), has_aux=True))(rparams, rb)
    loss, met, grads = _port_value_and_grad(
        from_jax(jax.tree.map(np.asarray, rparams)), cfg, pb)
    loss = float(loss.detach())
    assert abs(loss - float(want)) <= LOSS_TOL * abs(float(want))
    assert abs(float(met["ce"].detach()) - float(rmet["ce"])) <= LOSS_TOL * abs(
        float(want))
    assert float(met["aux"]) == float(rmet["aux"]) == 0.0
    _trees_close(grads, rgrad, GRAD_TOL)
    # the attention projections learn: their gradients are not zero
    assert float(grads["layers"]["attn"]["wq"].abs().max()) > 0


def test_lm_loss_labels_roll_and_mask_the_last_position():
    """The labels are the tokens shifted left with the first wrapped to
    the end, and that last position is masked: the loss is the mean CE of
    the S - 1 real next tokens, checked against a direct sum."""
    cfg, _ = _configs("granite-8b")
    params = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(zipf_tokens(2, 40, cfg.vocab_size, seed=9))
    loss, _ = model.loss_fn(params, cfg, {"tokens": toks})
    hidden, _ = transformer.forward(params, cfg, toks)
    lg = transformer.logits_fn(params, cfg, hidden)[:, :-1]
    want = torch.nn.functional.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                             toks[:, 1:].reshape(-1).long())
    assert abs(float(loss) - float(want)) <= 1e-5 * float(want)


@pytest.mark.parametrize("arch", ["granite-8b", "hubert-xlarge"])
def test_remat_equals_no_remat(arch):
    """cfg.remat recomputes each layer in the backward
    (torch.utils.checkpoint): the same loss and gradients as without."""
    cfg, _ = _configs(arch)
    params = model.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    _, pb = _batch(cfg, 2, 64, seed=4)
    outs = [_port_value_and_grad(params, cfg.replace(remat=r), pb)
            for r in (False, True)]
    assert float(outs[0][0].detach()) == float(outs[1][0].detach())
    for a, b in zip(tree_leaves(outs[0][2]), tree_leaves(outs[1][2])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_flash_attention_refuses_grad_and_the_loss_trains_attention():
    """ops.flash_attention never returns a result cut from autograd: with
    grad mode on and an input that requires grad it raises on every path.
    The loss runs the plain attention whatever the kernels knob says, so
    its attention gradients equal the kernels="off" forward's and are not
    zero."""
    q = torch.randn((1, 4, 16, 32), requires_grad=True)
    k, v = torch.randn((1, 2, 16, 32)), torch.randn((1, 2, 16, 32))
    for mode in ("auto", "off"):
        with pytest.raises(RuntimeError, match="forward only"):
            ops.flash_attention(q, k, v, mode=mode)
    with torch.no_grad():
        ops.flash_attention(q, k, v, mode="auto")
    cfg, _ = _configs("granite-8b")
    params = model.init(cfg, torch.Generator().manual_seed(2), device="cpu")
    toks = torch.from_numpy(zipf_tokens(2, 32, cfg.vocab_size, seed=2))
    grads = []
    for mode in ("auto", "off"):
        wq = params["layers"]["attn"]["wq"].detach().clone().requires_grad_()
        p = {**params, "layers": {**params["layers"], "attn": {
            **params["layers"]["attn"], "wq": wq}}}
        hidden, _ = transformer.forward(p, cfg, toks, kernels=mode)
        grads.append(torch.autograd.grad(hidden.square().mean(), [wq])[0])
    assert torch.equal(grads[0], grads[1])
    assert float(grads[0].abs().max()) > 0


# ---------------------------------------------------------------- train step
def _train_pair(optimizer, steps, lbfgs_dtype, seed=0, resync=False):
    """The reference's train step and the port's from the same init on the
    same batches: -> [(ref loss, port loss)], ref state, port state, ref
    params, port params.  ``resync``: each port step starts from the
    reference's params and state of that step (carried across), and each
    step's result is held to the reference's within 1e-4 of its norm."""
    cfg, rcfg = _configs("granite-8b", lbfgs_dtype=lbfgs_dtype)
    rocfg, pocfg = rtrain.opt_config(rcfg), train.opt_config(cfg)
    rparams, _, ropt, _ = rtrain.init_train_state(
        rcfg, rocfg, jax.random.PRNGKey(seed), optimizer)
    pparams = from_jax(jax.tree.map(np.asarray, rparams))
    _, popt = train.init_train_state(cfg, pocfg, optimizer=optimizer,
                                     device="cpu")
    if optimizer == "fim_lbfgs":
        popt = fim_lbfgs.init(pparams, pocfg)
    # op by op: jitted whole, XLA:CPU fuses the step's norms into
    # reductions that read ~3e-3 off (dir_norm 12.730 where the direction
    # is exactly -g of norm 12.767), and the trust-region clip carries that
    # into the params; each op alone computes them in f32
    rstep = rtrain.make_train_step(rcfg, rocfg, n_micro=2, optimizer=optimizer)
    pstep = train.make_train_step(cfg, pocfg, n_micro=2, optimizer=optimizer)
    data = zipf_tokens(4 * steps, 32, cfg.vocab_size, seed=seed + 7)
    losses = []
    for t in range(steps):
        toks = data[4 * t:4 * t + 4]
        if resync:
            pparams = from_jax(jax.tree.map(np.asarray, rparams))
            popt = load_like(popt, jax.tree.map(np.array, ropt))
        rparams, ropt, rst = rstep(rparams, ropt, {"tokens": jnp.asarray(toks)})
        pparams, popt, pst = pstep(pparams, popt,
                                   {"tokens": torch.from_numpy(toks)})
        losses.append((float(rst["loss"]), float(pst["loss"])))
        if "pair_accepted" in rst:
            assert float(pst["pair_accepted"]) == float(rst["pair_accepted"])
        if resync:
            _adam_close(pparams, popt, rparams, ropt, pocfg.learning_rate)
    return losses, ropt, popt, rparams, pparams


def _adam_close(pparams, popt, rparams, ropt, lr, b2=0.999, floor=1e-6):
    """One Adam step from the same state: the moments (linear in the
    gradient) within 1e-4 of their norm; the params within 1e-4 of their
    norm over the entries whose bias-corrected sqrt(v) is at least
    ``floor`` (100 x Adam's eps); below it the update m / (sqrt(v) + eps)
    is set by the gradient's f32 noise, so those entries are only held
    within 2 lr of the reference's, and those that differ at all are
    counted: at most 1e-3 of a leaf's entries."""
    _trees_close(popt.mu, ropt.mu, GRAD_TOL)
    _trees_close(popt.nu, ropt.nu, GRAD_TOL)
    assert int(popt.step) == int(ropt.step)
    bc2 = 1.0 - b2 ** int(ropt.step)
    for a, b, nu in zip(tree_leaves(pparams), jax.tree.leaves(rparams),
                        jax.tree.leaves(ropt.nu)):
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        noisy = np.sqrt(np.asarray(nu, np.float64) / bc2) < floor
        d = np.abs(a - b)
        assert np.linalg.norm(d[~noisy]) <= GRAD_TOL * np.linalg.norm(b)
        assert (d[noisy] <= 2 * lr).all()
        assert np.count_nonzero(d[noisy]) <= 1e-3 * d.size


@pytest.mark.parametrize("optimizer,steps", [("fim_lbfgs", 3),
                                             ("fedavg_sgd", 2)])
def test_train_step_matches_reference(optimizer, steps):
    """repro.launch.train.make_train_step against the port's on the granite
    smoke config with the f32 history: per-step loss 1e-5 relative, params
    and every part of the optimizer state within 1e-4 of its norm; the
    history's write slot and live count exact."""
    losses, ropt, popt, rparams, pparams = _train_pair(optimizer, steps,
                                                       "float32")
    for want, got in losses:
        assert abs(got - want) <= LOSS_TOL * abs(want)
    _trees_close(pparams, rparams, GRAD_TOL)
    _trees_close(popt, ropt, GRAD_TOL)
    if optimizer == "fim_lbfgs":
        assert int(popt.history.idx) == int(ropt.history.idx) == steps
        assert int(popt.history.count) == int(ropt.history.count) == steps


def test_adam_train_step_matches_reference():
    """fedavg_adam: 2 free-running steps with the per-step loss at 1e-5
    relative; the params and moments held step by step from the
    reference's state of that step (``_adam_close``).  Free running, the
    state cannot be held to 1e-4 of its norm: Adam moves an entry by up to
    lr (m / sqrt(v) = sign g on the first step), so an entry whose
    gradient sits at f32 noise level (sqrt(v) within 100 x eps) takes a
    step set by that noise, and the second step's gradients through those
    entries move ~0.1 % of the others (the near-zero drift of ROADMAP
    section 3, at the LLM's lr of 0.05)."""
    losses, *_ = _train_pair("fedavg_adam", 2, "float32")
    for want, got in losses:
        assert abs(got - want) <= LOSS_TOL * abs(want)
    _train_pair("fedavg_adam", 2, "float32", resync=True)


def test_train_step_bf16_history_matches_reference():
    """The config's own bf16 history (s, y stored in bf16, the Gram and
    the direction summed in f32 from it): loss 1e-4 relative, state within
    2e-3 of its norm (the module docstring says why)."""
    losses, ropt, popt, rparams, pparams = _train_pair("fim_lbfgs", 3,
                                                       "bfloat16", seed=1)
    assert tree_leaves(popt.history.s)[0].dtype == torch.bfloat16
    for want, got in losses:
        assert abs(got - want) <= 1e-4 * abs(want)
    _trees_close(pparams, rparams, 2e-3)
    _trees_close(popt, ropt, 2e-3)


def _server_inputs(seed, history_dtype):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (7,), "z": {"k": (3, 4)}}

    def tree():
        return {"w": rng.normal(size=shapes["w"]).astype(F32),
                "b": rng.normal(size=shapes["b"]).astype(F32),
                "z": {"k": rng.normal(size=shapes["z"]["k"]).astype(F32)}}
    return [from_jax(tree()) for _ in range(4)]


@pytest.mark.parametrize("history_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-8, 0.999], ids=["accepted", "rejected"])
def test_donating_update_equals_functional_bit_for_bit(history_dtype, eps):
    """fim_lbfgs.update(..., donate=True) writes the accepted pair and the
    Fisher EMA into the state's buffers in place; over 5 steps (m = 3, so
    the ring wraps) it gives the functional update's params, state and
    stats bit for bit, with pairs accepted and (eps = 0.999) rejected."""
    cfg = fim_lbfgs.FimLbfgsConfig(
        learning_rate=0.3, m=3, curvature_eps=eps, max_step_norm=0.5,
        history_dtype=getattr(torch, history_dtype))
    params, *_ = _server_inputs(0, history_dtype)
    runs = []
    for donate in (False, True):
        p, state = params, fim_lbfgs.init(params, cfg)
        rng = np.random.default_rng(5)
        stats = []
        for _ in range(5):
            g = tree_map(lambda x: torch.from_numpy(
                rng.normal(size=tuple(x.shape)).astype(F32)), params)
            fd = tree_map(lambda x: x.square() * 0.1, g)
            p, state, st = fim_lbfgs.update(state, p, g, fd, cfg,
                                            donate=donate)
            stats.append(st)
        runs.append((p, state, stats))
    (p0, s0, st0), (p1, s1, st1) = runs
    for a, b in zip(tree_leaves((p0, s0)), tree_leaves((p1, s1))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(st0, st1):
        assert {k: float(v) for k, v in a.items()} == {
            k: float(v) for k, v in b.items()}
    assert int(s1.history.count) == (0 if eps > 0.5 else 3)


def test_donating_update_writes_the_callers_buffers():
    """The donated state's history and Fisher buffers are the ones the
    update returns (no copy), and the functional update leaves its input
    state as it was."""
    cfg = fim_lbfgs.FimLbfgsConfig(m=2, max_step_norm=0.5)
    params, g, _, _ = _server_inputs(1, "float32")
    fd = tree_map(torch.square, g)
    state = fim_lbfgs.init(params, cfg)
    before = [t.clone() for t in tree_leaves(state)]
    _, new, _ = fim_lbfgs.update(state, params, g, fd, cfg)
    for a, b in zip(tree_leaves(state), before):
        assert torch.equal(a, b)
    _, new, _ = fim_lbfgs.update(state, params, g, fd, cfg, donate=True)
    for a, b in zip(tree_leaves((new.history.s, new.history.y, new.fim.diag)),
                    tree_leaves((state.history.s, state.history.y,
                                 state.fim.diag))):
        assert a is b
    assert float(tree_leaves(state.history.s)[0].abs().sum()) > 0
