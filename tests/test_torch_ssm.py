"""The port's Mamba-2 mixer (``models/mamba2.py``), the pure-SSM model
(mamba2-370m) and the Jamba hybrid (``models/hybrid.py``, jamba-v0.1-52b)
against the reference on the CPU: the configs, softplus and the causal
conv, the chunked SSD with S no multiple of the chunk, the recurrent
decode step by step, the SSD's gradient past f32's exp range, the
forward, prefill and decode of both smoke configs, the port's own decode
against its own prefill, the loss (with Jamba's MoE aux) and its
gradients, remat, and the init's structure (Jamba's ``fim_lbfgs`` train
step is in ``tests/test_torch_moe.py``).

Inputs are made with numpy from a seed; parameters are the reference's
own draws carried across with ``from_jax``, all in f32.  Tolerances: one
op or one short sum 1e-6 (softplus, the conv); the mixer 1e-5 (f32 sums
in other orders over a few chunks); logits 1e-4 as
``tests/test_torch_llm.py``, except where a test holds a decode against a
chunked prefill: there 1e-3, the reference's own bound
(``tests/test_decode_consistency.py``), since the SSD's cumulative
exponentials and the recurrence's running products round differently;
the loss 1e-5 relative and each gradient leaf within 1e-4 of its norm,
as ``tests/test_torch_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro.configs import base as rbase  # noqa: E402
from repro.configs import jamba_52b as rjamba  # noqa: E402
from repro.configs import mamba2_370m as rmamba  # noqa: E402
from repro.models import hybrid as rhybrid  # noqa: E402
from repro.models import mamba2 as rmamba2  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro_torch.configs import base, jamba_52b, mamba2_370m  # noqa: E402
from repro_torch.data.synthetic import zipf_tokens  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import hybrid, mamba2, model, transformer  # noqa: E402
from repro_torch.utils import pytree  # noqa: E402
from repro_torch.utils.convert import from_jax  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

ARCHS = {"mamba2-370m": (mamba2_370m, rmamba),
         "jamba-v0.1-52b": (jamba_52b, rjamba)}
OP_TOL, MIXER_TOL, LOGIT_TOL, DECODE_TOL = 1e-6, 1e-5, 1e-4, 1e-3
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _smoke(arch, **kw):
    port, ref = ARCHS[arch]
    return port.smoke_config().replace(**kw), ref.smoke_config().replace(**kw)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _trees_close(got, want, frac):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w, strict=True):
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        assert a.shape == b.shape
        assert np.linalg.norm(a - b) <= frac * max(np.linalg.norm(b), 1e-30)


def _port(rtree):
    return from_jax(jax.tree.map(np.asarray, rtree))


def _mixer(seed=0, **kw):
    """(cfg, rcfg, reference mixer params, the port's); mamba2's smoke
    config (d 256, 16 heads of 32, state 32, chunk 32)."""
    cfg, rcfg = _smoke("mamba2-370m", **kw)
    rp, _ = rmamba2.mamba_init(jax.random.PRNGKey(seed), rcfg)
    return cfg, rcfg, rp, _port(rp)


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's seed-0 init of each smoke config, drawn once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg = _smoke(arch)[1]
            cache[arch] = jax.jit(lambda k: rmodel.init(rcfg, k)[0])(
                jax.random.PRNGKey(0))
        return cache[arch]
    return get


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_carry_the_reference_numbers(arch):
    ours, theirs = base.get(arch), rbase.get(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    smoke, rsmoke = _smoke(arch)
    assert dataclasses.asdict(smoke) == dataclasses.asdict(rsmoke)
    assert ours.param_count() == theirs.param_count()


# -------------------------------------------------------------------- mixer
def test_softplus_and_causal_conv_match_reference():
    """softplus is jax.nn.softplus at every x, past F.softplus's threshold
    of 20 too; the conv's taps in the reference's correlation order."""
    x = np.linspace(-60.0, 60.0, 1201, dtype=np.float32)
    _close(mamba2._softplus(torch.from_numpy(x)), jax.nn.softplus(x), OP_TOL)
    cfg, _, rp, p = _mixer()
    xbc = np.random.default_rng(2).normal(size=(2, 24, 96)).astype(np.float32)
    w = np.array(rp["conv_w"])[:, :96]
    _close(mamba2._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w)),
           rmamba2._causal_conv(jnp.asarray(xbc), jnp.asarray(w)), OP_TOL)


@pytest.mark.parametrize("S,chunk", [(48, 32), (40, 16), (64, 64), (7, 32)])
def test_mamba_apply_matches_reference(S, chunk):
    """The chunked SSD: 48 tokens at chunk 32 halve it to 16 (three
    chunks), 40 at 16 to 8 (five), 7 to one chunk of 7."""
    cfg, rcfg, rp, p = _mixer(ssm_chunk=chunk)
    x = _x(cfg, 2, S, seed=S)
    _close(mamba2.mamba_apply(p, cfg, torch.from_numpy(x)),
           rmamba2.mamba_apply(rp, rcfg, jnp.asarray(x)), MIXER_TOL)


def test_mamba_decode_matches_reference_step_by_step():
    """The recurrent step against the reference's, output and both
    states at every step, and the steps against the chunked forward."""
    cfg, rcfg, rp, p = _mixer()
    x = _x(cfg, 2, 20, seed=5)
    rstate = rmamba2.state_init(rcfg, 2)
    state = mamba2.state_init(cfg, 2, "cpu")
    outs = []
    for t in range(20):
        want, rstate = rmamba2.mamba_decode(rp, rcfg, jnp.asarray(x[:, t:t + 1]),
                                            rstate)
        got, state = mamba2.mamba_decode(p, cfg, torch.from_numpy(x[:, t:t + 1]),
                                         state)
        _close(got, want, MIXER_TOL)
        _close(state.ssm, rstate.ssm, MIXER_TOL)
        _close(state.conv, rstate.conv, MIXER_TOL)
        outs.append(got)
    _close(torch.cat(outs, dim=1),
           rmamba2.mamba_apply(rp, rcfg, jnp.asarray(x)), DECODE_TOL)


def test_ssd_gradient_is_finite_past_the_exp_range():
    """dt_bias 5 makes dt ~ 5, so a chunk of 64 sums ~320 of it: the
    reference exponentiates the masked-out decays (exp(+320) = inf) before
    masking, and its gradient is NaN; the port masks first.  The forwards
    agree, the port's gradient is finite."""
    cfg, rcfg, rp, p = _mixer(ssm_chunk=64)
    rp = {**rp, "dt_bias": jnp.full_like(rp["dt_bias"], 5.0)}
    p = {**p, "dt_bias": torch.full_like(p["dt_bias"], 5.0)}
    x = _x(cfg, 1, 64, seed=6)
    _close(mamba2.mamba_apply(p, cfg, torch.from_numpy(x)),
           rmamba2.mamba_apply(rp, rcfg, jnp.asarray(x)), MIXER_TOL)
    rgrad = jax.jit(jax.grad(lambda w: jnp.sum(rmamba2.mamba_apply(
        {**rp, "in_proj": w}, rcfg, jnp.asarray(x)) ** 2)))(rp["in_proj"])
    assert np.isnan(np.asarray(rgrad)).any()
    w = p["in_proj"].clone().requires_grad_()
    out = mamba2.mamba_apply({**p, "in_proj": w}, cfg, torch.from_numpy(x))
    (grad,) = torch.autograd.grad(out.square().sum(), [w])
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0


# ------------------------------------------------------------------- models
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_prefill_match_reference(arch, ref_params):
    cfg, rcfg = _smoke(arch)
    rp = ref_params(arch)
    p = _port(rp)
    toks = zipf_tokens(2, 48, cfg.vocab_size, seed=1)
    rfwd = rhybrid.forward if arch.startswith("jamba") else rtransformer.forward
    hidden, aux = model.forward(p, cfg, torch.from_numpy(toks))
    rhidden, raux = rfwd(rp, rcfg, jnp.asarray(toks))
    _close(hidden, rhidden, LOGIT_TOL)
    assert abs(float(aux) - float(raux)) <= 1e-6 * max(abs(float(raux)), 1.0)
    got = train.make_prefill_step(cfg)(p, {"tokens": torch.from_numpy(toks)})
    want = jax.jit(lambda prm, b: rmodel.prefill_fn(prm, rcfg, b))(
        rp, {"tokens": jnp.asarray(toks)})
    assert got.shape == want.shape
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_sequence_matches_reference(arch, ref_params):
    """12 decode steps over fixed tokens against the reference's serve
    step: logits at every step, then every state of the cache."""
    cfg, rcfg = _smoke(arch)
    rp = ref_params(arch)
    p = _port(rp)
    T = 12
    toks = zipf_tokens(2, T, cfg.vocab_size, seed=3)
    rcache, _ = rmodel.init_cache(rcfg, batch=2, context=T)
    cache = model.init_cache(cfg, 2, T, device="cpu")
    rstep = jax.jit(lambda prm, c, t: rmodel.decode_fn(prm, rcfg, c, t))
    step = train.make_serve_step(cfg)
    for t in range(T):
        want, rcache = rstep(rp, rcache, jnp.asarray(toks[:, t:t + 1]))
        got, cache = step(p, cache, torch.from_numpy(toks[:, t:t + 1]))
        _close(got, want, LOGIT_TOL)
    _trees_close(cache, rcache, LOGIT_TOL)
    assert int(cache.pos) == int(rcache.pos) == T


@pytest.mark.parametrize("arch,T,B", [("mamba2-370m", 48, 2),
                                      ("jamba-v0.1-52b", 32, 1)])
def test_port_decode_matches_port_prefill(arch, T, B):
    """tests/test_decode_consistency.py's checks on the port alone: the
    SSD duality (48 tokens, no multiple of the chunk's 32) and the hybrid
    with a capacity that drops nothing (cf 8, as there)."""
    cfg = _smoke(arch, capacity_factor=8.0)[0]
    params = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(zipf_tokens(B, T, cfg.vocab_size, seed=1))
    hidden, _ = model.forward(params, cfg, toks)
    want = transformer.logits_fn(params, cfg, hidden)
    cache = model.init_cache(cfg, B, T, device="cpu")
    outs = []
    for t in range(T):
        lg, cache = model.decode_fn(params, cfg, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    assert float((torch.stack(outs, dim=1) - want).abs().max()) < DECODE_TOL


def test_decode_writes_the_ssm_state_in_place():
    cfg, _ = _smoke("mamba2-370m")
    params = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = model.init_cache(cfg, 2, 8, device="cpu")
    ptrs = [t.data_ptr() for t in cache.layer_cache]
    _, new = model.decode_fn(params, cfg, cache, torch.ones((2, 1),
                                                            dtype=torch.int32))
    assert [t.data_ptr() for t in new.layer_cache] == ptrs
    assert bool(cache.layer_cache.ssm.abs().sum() > 0)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_gradients_match_reference(arch, ref_params):
    """jax.value_and_grad(repro.models.model.loss_fn) against the port's
    loss (Jamba's with router_aux_coef times its 4 MoE layers' aux) and
    autograd."""
    cfg, rcfg = _smoke(arch)
    rp = ref_params(arch)
    toks = zipf_tokens(2, 64, cfg.vocab_size, seed=3)
    (want, rmet), rgrad = jax.jit(jax.value_and_grad(
        lambda prm, b: rmodel.loss_fn(prm, rcfg, b), has_aux=True))(
            rp, {"tokens": jnp.asarray(toks)})
    params = _port(rp)
    live = [t.requires_grad_() for t in tree_leaves(params)]
    loss, met = model.loss_fn(pytree.tree_unflatten(params, live), cfg,
                              {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, live)
    assert abs(float(loss.detach()) - float(want)) <= LOSS_TOL * abs(float(want))
    assert abs(float(met["aux"].detach()) - float(rmet["aux"])) <= 1e-6 * max(
        abs(float(rmet["aux"])), 1.0)
    _trees_close(pytree.tree_unflatten(params, list(grads)), rgrad, GRAD_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_equals_no_remat(arch):
    """cfg.remat recomputes each layer (Jamba: each mm block inside each
    period, nested) in the backward: the same loss and gradients."""
    cfg, _ = _smoke(arch)
    params = model.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(zipf_tokens(2, 32, cfg.vocab_size, seed=4))
    outs = []
    for remat in (False, True):
        live = [t.detach().clone().requires_grad_() for t in tree_leaves(params)]
        loss, _ = model.loss_fn(pytree.tree_unflatten(params, live),
                                cfg.replace(remat=remat), {"tokens": toks})
        outs.append((float(loss.detach()), torch.autograd.grad(loss, live)))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1], strict=True):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_structure_matches_reference(arch, ref_params):
    cfg, _ = _smoke(arch)
    shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                          ref_params(arch))
    ours = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        model.init(cfg, device="cpu"))
    assert ours == shapes
    assert base.get(arch).activation_dtype == torch.bfloat16
    if arch.startswith("jamba"):
        assert hybrid.PERIOD == rhybrid.PERIOD
