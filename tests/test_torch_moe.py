"""The port's MoE layer (``models/moe.py``) and its two MoE models
(qwen3-moe-235b-a22b, dbrx-132b) against the reference on the CPU: the
configs, the route and slot assignment, ``moe_apply`` and its aux loss and
dropped share, the port twins of ``tests/test_moe.py``'s invariants, the
plain dispatch of ``chip_smoke.py`` against both, the forward, prefill and
decode of both smoke configs, the port's own decode against its own
prefill, the loss with its aux and its gradients, and one ``fim_lbfgs``
train step on dbrx and on Jamba.

Inputs are made with numpy from a seed; parameters are the reference's
own draws carried across with ``from_jax``, all in f32.  Tolerances: the
route's expert sets, the keep mask and the dropped share exact (the
router's f32 logits agree to ~1e-7 and no tie sits at the k-th pick with
these draws; ``torch.topk`` orders ties otherwise than ``lax.top_k``, so
the sets, not the orders, are compared), the gates 1e-6; ``out`` 2e-4 as
``tests/test_moe.py``; aux 1e-6; logits 1e-4 as
``tests/test_torch_llm.py``; the loss 1e-5 relative and each gradient leaf
within 1e-4 of its norm, the train step's state too, as
``tests/test_torch_train.py``.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro.configs import base as rbase  # noqa: E402
from repro.configs import dbrx_132b as rdbrx  # noqa: E402
from repro.configs import jamba_52b as rjamba  # noqa: E402
from repro.configs import qwen3_moe_235b as rqwen  # noqa: E402
from repro.core import fim_lbfgs as rfl  # noqa: E402
from repro.launch import train as rtrain  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro_torch.configs import base, dbrx_132b, jamba_52b, qwen3_moe_235b  # noqa: E402
from repro_torch.core import fim_lbfgs  # noqa: E402
from repro_torch.data.synthetic import zipf_tokens  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers, model, moe, transformer  # noqa: E402
from repro_torch.utils import pytree  # noqa: E402
from repro_torch.utils.convert import from_jax  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import moe_apply_plain  # noqa: E402

ARCHS = {"qwen3-moe-235b-a22b": (qwen3_moe_235b, rqwen),
         "dbrx-132b": (dbrx_132b, rdbrx)}
# the train step's: an MoE model and the hybrid, whose FFNs are half MoE
TRAIN_ARCHS = {"dbrx-132b": (dbrx_132b, rdbrx),
               "jamba-v0.1-52b": (jamba_52b, rjamba)}
OUT_TOL, AUX_TOL, GATE_TOL, LOGIT_TOL = 2e-4, 1e-6, 1e-6, 1e-4
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _smoke(arch, **kw):
    port, ref = {**ARCHS, **TRAIN_ARCHS}[arch]
    return port.smoke_config().replace(**kw), ref.smoke_config().replace(**kw)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _leaf_close(got, want, frac):
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape
    assert np.linalg.norm(g - w) <= frac * max(np.linalg.norm(w), 1e-30), (
        np.linalg.norm(g - w), np.linalg.norm(w))


def _trees_close(got, want, frac):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w, strict=True):
        _leaf_close(a, b, frac)


def _layer(arch, seed=0, **kw):
    """(cfg, rcfg, reference MoE params, the port's) of one MoE layer."""
    cfg, rcfg = _smoke(arch, **kw)
    rp, _ = rmoe.moe_init(jax.random.PRNGKey(seed), rcfg)
    return cfg, rcfg, rp, from_jax(jax.tree.map(np.asarray, rp))


def _x(cfg, B, S, seed=1, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
            * scale).astype(np.float32)


def _ref_route(rp, rcfg, x):
    """The reference's routing and slots, line for line from
    ``repro.models.moe._moe_apply_gspmd``: -> (expert_idx, gates, slot,
    keep, C)."""
    B, S, d = x.shape
    N = B * S
    group = min(rcfg.moe_group, N)
    while N % group:
        group //= 2
    G, T, E, k = N // group, group, rcfg.num_experts, rcfg.top_k
    C = rmoe._capacity(T, k, E, rcfg.capacity_factor)
    xg = jnp.asarray(x).reshape(G, T, d)
    logits = jnp.einsum("gtd,de->gte", xg.astype(jnp.float32), rp["router"])
    gates, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    gates = gates / jnp.sum(gates, axis=-1, keepdims=True)
    flat = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(G, T * k, E)
    slot = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat, axis=-1)
    return (np.asarray(idx), np.asarray(gates), np.asarray(slot),
            np.asarray(slot < C), C)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's seed-0 init of each smoke config, drawn once."""
    cache = {}

    def get(arch, **kw):
        key = (arch, tuple(sorted(kw.items())))
        if key not in cache:
            rcfg = _smoke(arch, **kw)[1]
            cache[key] = jax.jit(lambda k: rmodel.init(rcfg, k)[0])(
                jax.random.PRNGKey(0))
        return cache[key]
    return get


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_carry_the_reference_numbers(arch):
    ours, theirs = base.get(arch), rbase.get(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    smoke, rsmoke = _smoke(arch)
    assert dataclasses.asdict(smoke) == dataclasses.asdict(rsmoke)
    assert ours.param_count() == theirs.param_count()


# -------------------------------------------------------------------- layer
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("cf,B,S", [(1.25, 2, 64), (0.5, 2, 96), (8.0, 1, 256)])
def test_route_and_slots_match_reference(arch, cf, B, S):
    """Expert sets, gates, the slots of kept picks and the keep mask
    against the reference's; S = 96 at B = 2 makes 192 tokens, which the
    group of 64 divides after no halving, and cf 0.5 drops picks."""
    cfg, rcfg, rp, p = _layer(arch, capacity_factor=cf)
    x = _x(cfg, B, S, seed=S)
    ridx, rgates, rslot, rkeep, C = _ref_route(rp, rcfg, x)
    T = moe.group_size(B * S, cfg.moe_group)
    xg = torch.from_numpy(x).reshape(B * S // T, T, cfg.d_model)
    _, gates, idx = moe.route(p, cfg, xg)
    assert C == moe._capacity(T, cfg.top_k, cfg.num_experts, cfg.capacity_factor)
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1), np.sort(ridx, -1))
    np.testing.assert_array_equal(idx.numpy(), ridx)   # no ties at all
    _close(gates, rgates, GATE_TOL)
    slot, keep = moe.assign_slots(idx, cfg.num_experts, C)
    np.testing.assert_array_equal(keep.numpy(), rkeep)
    np.testing.assert_array_equal(slot.numpy()[rkeep], rslot[rkeep])
    if cf < 1:
        assert not rkeep.all()


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("cf,B,S", [(1.25, 2, 64), (0.5, 2, 96), (8.0, 1, 256)])
def test_moe_apply_matches_reference(arch, cf, B, S):
    cfg, rcfg, rp, p = _layer(arch, capacity_factor=cf)
    x = _x(cfg, B, S, seed=S)
    want, (raux, rdrop) = rmoe.moe_apply(rp, rcfg, jnp.asarray(x))
    got, (aux, dropped) = moe.moe_apply(p, cfg, torch.from_numpy(x))
    _close(got, want, OUT_TOL)
    assert abs(float(aux) - float(raux)) <= AUX_TOL * abs(float(raux))
    assert float(dropped) == float(rdrop)
    assert (float(dropped) > 0) == (cf < 1)


# the port twins of tests/test_moe.py (its dbrx smoke config)
def _dbrx(**kw):
    return dbrx_132b.smoke_config().replace(**kw)


def _draw(cfg, seed=0):
    return moe.moe_init(torch.Generator().manual_seed(seed), cfg)


def test_single_expert_equals_dense_mlp():
    cfg = _dbrx(num_experts=1, top_k=1, capacity_factor=4.0, moe_group=64)
    p = _draw(cfg)
    x = torch.from_numpy(_x(cfg, 2, 64))
    out, (aux, dropped) = moe.moe_apply(p, cfg, x)
    dense = {"wi": p["wi"][0], "wg": p["wg"][0], "wo": p["wo"][0]}
    _close(out, layers.mlp_apply(dense, x), OUT_TOL)
    assert float(dropped) == 0.0
    assert abs(float(aux) - 1.0) < 1e-5


def test_no_drops_with_ample_capacity_and_gates_normalized():
    cfg = _dbrx(capacity_factor=8.0)
    p = _draw(cfg)
    x = torch.from_numpy(_x(cfg, 2, 128, scale=0.5))
    out, (aux, dropped) = moe.moe_apply(p, cfg, x)
    assert float(dropped) == 0.0
    assert bool(torch.isfinite(out).all())
    assert float(aux) >= 1.0 - 1e-4
    _, gates, _ = moe.route(p, cfg, x.reshape(4, 64, cfg.d_model))
    _close(gates.sum(-1), torch.ones(4, 64), GATE_TOL)


def test_capacity_drops_monotone():
    p = _draw(_dbrx())
    x = torch.from_numpy(_x(_dbrx(), 1, 256))
    drops = [float(moe.moe_apply(p, _dbrx(capacity_factor=cf), x)[1][1])
             for cf in (4.0, 1.0, 0.25)]
    assert drops[0] <= drops[1] <= drops[2]
    assert drops[0] == 0.0


def test_group_size_does_not_change_routing_semantics():
    cfg_a = _dbrx(capacity_factor=8.0, moe_group=64)
    cfg_b = _dbrx(capacity_factor=8.0, moe_group=256)
    p = _draw(cfg_a)
    x = torch.from_numpy(_x(cfg_a, 1, 256))
    _close(moe.moe_apply(p, cfg_a, x)[0], moe.moe_apply(p, cfg_b, x)[0],
           OUT_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_plain_dispatch_matches_moe_apply_and_reference(arch, cf):
    """chip_smoke.moe_apply_plain (per expert: the first C picks gathered
    by index, SwiGLU, index_add by gate) against moe_apply (1e-5 of the
    output's scale, its keep mask and dropped share exactly) and against
    the reference (OUT_TOL)."""
    cfg, rcfg, rp, p = _layer(arch, capacity_factor=cf)
    x = _x(cfg, 2, 96, seed=3)
    got, keep, dropped = moe_apply_plain(p, cfg, torch.from_numpy(x))
    out, (_, drop) = moe.moe_apply(p, cfg, torch.from_numpy(x))
    assert float((got - out).abs().max()) <= 1e-5 * float(out.abs().max())
    np.testing.assert_array_equal(keep.numpy(), _ref_route(rp, rcfg, x)[3])
    assert float(dropped) == float(drop)
    _close(got, rmoe.moe_apply(rp, rcfg, jnp.asarray(x))[0], OUT_TOL)


def test_dispatch_writes_each_kept_pick_once():
    """The buffer holds each kept pick's token in its (expert, slot) row
    and zeros elsewhere; a dropped pick reaches no row."""
    cfg = _dbrx(capacity_factor=0.5)
    p = _draw(cfg)
    xg = torch.from_numpy(_x(cfg, 1, 64)).reshape(1, 64, cfg.d_model)
    _, _, idx = moe.route(p, cfg, xg)
    C = moe._capacity(64, cfg.top_k, cfg.num_experts, 0.5)
    slot, keep = moe.assign_slots(idx, cfg.num_experts, C)
    buf = moe.dispatch(xg, idx, slot, keep, cfg.num_experts, C)
    e, s = idx.reshape(1, -1)[keep], slot[keep]
    tok = torch.nonzero(keep[0])[:, 0] // cfg.top_k
    assert torch.equal(buf[0, e, s], xg[0, tok])
    assert int((buf.abs().sum(-1) > 0).sum()) == int(keep.sum())
    assert not keep.all()


# ------------------------------------------------------------------- models
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_prefill_match_reference(arch, ref_params):
    cfg, rcfg = _smoke(arch)
    rp = ref_params(arch)
    p = from_jax(jax.tree.map(np.asarray, rp))
    toks = zipf_tokens(2, 64, cfg.vocab_size, seed=1)
    hidden, aux = transformer.forward(p, cfg, torch.from_numpy(toks))
    rhidden, raux = rtransformer.forward(rp, rcfg, jnp.asarray(toks))
    _close(hidden, rhidden, LOGIT_TOL)
    assert abs(float(aux) - float(raux)) <= AUX_TOL * abs(float(raux))
    got = train.make_prefill_step(cfg)(p, {"tokens": torch.from_numpy(toks)})
    want = jax.jit(lambda prm, b: rmodel.prefill_fn(prm, rcfg, b))(
        rp, {"tokens": jnp.asarray(toks)})
    assert got.shape == want.shape
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_sequence_matches_reference(arch, ref_params):
    """12 decode steps over fixed tokens (each step's B = 2 tokens one MoE
    group, C = 1 at top-2 of 4 experts: picks drop as in the reference)."""
    cfg, rcfg = _smoke(arch)
    rp = ref_params(arch)
    p = from_jax(jax.tree.map(np.asarray, rp))
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
    _close(cache.layer_cache.k, rcache.layer_cache.k, LOGIT_TOL)
    assert int(cache.pos) == int(rcache.pos) == T


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_port_decode_matches_port_prefill(arch):
    """tests/test_decode_consistency.py's check on the port alone, with a
    capacity that drops nothing (cf = E / k)."""
    cfg = _smoke(arch)[0]
    cfg = cfg.replace(capacity_factor=cfg.num_experts / cfg.top_k)
    params = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    T = 16
    toks = torch.from_numpy(zipf_tokens(2, T, cfg.vocab_size, seed=1))
    hidden, _ = transformer.forward(params, cfg, toks)
    want = transformer.logits_fn(params, cfg, hidden)
    cache = model.init_cache(cfg, 2, T, device="cpu")
    outs = []
    for t in range(T):
        lg, cache = model.decode_fn(params, cfg, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    assert float((torch.stack(outs, dim=1) - want).abs().max()) < LOGIT_TOL


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_gradients_match_reference(arch, ref_params):
    """jax.value_and_grad(repro.models.model.loss_fn) against the port's
    loss (with router_aux_coef times the aux loss) and autograd."""
    cfg, rcfg = _smoke(arch)
    rp = ref_params(arch)
    toks = zipf_tokens(2, 64, cfg.vocab_size, seed=3)
    (want, rmet), rgrad = jax.jit(jax.value_and_grad(
        lambda prm, b: rmodel.loss_fn(prm, rcfg, b), has_aux=True))(
            rp, {"tokens": jnp.asarray(toks)})
    params = from_jax(jax.tree.map(np.asarray, rp))
    live = [t.requires_grad_() for t in tree_leaves(params)]
    loss, met = model.loss_fn(pytree.tree_unflatten(params, live), cfg,
                              {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, live)
    loss, aux = float(loss.detach()), float(met["aux"].detach())
    assert abs(loss - float(want)) <= LOSS_TOL * abs(float(want))
    assert abs(aux - float(rmet["aux"])) <= AUX_TOL * abs(float(rmet["aux"]))
    assert aux > 0
    gtree = pytree.tree_unflatten(params, list(grads))
    _trees_close(gtree, rgrad, GRAD_TOL)
    # the router learns through the gates and the aux loss
    assert float(gtree["layers"]["ffn"]["router"].abs().max()) > 0


def _accurate_reference_norms(monkeypatch):
    """The reference's tree_dot contracts each leaf in one dot_general,
    which XLA:CPU sums in f32 up to 6.6e-4 off the f64 sum on the Jamba
    smoke config's expert leaves (a jnp.sum of the products reads 1e-6),
    and its trust-region clip scales the first step by that error (a step
    of norm 1.00013 where the clip sets 1).  The train-step tests take the
    reference's step norms with the sum: the same function, summed as
    XLA:CPU sums a reduction."""
    def dot(a, b):
        return sum(jnp.sum(x.astype(jnp.float32) * y.astype(jnp.float32))
                   for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b),
                                   strict=True))
    monkeypatch.setattr(rfl, "tree_dot", dot)
    monkeypatch.setattr(rfl, "tree_norm", lambda a: jnp.sqrt(dot(a, a)))


@pytest.mark.parametrize("arch", sorted(TRAIN_ARCHS))
def test_fim_lbfgs_train_step_matches_reference(monkeypatch, ref_params,
                                                arch):
    """One fim_lbfgs step of launch/train.make_train_step on the dbrx and
    Jamba smoke configs (2 microbatch cohorts) against the reference's,
    jitted, its step norms summed accurately
    (``_accurate_reference_norms``): the loss and every leaf of params and
    state.  The history and the accumulators in f32: the configs' bf16
    (dbrx's grad_accum_dtype too) rounds the two sides' f32 drift into
    one-ulp differences, 2^-8 of a leaf."""
    cfg, rcfg = _smoke(arch, lbfgs_dtype="float32",
                       grad_accum_dtype="float32")
    rocfg, pocfg = rtrain.opt_config(rcfg), train.opt_config(cfg)
    rparams = ref_params(arch)              # init_train_state's draws
    ropt = rfl.init(rparams, rocfg)
    _accurate_reference_norms(monkeypatch)
    params = from_jax(jax.tree.map(np.asarray, rparams))
    opt = fim_lbfgs.init(params, pocfg)
    toks = zipf_tokens(4, 32, cfg.vocab_size, seed=7)
    rparams, ropt, rst = jax.jit(rtrain.make_train_step(rcfg, rocfg, n_micro=2))(
        rparams, ropt, {"tokens": jnp.asarray(toks)})
    params, opt, st = train.make_train_step(cfg, pocfg, n_micro=2)(
        params, opt, {"tokens": torch.from_numpy(toks)})
    assert abs(float(st["loss"]) - float(rst["loss"])) <= LOSS_TOL * abs(
        float(rst["loss"]))
    _trees_close(params, rparams, GRAD_TOL)
    _trees_close(opt, ropt, GRAD_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_structure_matches_reference(arch, ref_params):
    cfg, _ = _smoke(arch)
    shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                          ref_params(arch))
    ours = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        model.init(cfg, device="cpu"))
    assert ours == shapes
    assert base.get(arch).activation_dtype == torch.bfloat16
