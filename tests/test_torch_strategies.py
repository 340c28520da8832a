"""The six strategies beside ``fim_lbfgs`` — ``fedavg_sgd``,
``fedavg_adam``, ``fedprox``, ``feddane``, ``fedova`` and
``fedova_lbfgs`` — against the reference on the CPU, plus the strategy
registry's plans and refusals and its default device.

Each parity run starts the port from the reference's own initial state
(``load_state_dict(from_jax(...))``): the same cohorts and minibatches
(the host numpy streams are reproduced call for call), an equal ledger,
per-round losses within 1e-5 relative and every leaf of the server state
within 1e-4 of its norm.  f32 convolutions and sums run in other orders
in XLA and PyTorch, and the local steps compound that: Adam divides by
the root of tiny second moments and fedova_lbfgs takes up to a dozen
quasi-Newton steps per component in two rounds, so a few entries near
zero drift past an elementwise 1e-4/1e-5 bound (1 of 25,088 and 31 of
253,440 entries in one run) while each leaf stays within 1e-4 of its
norm.
"""
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as RFedConfig  # noqa: E402
from repro.configs.paper_models import FMNIST_CNN as R_FMNIST  # noqa: E402
from repro.configs.paper_models import reduced as r_reduced  # noqa: E402
from repro.core import fim_lbfgs as rfim_lbfgs  # noqa: E402
from repro.data.synthetic import make_classification as r_make  # noqa: E402
from repro.fed import client as rclient  # noqa: E402
from repro.fed.server import FederatedRun as RFederatedRun  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.paper_models import FMNIST_CNN, reduced  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.data.synthetic import make_classification  # noqa: E402
from repro_torch.fed import client as pclient  # noqa: E402
from repro_torch.fed import comm, strategies  # noqa: E402
from repro_torch.fed.server import FederatedRun  # noqa: E402
from repro_torch.utils.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

ALL_ALGS = ["fim_lbfgs", "fedavg_sgd", "fedavg_adam", "fedprox", "feddane",
            "fedova", "fedova_lbfgs"]
NEW_ALGS = ALL_ALGS[1:]
SUMMABLE = {"fim_lbfgs", "fedavg_sgd", "fedavg_adam", "fedprox"}
CODECS = ["none", "int8", "topk:0.1", "randk:0.1"]
RUN = dict(num_clients=6, participation=0.5, noniid_l=2, local_epochs=2,
           batch_size=16, seed=0)


def _ref_state(strategy) -> dict:
    """The reference's server state as numpy; FedOVA keeps it as
    ``model.components`` (+ ``opt_state``)."""
    if hasattr(strategy, "model"):
        sd = {"params": strategy.model.components}
        if hasattr(strategy, "opt_state"):
            sd["opt_state"] = strategy.opt_state
    else:
        sd = strategy.state_dict()
    return jax.tree.map(np.asarray, sd)


def _runs(alg, compress="none", n_train=200, **kw):
    cfg = dict(RUN, **kw)
    rtrain, rtest = r_make(r_reduced(R_FMNIST), n_train=n_train, n_test=60,
                           seed=0)
    ref = RFederatedRun(r_reduced(R_FMNIST), RFedConfig(compress=compress, **cfg),
                        rtrain, rtest, alg)
    train, test = make_classification(reduced(FMNIST_CNN), n_train=n_train,
                                      n_test=60, seed=0)
    port = FederatedRun(reduced(FMNIST_CNN), FedConfig(compress=compress, **cfg),
                        train, test, alg, device="cpu")
    port.strategy.load_state_dict(from_jax(_ref_state(ref.strategy)))
    return ref, port


def _assert_leaves_close(p_leaves, r_leaves):
    assert len(p_leaves) == len(r_leaves)
    for p, r in zip(p_leaves, r_leaves, strict=True):
        assert p.shape == r.shape and p.dtype == r.dtype
        diff = np.linalg.norm((p - r).astype(np.float64).ravel())
        assert diff <= 1e-4 * np.linalg.norm(r.astype(np.float64).ravel())


def _record(monkeypatch, module, sink, to_np):
    stack = module.stack_batches

    def recording(*args, **kwargs):
        out = stack(*args, **kwargs)
        sink.append({k: to_np(v) for k, v in out.items()})
        return out

    monkeypatch.setattr(module, "stack_batches", recording)


def _cohorts(run, sink):
    sample = run.sample_clients

    def wrapped():
        out = sample()
        sink.append([int(i) for i in out])
        return out

    run.sample_clients = wrapped


@pytest.mark.parametrize("alg", NEW_ALGS)
def test_strategy_matches_reference(alg, monkeypatch):
    """Two rounds of ``alg`` at reduced(FMNIST_CNN) from the reference's
    state: cohorts, minibatches, ledger, losses, params and opt_state."""
    ref, port = _runs(alg)
    # the reference's FIM-L-BFGS component step jitted (the same function
    # compiled once instead of op by op)
    monkeypatch.setattr(rfim_lbfgs, "update",
                        jax.jit(rfim_lbfgs.update, static_argnums=(4,)))
    r_batches, p_batches, r_picks, p_picks = [], [], [], []
    _record(monkeypatch, rclient, r_batches, np.asarray)
    _record(monkeypatch, pclient, p_batches, lambda t: t.numpy())
    _cohorts(ref, r_picks)
    _cohorts(port, p_picks)
    r_hist = ref.run(rounds=2, eval_every=2)
    p_hist = port.run(rounds=2, eval_every=2)
    assert p_picks == r_picks and len(p_picks) == 2
    assert len(p_batches) == len(r_batches) > 0
    for p, r in zip(p_batches, r_batches, strict=True):
        np.testing.assert_array_equal(p["x"], r["x"])
        np.testing.assert_array_equal(p["y"], r["y"])
    assert port.ledger.summary() == ref.ledger.summary()
    for r, p in zip(r_hist, p_hist, strict=True):
        assert p["cohort"] == r["cohort"]
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-5)
    _assert_leaves_close(tree_leaves(to_numpy(port.strategy.state_dict())),
                         jax.tree.leaves(_ref_state(ref.strategy)))


def test_fedavg_sgd_topk_slice_matches_reference():
    """FedAvg under compress="topk:0.1": the delta payloads go through the
    top-k select with per-client error feedback."""
    ref, port = _runs("fedavg_sgd", compress="topk:0.1", local_epochs=1)
    r_hist = ref.run(rounds=2, eval_every=2)
    p_hist = port.run(rounds=2, eval_every=2)
    assert port.ledger.summary() == ref.ledger.summary()
    for r, p in zip(r_hist, p_hist, strict=True):
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-5)
    r_res = {int(c): v for c, v in ref._ef_residual.items()}
    assert sorted(port._ef_residual) == sorted(r_res)
    for cid, res in port._ef_residual.items():
        got = np.concatenate([x.ravel() for x in tree_leaves(to_numpy(res))])
        want = np.concatenate([np.asarray(x).ravel()
                               for x in jax.tree.leaves(r_res[cid])])
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    _assert_leaves_close(tree_leaves(to_numpy(port.strategy.params)),
                         jax.tree.leaves(_ref_state(ref.strategy)))


# --------------------------------------------------------- plan == ledger
def _expected_ledger(plan, k, rounds):
    down = up_star = up_tree = scalars = 0.0
    depth = max(1, math.ceil(math.log2(max(k, 2))))
    for _ in range(rounds):
        for ph in plan.phases:
            wire = ph.codec.wire_bytes(ph.up_floats)
            down += ph.down_floats * comm.BYTES_F32 * k
            up_star += wire * k
            up_tree += wire * (depth if ph.aggregatable else k)
        scalars += (plan.round_scalars + plan.scalars_per_client * k) * 4
    return {"down_bytes": down, "up_star_bytes": up_star,
            "up_tree_bytes": up_tree, "scalar_bytes": scalars}


@pytest.mark.parametrize("alg", ALL_ALGS)
@pytest.mark.parametrize("compress", CODECS)
def test_plan_equals_ledger(alg, compress):
    """Every strategy under every codec: the port's plan equals the
    reference's, the ledger after a round equals the plan and the
    reference's ledger; sparsifiers on plans that are not summable raise
    in both packages."""
    cfg = dict(RUN, local_epochs=1)
    train, test = make_classification(reduced(FMNIST_CNN), n_train=120,
                                      n_test=20, seed=0)
    rtrain, rtest = r_make(r_reduced(R_FMNIST), n_train=120, n_test=20, seed=0)
    if compress.startswith(("topk", "randk")) and alg not in SUMMABLE:
        with pytest.raises(ValueError, match="sparsif"):
            RFederatedRun(r_reduced(R_FMNIST), RFedConfig(compress=compress, **cfg),
                          rtrain, rtest, alg)
        with pytest.raises(ValueError, match="sparsif"):
            FederatedRun(reduced(FMNIST_CNN), FedConfig(compress=compress, **cfg),
                         train, test, alg, device="cpu")
        return
    ref = RFederatedRun(r_reduced(R_FMNIST), RFedConfig(compress=compress, **cfg),
                        rtrain, rtest, alg)
    run = FederatedRun(reduced(FMNIST_CNN), FedConfig(compress=compress, **cfg),
                       train, test, alg, device="cpu")
    plan, rplan = run.plan, ref.plan
    assert plan.summable == rplan.summable == (alg in SUMMABLE)
    assert plan.upload_bytes() == rplan.upload_bytes()
    assert plan.downlink_bytes() == rplan.downlink_bytes()
    assert (plan.round_scalars, plan.scalars_per_client) == (
        rplan.round_scalars, rplan.scalars_per_client)
    assert [(p.name, p.aggregatable) for p in plan.phases] == [
        (p.name, p.aggregatable) for p in rplan.phases]
    assert plan.flops(100) == rplan.flops(100)
    run.run(rounds=1, eval_every=1)
    # the reference's ledger is fixed by its cohort and plan alone
    ref._meter_round(ref.sample_clients())
    k = 3
    expect = _expected_ledger(plan, k, 1)
    for field, value in expect.items():
        assert getattr(run.ledger, field) == pytest.approx(value), field
    assert run.ledger.summary() == ref.ledger.summary()


# -------------------------------------------------- registry and device
def test_registry_names_and_protocol():
    assert strategies.names() == sorted(ALL_ALGS)
    fcfg = FedConfig(**RUN)
    for alg in ALL_ALGS:
        s = strategies.get(alg)(reduced(FMNIST_CNN), fcfg, 10, device="cpu")
        assert isinstance(s, strategies.FedStrategy) and s.name == alg
        assert s.device == torch.device("cpu")
        assert all(t.device.type == "cpu" for t in tree_leaves(s.state_dict()))


def test_strategy_from_registry_raises_without_cuda(monkeypatch):
    """A strategy built straight from the registry runs on the card unless
    asked otherwise, and raises where there is none, as FederatedRun
    does (simulated on a host that has a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for alg in ALL_ALGS:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            strategies.get(alg)(reduced(FMNIST_CNN), FedConfig(**RUN), 10)


def test_fedconfig_restores_the_local_solver_settings():
    cfg, rcfg = FedConfig(), RFedConfig()
    for field in ("local_epochs", "batch_size", "learning_rate", "prox_mu"):
        assert getattr(cfg, field) == getattr(rcfg, field)
    with pytest.raises(ValueError, match="prox_mu"):
        FedConfig(prox_mu=-0.1)


# ------------------------------------------------- building blocks
def test_stack_batches_draws_the_reference_stream():
    """One permutation per epoch, ragged tail dropped, indexed on the
    tensors' own device."""
    x = np.random.default_rng(0).normal(size=(37, 4, 4, 1)).astype(np.float32)
    y = np.arange(37) % 3
    for bs, epochs in ((15, 3), (64, 2), (1, 1)):
        want = rclient.stack_batches(x, y, bs, epochs, np.random.default_rng(9))
        got = pclient.stack_batches(torch.from_numpy(x), torch.from_numpy(y),
                                    bs, epochs, np.random.default_rng(9))
        np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
        np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))


def test_adam_update_matches_reference():
    from repro.core import baselines as rbaselines
    rng = np.random.default_rng(4)
    p = {"w": rng.normal(size=(5, 3)).astype(np.float32)}
    r_state, p_state = rbaselines.adam_init(p), baselines.adam_init(from_jax(p))
    rp, pp = p, from_jax(p)
    for _ in range(4):
        g = {"w": rng.normal(size=(5, 3)).astype(np.float32)}
        rp, r_state, _ = rbaselines.adam_update(r_state, rp, g, 5e-3)
        pp, p_state, _ = baselines.adam_update(p_state, pp, from_jax(g), 5e-3)
    np.testing.assert_allclose(pp["w"].numpy(), np.asarray(rp["w"]),
                               rtol=1e-6, atol=1e-7)
    assert int(p_state.step) == int(r_state.step) == 4
    rp, _, _ = rbaselines.sgd_update(rbaselines.sgd_init(p), p, g, 0.1, 0.9)
    pp, _, _ = baselines.sgd_update(baselines.sgd_init(from_jax(p)),
                                    from_jax(p), from_jax(g), 0.1, 0.9)
    np.testing.assert_allclose(pp["w"].numpy(), np.asarray(rp["w"]),
                               rtol=1e-6, atol=1e-7)
