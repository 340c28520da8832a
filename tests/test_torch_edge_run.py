"""The edge slice end to end: the port's ``FederatedRun(..., edge=...)``
against the reference's on the CPU.

The edge layer is numpy (channel, fleet, policy and scenario streams),
so everything it decides must come out bit-identical: the ledger, the
cohorts, exclusions, deadline drops, bandwidths, the simulated clock and
energy (the fingerprint of ``tests/test_determinism.py``), and every
per-round ``info`` record's edge fields.  The model side starts from the
reference's own initial state (``from_jax``) and is held as the
whole-slice tests hold it: losses within 1e-5 relative, the state within
1e-4 relative / 1e-5 absolute (``fim_lbfgs``) or each leaf within 1e-4 of
its norm (the first-order strategies).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro.configs.base import FedConfig as RFedConfig  # noqa: E402
from repro.configs.paper_models import FMNIST_CNN as R_FMNIST  # noqa: E402
from repro.configs.paper_models import reduced as r_reduced  # noqa: E402
from repro.data.synthetic import make_classification as r_make  # noqa: E402
from repro.edge import ChannelConfig as RChannelConfig  # noqa: E402
from repro.edge import DeviceConfig as RDeviceConfig  # noqa: E402
from repro.edge import EdgeConfig as REdgeConfig  # noqa: E402
from repro.fed.server import FederatedRun as RFederatedRun  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.paper_models import FMNIST_CNN, reduced  # noqa: E402
from repro_torch.data.synthetic import make_classification  # noqa: E402
from repro_torch.edge import ChannelConfig, DeviceConfig, EdgeConfig  # noqa: E402
from repro_torch.fed.server import FederatedRun  # noqa: E402
from repro_torch.utils.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

# tests/test_determinism.py's edge: 8 clients, all sampled, non-IID-2,
# Rayleigh uplinks of 2e5 Hz and a lognormal compute spread
CHANNEL = dict(bandwidth_hz=2e5, snr_db_mean=10.0, snr_db_std=3.0,
               fading="rayleigh", server_rate_bps=50e6)
DEVICE = dict(flops_per_s_mean=2e9, flops_per_s_sigma=1.0)
# the stable fim_lbfgs settings (a clipped, damped step): at the default
# step clip the 300-example loss climbs in round 2 and the quasi-Newton
# steps amplify f32 summation-order drift past 1e-4 by round 3
RUN = dict(num_clients=8, participation=1.0, local_epochs=1, batch_size=32,
           noniid_l=2, seed=0, max_step_norm=0.5, fim_damping=0.05,
           fim_ema=0.9)
DATA = dict(n_train=300, n_test=100, seed=0, noise=0.5)
LEDGER_FIELDS = ("down_bytes", "up_star_bytes", "up_tree_bytes",
                 "scalar_bytes", "rounds")
INFO_EXACT = ("cohort", "dropped", "aggregated", "wall_s", "sim_time_s",
              "energy_j", "barrier_s", "round")


def make_runs(alg, rounds, compress="none", fleet=("off",), tracers=None,
              **edge_kw):
    """The reference's run and one port run per ``fleet`` mode, every
    port run from the reference's initial state.  ``tracers`` is None or
    a (reference tracer, [port tracer per fleet mode]) pair."""
    edge_kw = dict(dict(deadline_s=5.0, min_clients=1), **edge_kw)
    cfg = dict(RUN, rounds=rounds, compress=compress)
    r_tracer, p_tracers = tracers or (None, [None] * len(fleet))
    ref = RFederatedRun(
        r_reduced(R_FMNIST),
        RFedConfig(edge=REdgeConfig(channel=RChannelConfig(**CHANNEL),
                                    device=RDeviceConfig(**DEVICE),
                                    **edge_kw), **cfg),
        *r_make(r_reduced(R_FMNIST), **DATA), alg, tracer=r_tracer)
    state = from_jax(jax.tree.map(np.asarray, ref.strategy.state_dict()))
    ports = []
    for mode, tracer in zip(fleet, p_tracers, strict=True):
        port = FederatedRun(
            reduced(FMNIST_CNN),
            FedConfig(edge=EdgeConfig(channel=ChannelConfig(**CHANNEL),
                                      device=DeviceConfig(**DEVICE),
                                      fleet=mode, **edge_kw), **cfg),
            *make_classification(reduced(FMNIST_CNN), **DATA), alg,
            tracer=tracer, device="cpu")
        port.strategy.load_state_dict(state)
        ports.append(port)
    if alg == "fim_lbfgs":
        # the reference's aggregate and server step jitted (its own pure
        # update), as tests/test_torch_fed.py does: the same functions,
        # compiled once instead of op by op
        update = jax.jit(ref.strategy.cohort_server_update)

        def server_step(aggregate):
            s = ref.strategy
            s.params, s.opt_state, _ = update(s.opt_state, s.params,
                                              *aggregate)

        ref.strategy.aggregate = jax.jit(ref.strategy.aggregate)
        ref.strategy.server_step = server_step
    return ref, ports


def fingerprint(run, expiry=False):
    """tests/test_determinism.py's fingerprint; ``expiry`` adds the async
    path's pending expiries, held spectrum and buffer sizes."""
    fp = {
        "ledger": {f: getattr(run.ledger, f) for f in LEDGER_FIELDS},
        "drops": [tuple(sorted(d.dropped)) for d in run.edge.decisions],
        "excluded": [tuple(sorted(d.excluded)) for d in run.edge.decisions],
        "cohorts": [tuple(sorted(d.selected)) for d in run.edge.decisions],
        "clock_s": run.edge.clock.now,
        "energy_j": run.edge.energy_j,
        "bandwidths": [tuple(np.asarray(d.bandwidth()).tolist())
                       for d in run.edge.decisions],
    }
    if expiry:
        fp["expiry"] = sorted(run.edge._expiry.items())
        fp["held"] = sorted(run.edge._held_hz.items())
        fp["aggregated"] = [h.get("cohort") for h in run.edge.history]
    return fp


def assert_history_matches(r_hist, p_hist):
    """Every edge field of every round equal; losses within 1e-5
    relative; accuracy within one of the 100 test examples."""
    assert len(p_hist) == len(r_hist)
    for r, p in zip(r_hist, p_hist, strict=True):
        assert set(p) == set(r)
        for key in INFO_EXACT:
            assert p.get(key) == r.get(key), (key, r, p)
        if "loss" in r:
            np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-5)
        if "accuracy" in r:
            assert abs(p["accuracy"] - r["accuracy"]) <= 0.011


def assert_state_close(ref, port, per_leaf_norm=False):
    r_leaves = jax.tree.leaves(jax.tree.map(np.asarray,
                                            ref.strategy.state_dict()))
    p_leaves = tree_leaves(to_numpy(port.strategy.state_dict()))
    assert len(p_leaves) == len(r_leaves)
    for p, r in zip(p_leaves, r_leaves, strict=True):
        assert p.shape == r.shape and p.dtype == r.dtype
        if per_leaf_norm:
            diff = np.linalg.norm((p - r).astype(np.float64).ravel())
            assert diff <= 1e-4 * max(
                np.linalg.norm(r.astype(np.float64).ravel()), 1e-30)
        else:
            np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-5)


def assert_run_matches(ref, port, r_hist, p_hist, per_leaf_norm=False):
    """The whole comparison of one edge run: fingerprint (with the async
    path's expiry state where it has one), ledger, records, edge summary
    and state; and the run saw both deadline drops and landers."""
    expiry = port.edge.async_agg is not None
    assert fingerprint(port, expiry) == fingerprint(ref, expiry)
    assert port.ledger.summary() == ref.ledger.summary()
    assert port.edge.summary() == ref.edge.summary()
    assert_history_matches(r_hist, p_hist)
    assert_state_close(ref, port, per_leaf_norm)
    assert any(d.dropped for d in port.edge.decisions)
    assert any(h["cohort"] for h in p_hist), p_hist


# fim_lbfgs under each policy with an enforced deadline; the knobs give
# every case drops and landers over its 3 rounds (deadline also excludes
# a priori).  adaptive_codec runs traced, in tests/test_torch_obs.py.
POLICIES = {
    "uniform": dict(enforce_deadline_s=3.0),
    "deadline": dict(enforce_deadline_s=2.0),
    "energy_opt": dict(enforce_deadline_s=3.0),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_fim_lbfgs_under_policy_matches_reference(policy):
    ref, (port,) = make_runs("fim_lbfgs", 3, scheduler=policy,
                             **POLICIES[policy])
    r_hist = ref.run(rounds=3, eval_every=3)
    p_hist = port.run(rounds=3, eval_every=3)
    assert_run_matches(ref, port, r_hist, p_hist)
    if policy == "deadline":
        assert any(d.excluded for d in port.edge.decisions)


def test_async_expiry_path_matches_reference():
    """Buffered async under an enforced deadline: expiry events, held
    spectrum and staleness-weighted buffers replay the reference's, and
    the stale payloads aggregate to the reference's state."""
    ref, (port,) = make_runs("fim_lbfgs", 4, scheduler="uniform",
                             enforce_deadline_s=3.0, mode="async",
                             buffer_size=3)
    staleness = record_staleness(port)
    r_hist = ref.run(rounds=4, eval_every=4)
    p_hist = port.run(rounds=4, eval_every=4)
    assert_run_matches(ref, port, r_hist, p_hist)
    assert max(staleness) > 0, staleness


def record_staleness(run) -> list:
    """Wrap the run's async buffer so each popped entry's staleness
    (server versions behind) is appended to the returned list."""
    agg, seen = run.edge.async_agg, []
    pop = agg.pop_buffer

    def recording(size=None):
        version = agg.version
        entries, w = pop(size)
        seen.extend(version - e.version for e in entries)
        return entries, w

    agg.pop_buffer = recording
    return seen


def test_fedavg_under_churn_with_reallocation_matches_reference():
    """fedavg_sgd (non-aggregatable deltas) under a churn scenario with
    realized-side faults and mid-round re-allocation."""
    scenario = ("markov:p_drop=0.2,p_join=0.4|snr_burst:prob=0.4,scale=0.1|"
                "data_exclusion:0.7")
    # a tight deadline admits few clients, min_clients force-keeps the
    # rest with no deadline, and SNR bursts cut admitted clients while
    # the force-kept stragglers are still on the air: widths re-land
    ref, (port,) = make_runs("fedavg_sgd", 3, scheduler="deadline",
                             deadline_s=1.0, min_clients=6,
                             scenario=scenario, reallocate=True)
    r_hist = ref.run(rounds=3, eval_every=3)
    p_hist = port.run(rounds=3, eval_every=3)
    assert_run_matches(ref, port, r_hist, p_hist, per_leaf_norm=True)
    assert port.edge.unavailable_total > 0
    assert port.edge.realloc_rounds > 0


def test_refusals_match_reference():
    """async and adaptive_codec need summable payloads: fedova's are not,
    and both drivers refuse with the same message."""
    for edge_kw in (dict(mode="async"), dict(scheduler="adaptive_codec")):
        messages = []
        for edge_cls, fed_cls, run_cls, mk, mcfg, kw in (
                (REdgeConfig, RFedConfig, RFederatedRun, r_make,
                 r_reduced(R_FMNIST), {}),
                (EdgeConfig, FedConfig, FederatedRun, make_classification,
                 reduced(FMNIST_CNN), {"device": "cpu"})):
            train, test = mk(mcfg, n_train=50, n_test=10, seed=0)
            with pytest.raises(ValueError) as err:
                run_cls(mcfg, fed_cls(edge=edge_cls(**edge_kw), **RUN),
                        train, test, "fedova", **kw)
            messages.append(str(err.value))
        assert messages[0] == messages[1]
        assert "summable" in messages[1]
