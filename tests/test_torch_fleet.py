"""The fleet engine in the port (``repro_torch.edge.fleet``) on the CPU.

``FleetState`` and the ``exact`` backend are the reference's numpy code:
their populations, cohorts, clocks, energies and batteries must equal
the reference's engine and the port's own dict runtime bit for bit.  The
``jit`` backend is the port's fused float64 torch backend (here on the
CPU; ``tests/test_torch_cuda.py`` runs it on the card) and is held to
the contract of ``tests/test_fleet.py``: the same cohorts and drop
counts as ``exact``, clock, energy and batteries within rtol 1e-9
(float-op reassociation only).  The reference's own ``jit`` backend
cannot run here (jax 0.9.0 lacks ``enable_x64``), so ``exact`` is the
reference for it, as in ``tests/test_scenario.py``'s churn cases.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.edge import ChannelConfig as RChannelConfig  # noqa: E402
from repro.edge import DeviceConfig as RDeviceConfig  # noqa: E402
from repro.edge import EdgeConfig as REdgeConfig  # noqa: E402
from repro.edge import FleetEngine as RFleetEngine  # noqa: E402
from repro.edge.fleet import FleetState as RFleetState  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.paper_models import FMNIST_CNN, reduced  # noqa: E402
from repro_torch.data.synthetic import make_classification  # noqa: E402
from repro_torch.edge import (ChannelConfig, DeviceConfig, EdgeConfig,  # noqa: E402
                              EdgeRuntime, FleetEngine, FleetState)
from repro_torch.edge import allocation  # noqa: E402
from repro_torch.edge.fleet import kernel  # noqa: E402
from repro_torch.fed.server import FederatedRun  # noqa: E402

UPLINK = dict(bandwidth_hz=2e5, snr_db_mean=10.0, snr_db_std=3.0,
              fading="rayleigh", server_rate_bps=50e6)
HETERO = dict(flops_per_s_mean=2e9, flops_per_s_sigma=1.0)
UP, DOWN, FLOPS = 80_000.0, 40_000.0, 1e9
POLICIES = ["uniform", "bandwidth_opt", "energy_opt"]
RTOL = 1e-9
# tests/test_scenario.py's straggler case and churn specs
STRAGGLER = dict(scheduler="deadline", deadline_s=0.2, min_clients=6,
                 scenario="snr_burst:prob=0.6,scale=0.05")
STRAGGLER_FLEET = dict(population=16, up_bytes=4000.0, flops=2e8, seed=0)
CHURN_SPECS = [
    "markov:p_drop=0.2,p_join=0.4",
    "diurnal:period=6,amp=0.5,base=0.6,unit=round",
    ("markov:p_drop=0.2,p_join=0.4|snr_burst:prob=0.6,scale=0.05|"
     "data_exclusion:0.7"),
]


def _cfg(policy="uniform", ref=False, **kw):
    kw.setdefault("deadline_s", 5.0)
    kw.setdefault("min_clients", 1)
    kw.setdefault("enforce_deadline_s", 1.5)
    if ref:
        return REdgeConfig(channel=RChannelConfig(**UPLINK),
                           device=RDeviceConfig(**HETERO), scheduler=policy,
                           **kw)
    return EdgeConfig(channel=ChannelConfig(**UPLINK),
                      device=DeviceConfig(**HETERO), scheduler=policy, **kw)


def _engine(policy="uniform", pop=300, backend="exact", seed=0, **kw):
    return FleetEngine(_cfg(policy, **kw), pop, up_bytes=UP, flops=FLOPS,
                       down_bytes=DOWN, seed=seed, backend=backend,
                       device="cpu")


def _close(a, b):
    return np.allclose(a, b, rtol=RTOL, atol=0.0, equal_nan=True)


# ------------------------------------------------------------- state layer
def test_fleet_state_draws_equal_the_reference():
    ch, dv = ChannelConfig(**UPLINK), DeviceConfig(**HETERO)
    st = FleetState.draw(ch, dv, 64, seed=3)
    ref = RFleetState.draw(RChannelConfig(**UPLINK), RDeviceConfig(**HETERO),
                           64, seed=3)
    assert st.population == ref.population == 64
    for _ in range(3):
        st.sample()
        ref.sample()
        assert np.array_equal(st.snr_round, ref.snr_round)
    assert np.array_equal(st.flops_per_s, ref.flops_per_s)
    assert np.array_equal(st.battery_j, ref.battery_j)
    assert st.alive_mask().all()
    st.fleet.battery_j[3] = 0.0
    st.busy[5] = True
    mask = st.alive_mask()
    assert not mask[3] and not mask[5] and mask.sum() == 62


# ------------------------------------------------------------ exact backend
@pytest.mark.parametrize("policy", POLICIES)
def test_exact_engine_equals_dict_runtime_and_reference(policy):
    """backend='exact' forces the fleet fast path inside its runtime: the
    SAME floats as a fleet='off' runtime of the port and as the
    reference's engine."""
    eng = _engine(policy, pop=200)
    ref = RFleetEngine(_cfg(policy, ref=True), 200, up_bytes=UP,
                       flops=FLOPS, down_bytes=DOWN, seed=0, backend="exact")
    for _ in range(3):
        assert eng.run_round(60) == ref.run_round(60)
        assert np.array_equal(eng.last_decision.selected,
                              ref.last_decision.selected)
    rt = EdgeRuntime(dataclasses.replace(_cfg(policy), fleet="off"), 200,
                     seed=0)
    for _ in range(3):
        _, est, _ = rt.decide(60, np.arange(200), lambda c=None: (UP, 0.0),
                              FLOPS, summable=True)
        rt.finish_round_sync(est, UP, DOWN, aggregatable=True)
    assert eng.clock_s == rt.clock.now == ref.clock_s
    assert eng.energy_j == rt.energy_j == ref.energy_j
    assert eng.deadline_dropped_total == rt.deadline_dropped_total
    assert np.array_equal(eng.state.battery_j, rt.fleet.battery_j)
    assert np.array_equal(eng.state.battery_j, ref.state.battery_j)
    assert eng.summary() == ref.summary()


# -------------------------------------------------------------- jit backend
@pytest.mark.parametrize("policy", POLICIES)
def test_jit_backend_matches_exact(policy):
    """Same seed, same rounds: the same cohorts and drop counts, clock,
    energy and batteries within rtol 1e-9; the drains are finite so the
    batteries are compared (the default fleet's are infinite)."""
    ex = FleetEngine(_cfg(policy, enforce_deadline_s=3.0), 300, up_bytes=UP,
                     flops=FLOPS, down_bytes=DOWN, backend="exact",
                     device="cpu")
    jt = FleetEngine(_cfg(policy, enforce_deadline_s=3.0), 300, up_bytes=UP,
                     flops=FLOPS, down_bytes=DOWN, backend="jit",
                     device="cpu")
    for eng in (ex, jt):
        eng.state.fleet.battery_j[:] = 50.0
    dropped = []
    for _ in range(5):
        ra, rb = ex.run_round(80), jt.run_round(80)
        assert np.array_equal(ex.last_decision.selected,
                              jt.last_decision.selected)
        assert ra["dropped"] == rb["dropped"]
        assert ra["cohort"] == rb["cohort"]
        assert _close(ra["wall_s"], rb["wall_s"])
        assert _close(ra.get("barrier_s"), rb.get("barrier_s"))
        dropped.append(ra["dropped"])
    assert _close(ex.clock_s, jt.clock_s)
    assert _close(ex.energy_j, jt.energy_j)
    assert _close(ex.state.battery_j, jt.state.battery_j)
    assert (ex.state.battery_j < 50.0).any()
    assert ex.summary()["drop_reasons"] == jt.summary()["drop_reasons"]
    assert any(dropped)


@pytest.mark.parametrize("policy", ["bandwidth_opt", "energy_opt"])
def test_width_solvers_match_numpy(policy):
    """The device bisections against the numpy cores on one cohort:
    widths within rtol 1e-9, summing to the budget."""
    rng = np.random.default_rng(0)
    n, budget = 257, 3.1e6
    bits = 8.0 * rng.uniform(2e4, 2e5, n)
    s = rng.uniform(0.5, 6.0, n)
    tc = rng.uniform(0.05, 2.0, n)
    if policy == "bandwidth_opt":
        want = allocation.bandwidth_opt_widths(bits, s, tc, budget)
        got = kernel.bandwidth_opt_widths_jit(bits, s, tc, budget,
                                              device="cpu")
    else:
        c, w_min = allocation.deadline_min_widths(bits, s, tc, 1.5)
        feas = allocation.feasible_packing(w_min, tc, budget)
        assert feas.any() and not feas.all()
        want = allocation.energy_opt_widths(c, w_min, feas, budget)
        got = kernel.energy_opt_widths_jit(c, w_min, feas, budget,
                                           device="cpu")
    assert got.dtype == np.float64
    assert _close(got, want)
    assert np.isclose(got.sum(), budget, rtol=1e-12)


def test_bracket_doubling_matches_the_loop():
    """The batched doubling takes the first hi·2^j that fits: a cohort
    whose first bracket is 2^10 too narrow lands where 10 doublings of
    the scalar loop do."""
    tc = np.asarray([1.0, 1.5])
    bits, s = np.asarray([1e6, 2e6]), np.asarray([1.0, 1.0])
    want = allocation.bandwidth_opt_widths(bits, s, tc, 1e3)
    got = kernel.bandwidth_opt_widths_jit(bits, s, tc, 1e3, device="cpu")
    assert _close(got, want)


def test_cohort_without_replacement_and_busy_mask_on_jit():
    eng = _engine("uniform", pop=100, backend="jit")
    eng.state.fleet.battery_j[:20] = 0.0
    for _ in range(3):
        eng.run_round(50)
        ids = np.asarray(eng.last_decision.selected)
        assert len(ids) == len(np.unique(ids)) == 50
        assert ids.min() >= 20
    eng = _engine("uniform", pop=40, backend="jit")
    eng.state.busy[:30] = True
    eng.run_round(20)
    ids = np.asarray(eng.last_decision.selected)
    assert set(ids) <= set(range(30, 40)) and len(ids) == 10


@pytest.mark.parametrize("backend", ["exact", "jit"])
def test_empty_cohort_round(backend):
    eng = _engine("uniform", pop=30, backend=backend)
    eng.state.fleet.battery_j[:] = 0.0
    rec = eng.run_round(10)
    assert rec["cohort"] == 0 and rec["dropped"] == 0
    assert eng.clock_s == 0.0 and eng.energy_j == 0.0
    assert eng.last_decision is None or eng.last_decision.n_selected == 0


def test_all_dropped_round_jit_matches_exact():
    """An infeasibly tight cut drops the whole cohort: cohort 0, every
    selected client dropped, the barrier at the cut, partial uploads
    billed on both backends alike."""
    recs = {}
    for backend in ("exact", "jit"):
        eng = _engine("uniform", pop=50, backend=backend,
                      enforce_deadline_s=0.01)
        recs[backend] = (eng.run_round(20), eng)
    (ra, ex), (rb, jt) = recs["exact"], recs["jit"]
    for rec, eng in ((ra, ex), (rb, jt)):
        assert rec["cohort"] == 0 and rec["dropped"] == 20
        assert rec["barrier_s"] <= 0.01 + 1e-6
        assert eng.clock_s > 0.0 and eng.energy_j > 0.0
        assert eng.deadline_dropped_total == 20
    assert _close(ra["wall_s"], rb["wall_s"])
    assert _close(ex.energy_j, jt.energy_j)


@pytest.mark.parametrize("spec", CHURN_SPECS)
@pytest.mark.parametrize("reallocate", [False, True])
def test_jit_matches_exact_under_churn(spec, reallocate):
    """tests/test_scenario.py's churn case: identical cohorts, drop counts
    and reason buckets; clocks within rtol 1e-9."""
    hists, sums = [], []
    for backend in ("exact", "jit"):
        cfg = EdgeConfig(channel=ChannelConfig(**UPLINK),
                         device=DeviceConfig(**HETERO), reallocate=reallocate,
                         scenario=spec, **{k: v for k, v in STRAGGLER.items()
                                           if k != "scenario"})
        eng = FleetEngine(cfg, STRAGGLER_FLEET["population"],
                          up_bytes=STRAGGLER_FLEET["up_bytes"],
                          flops=STRAGGLER_FLEET["flops"],
                          seed=STRAGGLER_FLEET["seed"], backend=backend,
                          device="cpu")
        eng.run(6, 8)
        hists.append(eng.history)
        sums.append(eng.summary())
    for a, b in zip(hists[0], hists[1], strict=True):
        assert a["cohort"] == b["cohort"]
        assert a["dropped"] == b["dropped"]
        assert _close(a["clock_s"], b["clock_s"])
    for key in ("drop_reasons", "unavailable_total", "realloc_rounds"):
        assert sums[0][key] == sums[1][key]


def test_reallocation_shrinks_barrier_on_jit():
    """tests/test_scenario.py's re-allocation case on the device backend:
    the same drops and cohorts, never a later barrier, a shorter clock."""
    res = {}
    for realloc in (False, True):
        cfg = EdgeConfig(channel=ChannelConfig(**UPLINK),
                         device=DeviceConfig(**HETERO), reallocate=realloc,
                         **STRAGGLER)
        eng = FleetEngine(cfg, STRAGGLER_FLEET["population"],
                          up_bytes=STRAGGLER_FLEET["up_bytes"],
                          flops=STRAGGLER_FLEET["flops"],
                          seed=STRAGGLER_FLEET["seed"], backend="jit",
                          device="cpu")
        eng.run(8, 8)
        res[realloc] = eng
    off, on = res[False], res[True]
    assert off.deadline_dropped_total == on.deadline_dropped_total
    assert [h["cohort"] for h in off.history] == \
        [h["cohort"] for h in on.history]
    bar_off = [h["barrier_s"] for h in off.history if "barrier_s" in h]
    bar_on = [h["barrier_s"] for h in on.history if "barrier_s" in h]
    assert all(b <= a + 1e-12 for a, b in zip(bar_off, bar_on, strict=True))
    assert any(b < a for a, b in zip(bar_off, bar_on, strict=True))
    assert on.clock_s < off.clock_s
    assert on.summary()["realloc_rounds"] > 0


def test_federated_run_on_the_jit_backend_matches_exact():
    """A FederatedRun with fleet_backend="jit" (the width bisections on
    the run's device) makes the decisions of the exact backend."""
    train, test = make_classification(reduced(FMNIST_CNN), n_train=120,
                                      n_test=40, seed=0, noise=0.5)
    runs = []
    for backend in ("exact", "jit"):
        edge = _cfg("bandwidth_opt", fleet="on", fleet_backend=backend,
                    enforce_deadline_s=float("inf"))
        fcfg = FedConfig(num_clients=8, participation=1.0, local_epochs=1,
                         batch_size=32, rounds=2, noniid_l=2, seed=0,
                         edge=edge)
        run = FederatedRun(reduced(FMNIST_CNN), fcfg, train, test,
                           "fedavg_sgd", device="cpu")
        run.run(rounds=2, eval_every=2)
        runs.append(run)
    ex, jt = runs
    assert jt.edge.device == torch.device("cpu") and ex.edge.device is None
    assert [sorted(d.selected) for d in ex.edge.decisions] == \
        [sorted(d.selected) for d in jt.edge.decisions]
    for a, b in zip(ex.edge.decisions, jt.edge.decisions, strict=True):
        assert _close(a.bandwidth_hz_arr, b.bandwidth_hz_arr)
    assert _close(ex.edge.clock.now, jt.edge.clock.now)


def test_jit_backend_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    """No silent drop to the CPU: the engine and a run's jit backend
    default to the card and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetEngine(_cfg(), 10, up_bytes=UP, flops=FLOPS, backend="jit")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EdgeRuntime(_cfg(fleet_backend="jit"), 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel.bandwidth_opt_widths_jit([1.0], [1.0], [0.1], 1.0)
