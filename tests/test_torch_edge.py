"""The port's edge modules (``repro_torch.edge``) against the reference's
(``repro.edge``) on the CPU.

Both are numpy over seeded ``default_rng`` streams, so every draw and
every decision must be exactly equal: the channel and device draws,
every registered allocation policy's ``decide`` on one ``RoundState``,
the deadline verdict, the staleness weights, and the scenario grammar
with three rounds of effects for every registered process and fault.
The last case drives the fleet fast path (``fleet="on"``) of the port's
``FederatedRun`` beside its per-client path (``"off"``) and the
reference's.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.edge import allocation as r_allocation  # noqa: E402
from repro.edge import async_agg as r_async  # noqa: E402
from repro.edge import channel as r_channel  # noqa: E402
from repro.edge import device as r_device  # noqa: E402
from repro.edge import events as r_events  # noqa: E402
from repro.edge import runtime as r_runtime  # noqa: E402
from repro.edge import scenario as r_scenario  # noqa: E402
from repro.fed import codecs as r_codecs  # noqa: E402
from repro_torch.edge import allocation, async_agg, channel, device  # noqa: E402
from repro_torch.edge import events, runtime, scenario  # noqa: E402
from repro_torch.fed import codecs  # noqa: E402
from test_torch_edge_run import fingerprint, make_runs  # noqa: E402

POP = 12
CHANNEL = dict(bandwidth_hz=2e5, snr_db_mean=10.0, snr_db_std=3.0,
               fading="rayleigh", server_rate_bps=50e6)
DEVICE = dict(flops_per_s_mean=2e9, flops_per_s_sigma=1.0, battery_j=40.0,
              idle_power_w=0.1)


def _equal(a, b):
    """Exact equality of numpy arrays, scalars and their containers."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b, strict=True)))
    return a == b


@pytest.mark.parametrize("topology", ["star", "tree"])
def test_channel_and_device_draws_match_reference(topology):
    ours = channel.Channel(channel.ChannelConfig(topology=topology, **CHANNEL),
                           POP, seed=3)
    theirs = r_channel.Channel(
        r_channel.ChannelConfig(topology=topology, **CHANNEL), POP, seed=3)
    ids = np.arange(POP)
    up = np.linspace(1e4, 2e5, POP)
    for _ in range(3):
        ours.sample()
        theirs.sample()
        assert _equal(ours.rates_bps, theirs.rates_bps)
        assert _equal(ours.spectral_efficiency(ids),
                      theirs.spectral_efficiency(ids))
        assert _equal(ours.uplink_time_s(up, ids), theirs.uplink_time_s(up, ids))
        assert _equal(ours.uplink_energy_j(up, ids),
                      theirs.uplink_energy_j(up, ids))
        assert _equal(ours.comm_round_time_split(up, up / 4, ids),
                      theirs.comm_round_time_split(up, up / 4, ids))
        assert ours.downlink_time_s(1e6) == theirs.downlink_time_s(1e6)
    mine = device.DeviceFleet(device.DeviceConfig(**DEVICE), POP, seed=5)
    ref = r_device.DeviceFleet(r_device.DeviceConfig(**DEVICE), POP, seed=5)
    assert _equal(mine.flops_per_s, ref.flops_per_s)
    for fleet in (mine, ref):
        fleet.spend(ids[::2], np.full(POP // 2, 45.0))
    assert _equal(mine.alive(ids), ref.alive(ids))
    assert _equal(mine.compute_time_s(3e9, ids), ref.compute_time_s(3e9, ids))
    assert (device.flops_grad_fim(27_930, 37)
            == r_device.flops_grad_fim(27_930, 37))
    assert (device.flops_local_sgd(27_930, 37, 5)
            == r_device.flops_local_sgd(27_930, 37, 5))


def _runtime(pkg_runtime, pkg_channel, pkg_device, policy):
    cfg = pkg_runtime.EdgeConfig(
        channel=pkg_channel.ChannelConfig(**CHANNEL),
        device=pkg_device.DeviceConfig(**DEVICE), scheduler=policy,
        deadline_s=1.0, min_clients=2, battery_floor_j=39.0,
        enforce_deadline_s=1.2, adaptive_ratio=0.25)
    return pkg_runtime.EdgeRuntime(cfg, POP, seed=7)


def _wire(codec_mod, n_floats):
    def wire_fn(codec=None):
        return ((codec or codec_mod.NONE).wire_bytes(n_floats), 0.0)
    return wire_fn


def _decision(d):
    return {"alloc": {int(i): (a.bandwidth_hz, a.deadline_s,
                               None if a.codec is None else a.codec.spec())
                      for i, a in d.allocations.items()},
            "excluded": {int(i): r for i, r in d.excluded.items()},
            "dropped": {int(i): r for i, r in d.dropped.items()},
            "budget": d.budget_hz}


def test_every_policy_decides_as_the_reference():
    """Over the registry (which must list the reference's names): the
    policy's ``decide`` on one RoundState, then three rounds through
    ``EdgeRuntime.decide`` + ``finish_round_sync`` (the deadline
    verdict, the clock, the energy and the batteries)."""
    assert allocation.names() == r_allocation.names()
    ids = np.arange(POP)
    flops = np.linspace(2e8, 3e9, POP)
    for name in allocation.names():
        ours = _runtime(runtime, channel, device, name)
        theirs = _runtime(r_runtime, r_channel, r_device, name)
        for rt in (ours, theirs):
            rt.channel.sample()
        s_ours = ours._round_state(6, ids, _wire(codecs, 40_000.0), flops,
                                   True)
        s_theirs = theirs._round_state(6, ids, _wire(r_codecs, 40_000.0),
                                       flops, True)
        assert _equal(s_ours.est.time_s, s_theirs.est.time_s)
        assert _equal(_decision(ours.policy.decide(s_ours)),
                      _decision(theirs.policy.decide(s_theirs))), name
        for _ in range(3):
            outs = []
            for rt, mod in ((ours, codecs), (theirs, r_codecs)):
                sel, est, dec = rt.decide(6, ids, _wire(mod, 40_000.0), flops)
                rec = rt.finish_round_sync(est, 40_000.0, 1e5)
                outs.append((sel, est.time_s, _decision(dec), rec,
                             rt.fleet.battery_j))
            assert _equal(outs[0], outs[1]), name
        assert _equal(ours.summary(), theirs.summary()), name


def test_enforce_deadlines_and_staleness_weights_match_reference():
    rng = np.random.default_rng(0)
    c = np.arange(9)
    t_comp = rng.uniform(0.1, 1.0, 9)
    finish = t_comp + rng.uniform(0.0, 1.5, 9)
    deadline = np.where(np.arange(9) % 3 == 0, np.inf, 1.2)
    a = events.enforce_deadlines(c, finish, t_comp, deadline, 1e-9)
    b = r_events.enforce_deadlines(c, finish, t_comp, deadline, 1e-9)
    for field in ("clients", "deadline_s", "finish_s", "t_comp_s",
                  "dropped", "tx_frac"):
        assert _equal(getattr(a, field), getattr(b, field)), field
    assert a.any_dropped and a.reasons() == b.reasons()
    energy = rng.uniform(1.0, 3.0, 9)
    assert _equal(a.capped_spend_j(finish, energy, 0.2),
                  b.capped_spend_j(finish, energy, 0.2))
    widths = rng.uniform(1e4, 1e5, 9)
    assert _equal(events.reallocated_finish(finish, t_comp, a.deadline_s,
                                            widths, a.dropped),
                  r_events.reallocated_finish(finish, t_comp, b.deadline_s,
                                              widths, b.dropped))
    for n, tau, alpha in (([3, 5, 8], [0, 2, 5], 0.5), ([], [], 0.5),
                          ([4.0, 4.0], [1, 0], 1.5), ([0.0, 0.0], [0, 0], 1)):
        assert _equal(async_agg.staleness_weights(n, tau, alpha),
                      r_async.staleness_weights(n, tau, alpha))


def _specs(tmp_path):
    trace = tmp_path / "avail.jsonl"
    trace.write_text("\n".join(json.dumps(r) for r in (
        {"t": 0.0, "off": [1, 4]}, {"t": 1.0, "on": [4], "off": [7]},
        {"t": 2.0, "set": [0, 1, 2, 3, 5, 8, 9, 10, 11]})) + "\n")
    return {
        "always_on": "always_on",
        "diurnal": "diurnal:period=6,amp=0.5,base=0.6,unit=round",
        "markov": "markov:p_drop=0.2,p_join=0.4",
        "trace": f"trace:{trace}",
        "blackout": "blackout:start=0.5,end=1.5,frac=0.5",
        "snr_burst": "snr_burst:prob=0.4,scale=0.1",
        "straggler": "straggler:prob=0.3,slow=4",
        "battery_gate": "battery_gate:floor_j=20",
        "data_exclusion": "data_exclusion:0.7",
    }


def test_scenario_registry_and_effects_match_reference(tmp_path):
    """Every registered process and fault: the parsed components' knobs,
    and three rounds of effects drawn from the scenario's own stream."""
    assert scenario.process_names() == r_scenario.process_names()
    assert scenario.fault_names() == r_scenario.fault_names()
    specs = _specs(tmp_path)
    assert sorted(specs) == sorted(scenario.process_names()
                                   + scenario.fault_names())
    battery = np.linspace(5.0, 60.0, POP)
    for name, spec in specs.items():
        (pa, pf), (ra, rf) = scenario.parse_spec(spec), \
            r_scenario.parse_spec(spec)
        assert pa.name == ra.name and [f.name for f in pf] == \
            [f.name for f in rf]
        assert _equal([vars(x) for x in (pa, *pf)],
                      [vars(x) for x in (ra, *rf)]), name
        ours = scenario.make_scenario(spec, POP, seed=11)
        theirs = r_scenario.make_scenario(spec, POP, seed=11)
        for r in range(3):
            a = ours.begin_round(r, 0.6 * r, battery)
            b = theirs.begin_round(r, 0.6 * r, battery)
            for field in ("proc_off", "fault_off", "snr_scale",
                          "compute_scale", "workload_frac", "available"):
                assert _equal(getattr(a, field), getattr(b, field)), \
                    (name, r, field)
        assert _equal(ours.rng.bit_generator.state,
                      theirs.rng.bit_generator.state), name


def test_fleet_fast_path_matches_per_client_path_and_reference():
    """``fleet="on"`` (the struct-of-arrays path, exact numpy backend)
    beside ``"off"`` in the port, under churn with re-allocation, and
    both beside the reference: bit-identical fingerprints and records;
    the refusal of the unported ``jit`` backend."""
    scenario_spec = "markov:p_drop=0.2,p_join=0.4|snr_burst:prob=0.4,scale=0.1"
    ref, (off, on) = make_runs("fim_lbfgs", 3, fleet=("off", "on"),
                               scheduler="energy_opt", enforce_deadline_s=3.0,
                               scenario=scenario_spec, reallocate=True)
    r_hist = ref.run(rounds=3, eval_every=3)
    off_hist = off.run(rounds=3, eval_every=3)
    on_hist = on.run(rounds=3, eval_every=3)
    assert on.edge.fleet_active() and not off.edge.fleet_active()
    assert fingerprint(on) == fingerprint(off) == fingerprint(ref)
    edge_keys = ("cohort", "dropped", "wall_s", "sim_time_s", "energy_j",
                 "barrier_s")
    for r, a, b in zip(r_hist, off_hist, on_hist, strict=True):
        assert ({k: a.get(k) for k in edge_keys}
                == {k: b.get(k) for k in edge_keys}
                == {k: r.get(k) for k in edge_keys})
    assert on.edge.summary() == off.edge.summary() == ref.edge.summary()
    assert any(h.get("dropped") for h in on_hist)
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        runtime.EdgeConfig(fleet_backend="jit")
