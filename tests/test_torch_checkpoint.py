"""Checkpoint/resume in the port (``repro_torch.checkpoint``) on the CPU.

The npz tree round trip (f32, int32 and bf16 leaves); the bit-identical
resume tail of ``tests/test_resume.py`` over its three scenarios with
its ``_mk`` run, its counters and refusals; a 3 + 3-round int8
``fim_lbfgs`` run equal to 6 straight rounds (the codec generator's
state rides in the checkpoint); and the port's resumed run against the
reference's straight one: ledger, cohorts, drops and clock exactly, the
params within 1e-4 of their norm (the port starts from the reference's
own initial model through ``from_jax``; f32 sums in other orders, as in
the whole-slice tests).
"""
import os

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
from repro_torch import checkpoint  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.paper_models import FMNIST_CNN, reduced  # noqa: E402
from repro_torch.data.synthetic import make_classification  # noqa: E402
from repro_torch.edge import ChannelConfig, DeviceConfig, EdgeConfig  # noqa: E402
from repro_torch.fed.server import FederatedRun  # noqa: E402
from repro_torch.utils.convert import from_jax  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

MCFG = reduced(FMNIST_CNN)
UPLINK = dict(bandwidth_hz=2e5, snr_db_mean=10.0, snr_db_std=3.0,
              fading="rayleigh", server_rate_bps=50e6)
HETERO = dict(flops_per_s_mean=2e9, flops_per_s_sigma=1.0)
DATA = dict(n_train=300, n_test=100, seed=0, noise=0.5)
TRAIN, TEST = make_classification(MCFG, **DATA)

# tests/test_resume.py's scenarios and run
SCENARIOS = [
    None,
    ("diurnal:period=20,amp=0.4,base=0.7|"
     "snr_burst:prob=0.3,scale=0.1"),
    "markov:p_drop=0.2,p_join=0.4|data_exclusion:0.7",
]
EDGE = dict(scheduler="deadline", deadline_s=5.0, min_clients=1,
            enforce_deadline_s=1.5, reallocate=True)
RUN = dict(num_clients=8, participation=1.0, local_epochs=1, batch_size=32,
           rounds=6, noniid_l=2, seed=0)
LEDGER_FIELDS = ("down_bytes", "up_star_bytes", "up_tree_bytes",
                 "scalar_bytes", "rounds")


def _mk(scenario, alg="fedavg_sgd", compress="none", mode="sync"):
    edge = EdgeConfig(channel=ChannelConfig(**UPLINK),
                      device=DeviceConfig(**HETERO), scenario=scenario,
                      mode=mode, **EDGE)
    return FederatedRun(MCFG, FedConfig(edge=edge, compress=compress, **RUN),
                        TRAIN, TEST, alg, device="cpu")


def _tail_fp(run, tail=3):
    """Everything the resumed run must reproduce over its last rounds."""
    h = run.edge.history[-tail:]
    return {
        "ledger": {f: getattr(run.ledger, f) for f in LEDGER_FIELDS},
        "cohorts": [tuple(sorted(d.selected))
                    for d in run.edge.decisions[-tail:]],
        "drops": [tuple(sorted(d.dropped))
                  for d in run.edge.decisions[-tail:]],
        "wall": [r["wall_s"] for r in h],
        "cohort_sizes": [r["cohort"] for r in h],
        "clock_s": run.edge.clock.now,
        "energy_j": run.edge.energy_j,
        "battery_j": run.edge.fleet.battery_j.tolist(),
        "unavailable": run.edge.unavailable_total,
        "realloc_rounds": run.edge.realloc_rounds,
    }


def _resumed(make, tmp_path, head=3, tail=3):
    run = make()
    run.run(rounds=head, eval_every=head)
    ckpt = str(tmp_path / "ckpt.npz")
    run.save(ckpt)
    resumed = make().restore_from(ckpt)
    resumed.run(rounds=tail, eval_every=tail)
    return resumed


def _params_equal(a, b):
    la, lb = tree_leaves(a.strategy.state_dict()), tree_leaves(
        b.strategy.state_dict())
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb, strict=True))


# ---------------------------------------------------------- the npz tree
def test_npz_roundtrip_of_nested_f32_int32_bf16(tmp_path):
    tree = {"layers": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.linspace(-2, 3, 4).to(torch.bfloat16)},
            "pair": (torch.tensor(7, dtype=torch.int32),
                     [torch.ones(2, dtype=torch.bfloat16) / 3]),
            "host": np.arange(5, dtype=np.float64)}
    path = os.path.join(tmp_path, "ck.npz")
    checkpoint.save(path, tree)
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]   # no tmp left
    template = {"layers": {"w": torch.zeros(3, 4),
                           "b": torch.zeros(4, dtype=torch.bfloat16)},
                "pair": (torch.tensor(0, dtype=torch.int32),
                         [torch.zeros(2, dtype=torch.bfloat16)]),
                "host": np.zeros(5)}
    out = checkpoint.restore(path, template)
    assert isinstance(out["pair"], tuple) and isinstance(out["pair"][1],
                                                         list)
    for a, b in zip(tree_leaves(tree), tree_leaves(out), strict=True):
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype and np.array_equal(a, b)
        else:
            assert b.dtype == a.dtype and b.device == a.device
            assert torch.equal(a, b)       # bf16 bits kept exactly
    with np.load(path) as data:
        assert str(data["__viewdtype__/layers/b"]) == "bfloat16"
        assert data["layers/b"].dtype == np.uint16


def test_npz_missing_key_raises(tmp_path):
    path = os.path.join(tmp_path, "ck.npz")
    checkpoint.save(path, {"a": torch.ones(3)})
    with pytest.raises(KeyError, match="missing keys"):
        checkpoint.restore(path, {"a": torch.ones(3), "b": torch.ones(2)})


# ----------------------------------------------------- tests/test_resume.py
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_resume_tail_bit_identical(scenario, tmp_path):
    straight = _mk(scenario)
    straight.run(rounds=6, eval_every=6)
    resumed = _resumed(lambda: _mk(scenario), tmp_path)
    assert _tail_fp(resumed) == _tail_fp(straight)
    assert _params_equal(resumed, straight)


def test_resume_restores_counters(tmp_path):
    run = _mk(SCENARIOS[1])
    run.run(rounds=4, eval_every=4)
    ckpt = str(tmp_path / "c.npz")
    run.save(ckpt)
    fresh = _mk(SCENARIOS[1]).restore_from(ckpt)
    assert fresh.edge.clock.now == run.edge.clock.now
    assert fresh.edge.energy_j == run.edge.energy_j
    assert fresh.edge.unavailable_total == run.edge.unavailable_total
    assert fresh.edge.dropped_total == run.edge.dropped_total
    # the history (and so summary()["rounds"]) restarts: observability only
    assert ({k: v for k, v in fresh.edge.summary().items() if k != "rounds"}
            == {k: v for k, v in run.edge.summary().items() if k != "rounds"})
    assert fresh.ledger.summary() == run.ledger.summary()
    assert np.array_equal(fresh.edge.fleet.battery_j, run.edge.fleet.battery_j)
    assert _params_equal(fresh, run)


def test_resume_refusals(tmp_path):
    run = _mk(SCENARIOS[1])
    run.run(rounds=2, eval_every=2)
    ckpt = str(tmp_path / "c.npz")
    run.save(ckpt)
    with pytest.raises(ValueError, match="spec mismatch"):
        _mk(SCENARIOS[2]).restore_from(ckpt)
    with pytest.raises(ValueError, match="sync-mode runs only"):
        _mk(None, alg="fim_lbfgs", mode="async").save(ckpt)
    ef = _mk(None, compress="topk:0.1")
    ef.run(rounds=1, eval_every=1)
    with pytest.raises(ValueError, match="error-feedback"):
        ef.save(ckpt)


def test_int8_fim_lbfgs_resume_replays_the_codec_stream(tmp_path):
    """3 + 3 rounds of int8 fim_lbfgs equal 6 straight ones bit for bit:
    the stochastic rounding draws continue from the saved generator."""
    def make():
        return _mk(SCENARIOS[1], alg="fim_lbfgs", compress="int8")

    straight = make()
    straight.run(rounds=6, eval_every=6)
    resumed = _resumed(make, tmp_path)
    assert _tail_fp(resumed) == _tail_fp(straight)
    assert torch.equal(resumed.codec_generator.get_state(),
                       straight.codec_generator.get_state())
    assert _params_equal(resumed, straight)


def test_resumed_port_run_matches_the_reference(tmp_path):
    """The port's 3 + 3-round run against the reference's 6 straight
    rounds of tests/test_resume.py's run: ledger, cohorts, drops and the
    clock exactly; each params leaf within 1e-4 of its norm."""
    scenario = SCENARIOS[2]
    ref = RFederatedRun(
        r_reduced(R_FMNIST),
        RFedConfig(edge=REdgeConfig(channel=RChannelConfig(**UPLINK),
                                    device=RDeviceConfig(**HETERO),
                                    scenario=scenario, **EDGE), **RUN),
        *r_make(r_reduced(R_FMNIST), **DATA), "fedavg_sgd")
    state = from_jax(jax.tree.map(np.asarray, ref.strategy.state_dict()))
    ref.run(rounds=6, eval_every=6)

    def make():
        run = _mk(scenario)
        run.strategy.load_state_dict(state)
        return run

    resumed = _resumed(make, tmp_path)
    want, got = _tail_fp(ref, tail=6), _tail_fp(resumed)
    want["cohorts"], want["drops"] = want["cohorts"][-3:], want["drops"][-3:]
    want["wall"] = want["wall"][-3:]
    want["cohort_sizes"] = want["cohort_sizes"][-3:]
    assert got == want
    assert any(want["drops"])
    r_leaves = jax.tree.leaves(jax.tree.map(np.asarray, ref.params))
    p_leaves = [t.numpy() for t in tree_leaves(resumed.params)]
    for p, r in zip(p_leaves, r_leaves, strict=True):
        err = np.linalg.norm((p - r).astype(np.float64).ravel())
        assert err <= 1e-4 * np.linalg.norm(r.astype(np.float64).ravel())
