"""The whole slice: the port's ``FederatedRun("fim_lbfgs")`` against the
reference's on the CPU (i), plus the wire layer it meters through
(codecs, CommLedger, plan == ledger) and the driver's refusals.

The port starts from the reference's own initial model
(``FedStrategy.load_state_dict(from_jax(...))``), since JAX's threefry
init cannot be reproduced in torch; client sampling, data and partitions
are reproduced exactly.
"""
import contextlib
import io

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
from repro.fed import codecs as rcodecs  # noqa: E402
from repro.fed import comm as rcomm  # noqa: E402
from repro.fed.server import FederatedRun as RFederatedRun  # noqa: E402
from repro.obs.trace import render_round as r_render  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.paper_models import FMNIST_CNN, reduced  # noqa: E402
from repro_torch.data.synthetic import make_classification  # noqa: E402
from repro_torch.edge import EdgeConfig  # noqa: E402
from repro_torch.fed import codecs, comm  # noqa: E402
from repro_torch.fed import server as pserver  # noqa: E402
from repro_torch.fed.server import FederatedRun  # noqa: E402
from repro_torch.fed.strategies import names as strategy_names  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.obs import trace as obs  # noqa: E402
from repro_torch.utils.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

RUN = dict(num_clients=8, participation=0.5, noniid_l=0, rounds=4, seed=0)


def _runs(compress):
    rtrain, rtest = r_make(r_reduced(R_FMNIST), n_train=400, n_test=100, seed=0)
    ref = RFederatedRun(r_reduced(R_FMNIST), RFedConfig(compress=compress, **RUN),
                        rtrain, rtest, "fim_lbfgs")
    train, test = make_classification(reduced(FMNIST_CNN), n_train=400,
                                      n_test=100, seed=0)
    port = FederatedRun(reduced(FMNIST_CNN), FedConfig(compress=compress, **RUN),
                        train, test, "fim_lbfgs", device="cpu")
    port.strategy.load_state_dict(
        from_jax(jax.tree.map(np.asarray, ref.strategy.state_dict())))
    # the reference's aggregate and server step (its own pure update)
    # jitted, as its cohort simulator jits them: the same functions,
    # compiled once instead of op by op (~10 s of CPU saved)
    update = jax.jit(ref.strategy.cohort_server_update)

    def server_step(aggregate):
        s = ref.strategy
        s.params, s.opt_state, _ = update(s.opt_state, s.params, *aggregate)

    ref.strategy.aggregate = jax.jit(ref.strategy.aggregate)
    ref.strategy.server_step = server_step
    return ref, port


def _recording(run):
    picks = []
    sample = run.sample_clients

    def wrapped():
        out = sample()
        picks.append([int(i) for i in out])
        return out

    run.sample_clients = wrapped
    return picks


def test_whole_slice_matches_reference():
    """4 rounds of Algorithm 1, compress="none": the same cohorts, an
    equal ledger, per-round losses within 1e-5 relative and final
    parameters and optimizer state within 1e-4 relative / 1e-5 absolute
    (f32 convolutions, per-example gradients and Gram sums run in other
    orders in XLA and PyTorch; 4 quasi-Newton steps compound that)."""
    ref, port = _runs("none")
    r_picks, p_picks = _recording(ref), _recording(port)
    r_hist = ref.run(rounds=4, eval_every=2)
    p_hist = port.run(rounds=4, eval_every=2)
    assert p_picks == r_picks and len(p_picks) == 4
    assert port.ledger.summary() == ref.ledger.summary()
    _assert_history_close(r_hist, p_hist)
    for r, p in zip(r_hist, p_hist, strict=True):
        if "accuracy" in r:
            assert abs(p["accuracy"] - r["accuracy"]) <= 0.011  # <= 1 of 100
    _assert_state_close(ref, port)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree.leaves(tree)])


def _assert_state_close(ref, port):
    r_state = jax.tree.map(np.asarray, ref.strategy.state_dict())
    p_state = to_numpy(port.strategy.state_dict())
    r_leaves, p_leaves = jax.tree.leaves(r_state), tree_leaves(p_state)
    assert len(p_leaves) == len(r_leaves)
    for p, r in zip(p_leaves, r_leaves, strict=True):
        assert p.shape == r.shape and p.dtype == r.dtype
        np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-5)


def _assert_history_close(r_hist, p_hist):
    for r, p in zip(r_hist, p_hist, strict=True):
        assert p["cohort"] == r["cohort"] and p["round"] == r["round"]
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-5)


def test_topk_slice_matches_reference_with_error_feedback():
    """4 rounds of Algorithm 1 under compress="topk:0.1" (a global top-k
    of the flattened (g, Γ) payload, with per-client error feedback): the
    same cohorts, an equal ledger, per-round losses within 1e-5 relative,
    the final state within the tolerances of the uncompressed slice, and
    every client's residual within 1e-4 of its norm.  The select itself is
    bit-identical for identical inputs (tests/test_torch_topk.py); here
    the inputs differ by the f32 drift of the client steps."""
    ref, port = _runs("topk:0.1")
    r_picks, p_picks = _recording(ref), _recording(port)
    r_hist = ref.run(rounds=4, eval_every=4)
    p_hist = port.run(rounds=4, eval_every=4)
    assert p_picks == r_picks
    assert port.ledger.summary() == ref.ledger.summary()
    _assert_history_close(r_hist, p_hist)
    _assert_state_close(ref, port)
    r_res = {int(c): v for c, v in ref._ef_residual.items()}
    assert sorted(port._ef_residual) == sorted(r_res)
    assert len(r_res) == len({c for pick in r_picks for c in pick})
    for cid, res in port._ef_residual.items():
        want = _flat(r_res[cid])
        got = _flat(to_numpy(res))
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), cid


def test_int8_slice_matches_reference_per_round(monkeypatch):
    """4 rounds under compress="int8" with the reference's own rounding
    uniforms fed to the port (threefry cannot be reproduced in torch).

    Round 1 holds every part of the state within the uncompressed slice's
    tolerances.  From round 2 on, payloads that differ by f32 drift (XLA
    and PyTorch sum convolutions in other orders) straddle a rounding
    threshold here and there, and those coordinates arrive one int8
    level (max|x|/127) apart: 0-5 of 55,860 per client in rounds 2-3 and
    38-79 in round 4 of this run.  So later rounds hold what a flip
    leaves intact: no coordinate is more than one level off, the losses
    stay within 1e-5 relative, and the final state is within 2e-3 of each
    part's norm (chip_smoke.py's int8 state bound: a flip moves a leaf by
    at most 1/127 of its norm, 1/cohort of that after the mean)."""
    ref, port = _runs("int8")
    keys, r_sent, p_sent = [], [], []
    r_compress = ref.strategy.compress_payload
    p_compress = port.strategy.compress_payload

    def r_recording(payload, key, residual=None, codec=None):
        keys.append((key, [leaf.shape for leaf in jax.tree.leaves(payload)]))
        out = r_compress(payload, key, residual, codec=codec)
        r_sent.append(([np.asarray(x) for x in jax.tree.leaves(payload)],
                       [np.asarray(x) for x in jax.tree.leaves(out[0])]))
        return out

    def p_recording(payload, generator, residual=None, codec=None):
        out = p_compress(payload, generator, residual, codec=codec)
        p_sent.append([x.numpy().copy() for x in tree_leaves(out[0])])
        return out

    ref.strategy.compress_payload = r_recording
    port.strategy.compress_payload = p_recording
    queue = []

    def fed_uniforms(x, generator):
        u = queue.pop(0)
        assert u.shape == x.shape
        return u

    monkeypatch.setattr(kernel_ops, "int8_uniforms", fed_uniforms)
    r_picks, p_picks = _recording(ref), _recording(port)
    for t in range(4):
        r_info = ref.round()
        # the reference draws one uniform per leaf from split(key, n_leaves)
        for key, shapes in keys[len(keys) - r_info["cohort"]:]:
            for k, shape in zip(jax.random.split(key, len(shapes)), shapes,
                                strict=True):
                queue.append(torch.from_numpy(np.array(
                    jax.random.uniform(k, shape))))
        p_info = port.round()
        assert not queue
        assert p_info["cohort"] == r_info["cohort"]
        np.testing.assert_allclose(p_info["loss"], r_info["loss"], rtol=1e-5)
        if t == 0:
            _assert_state_close(ref, port)
    assert p_picks == r_picks
    assert port.ledger.summary() == ref.ledger.summary()
    assert len(p_sent) == len(r_sent) == 16
    for got, (payload, want) in zip(p_sent, r_sent, strict=True):
        for g, w, x in zip(got, want, payload, strict=True):
            level = max(float(np.abs(x).max()), 1e-12) / 127
            assert np.abs(g - w).max() <= 1.1 * level
    r_state = jax.tree.leaves(jax.tree.map(np.asarray,
                                           ref.strategy.state_dict()))
    p_state = tree_leaves(to_numpy(port.strategy.state_dict()))
    for p, r in zip(p_state, r_state, strict=True):
        diff = np.linalg.norm((p - r).astype(np.float64).ravel())
        assert diff <= 2e-3 * max(np.linalg.norm(r.astype(np.float64).ravel()),
                                  1e-30)


def test_int8_slice_bills_the_reference_bytes():
    """compress="int8": the uniforms differ (torch vs threefry draws), so
    only the byte accounting must match, and it must match exactly.  The
    reference's ledger is fixed by its cohort and plan alone (metering
    runs before any client work), so it is driven through sampling and
    metering only."""
    ref, port = _runs("int8")
    p_picks = _recording(port)
    hist = port.run(rounds=4, eval_every=4)
    r_picks = []
    for _ in range(4):
        cohort = ref.sample_clients()
        r_picks.append([int(i) for i in cohort])
        ref._meter_round(cohort)
    assert p_picks == r_picks
    assert port.ledger.summary() == ref.ledger.summary()
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_ledger_equals_plan_bytes():
    train, test = make_classification(reduced(FMNIST_CNN), n_train=200,
                                      n_test=50, seed=0)
    for compress in ("none", "int8"):
        run = FederatedRun(reduced(FMNIST_CNN),
                           FedConfig(compress=compress, **RUN), train, test,
                           "fim_lbfgs", device="cpu")
        run.run(rounds=2, eval_every=2)
        plan, k = run.plan, 4
        d = run.strategy.n_params()
        assert run.ledger.down_bytes == 2 * plan.downlink_bytes() * k
        assert run.ledger.up_star_bytes == 2 * plan.upload_bytes() * k
        assert run.ledger.up_tree_bytes == 2 * plan.upload_bytes() * 2
        assert run.ledger.scalar_bytes == 2 * 21 ** 2 * 4
        per_el = 4 if compress == "none" else 1
        assert plan.upload_bytes() == 2 * d * per_el


# ------------------------------------------------------------------ codecs
def test_codec_registry_and_wire_bytes_match_reference():
    assert codecs.names() == ["int8", "none", "randk", "topk"]
    for spec in ("none", "int8", "topk:0.1", "randk:0.1"):
        ours, theirs = codecs.make(spec), rcodecs.make(spec)
        assert ours.spec() == theirs.spec() and ours.identity == theirs.identity
        for n in (0, 1, 27_930, 2 * 206_922, 12.5):
            assert ours.wire_bytes(n) == theirs.wire_bytes(n)
            assert codecs.achieved_ratio(ours, n) == rcodecs.achieved_ratio(theirs, n)
    with pytest.raises(ValueError, match="unknown payload codec"):
        codecs.make("fp16")
    with pytest.raises(ValueError, match="unknown payload codec"):
        FedConfig(compress="zstd:3")
    with pytest.raises(ValueError, match="kernels mode"):
        codecs.make("int8", kernels="sometimes")
    assert codecs.make("int8", kernels="off").kernels == "off"


def test_int8_codec_equals_explicit_quantize_dequantize():
    """The codec's round-trip and the explicit two-step wire form draw the
    same stream and agree bit for bit."""
    rng = np.random.default_rng(0)
    tree = ({"w": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)),
             "b": torch.from_numpy(rng.normal(size=4).astype(np.float32))},
            {"w": torch.zeros(2, 2)})
    sent, residual = codecs.make("int8").roundtrip(
        tree, torch.Generator().manual_seed(7))
    q, scales = codecs.quantize_tree(tree, torch.Generator().manual_seed(7))
    assert residual is None
    assert all(t.dtype == torch.int8 for t in tree_leaves(q))
    for a, b in zip(tree_leaves(sent),
                    tree_leaves(codecs.dequantize_tree(q, scales)), strict=True):
        assert torch.equal(a, b)


def test_comm_ledger_matches_reference():
    ours, theirs = comm.CommLedger(), rcomm.CommLedger()
    for led in (ours, theirs):
        led.broadcast(1000, 3)
        led.upload(2000, 5, wire_bytes=2000.0)
        led.upload(2000, 5, aggregatable=False, wire_bytes=500.0)
        led.upload(10, 0, wire_bytes=40.0)
        led.upload_per_client([4.0, 9.0, 1.0])
        led.scalars(441)
        led.end_round()
    assert ours.summary() == theirs.summary()
    tree = {"a": torch.zeros(3, 4), "b": (torch.zeros(2), None)}
    assert comm.tree_n_floats(tree) == 14


# -------------------------------------------------------------- the driver
def test_driver_refusals():
    assert strategy_names() == ["fedavg_adam", "fedavg_sgd", "feddane",
                                "fedova", "fedova_lbfgs", "fedprox",
                                "fim_lbfgs"]
    # the fleet's fused device backend (fleet_backend="jit") constructs
    # and runs a round, on the run's device (here the CPU)
    jit_train, jit_test = make_classification(
        reduced(FMNIST_CNN), n_train=50, n_test=10, seed=0)
    jit_run = FederatedRun(
        reduced(FMNIST_CNN),
        FedConfig(edge=EdgeConfig(fleet="on", fleet_backend="jit",
                                  scheduler="bandwidth_opt"), **RUN),
        jit_train, jit_test, "fim_lbfgs", device="cpu")
    info = jit_run.round()
    assert jit_run.edge.fleet_active() and info["cohort"] > 0
    assert jit_run.edge.device == torch.device("cpu")
    assert info["wall_s"] > 0 and np.isfinite(info["loss"])
    train, test = make_classification(reduced(FMNIST_CNN), n_train=50,
                                      n_test=10, seed=0)
    with pytest.raises(ValueError, match="unknown federated strategy"):
        FederatedRun(reduced(FMNIST_CNN), FedConfig(**RUN), train, test,
                     "fedsgd_typo", device="cpu")


def test_cuda_run_raises_without_cuda(monkeypatch):
    """No silent drop to the CPU: asking for CUDA where there is none
    raises (simulated on a host that has a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train, test = make_classification(reduced(FMNIST_CNN), n_train=50,
                                      n_test=10, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FederatedRun(reduced(FMNIST_CNN), FedConfig(**RUN), train, test,
                     "fim_lbfgs")


def test_entry_point_pins_f32_convolutions_and_matmuls():
    """cuDNN would run f32 convolutions in TF32 by default; the driver
    turns TF32 off for both cuDNN and matmuls."""
    pserver.resolve_device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_verbose_prints_the_reference_line():
    rec = {"round": 12, "loss": 0.123456, "accuracy": 0.5}
    assert obs.render_round(rec) == r_render(rec)
    assert obs.render_round({"round": 3}) == r_render({"round": 3})
    train, test = make_classification(reduced(FMNIST_CNN), n_train=100,
                                      n_test=20, seed=0)
    run = FederatedRun(reduced(FMNIST_CNN), FedConfig(**RUN), train, test,
                       "fim_lbfgs", device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = run.run(rounds=2, eval_every=1, verbose=True)
    assert out.getvalue().splitlines() == [obs.render_round(h) for h in hist]
