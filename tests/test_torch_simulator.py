"""The cohort simulator (``repro_torch.fed.simulator``) against the
reference's ``repro.fed.simulator`` on the CPU.

The port starts from the reference's own initial model and optimizer
state (``from_jax``); the cohorts are stacked batches drawn with numpy
from a seed, fed to both.  Tolerances: the loss within 1e-5 relative and
every leaf of the params and the L-BFGS/Fisher state within 1e-4 of its
norm after 3 rounds (f32 convolutions, per-example gradients and Gram
sums run in other orders in XLA and PyTorch, and 3 quasi-Newton steps
compound that, as in the whole-slice tests); the history's counters
exactly.  The edge wrapper's host-side stats (``wall_s``,
``sim_time_s``, ``energy_j``, ``dropped``, ``barrier_s``) are numpy
on both sides and must be equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as RFedConfig  # noqa: E402
from repro.configs.paper_models import FMNIST_CNN as R_FMNIST  # noqa: E402
from repro.configs.paper_models import reduced as r_reduced  # noqa: E402
from repro.data.synthetic import make_classification as r_make  # noqa: E402
from repro.edge import ChannelConfig as RChannelConfig  # noqa: E402
from repro.edge import DeviceConfig as RDeviceConfig  # noqa: E402
from repro.edge import EdgeConfig as REdgeConfig  # noqa: E402
from repro.edge.runtime import EdgeRuntime as REdgeRuntime  # noqa: E402
from repro.fed import simulator as rsim  # noqa: E402
from repro.fed import strategies as rstrategies  # noqa: E402
from repro.models import cnn as rcnn  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.paper_models import FMNIST_CNN, reduced  # noqa: E402
from repro_torch.core import fim  # noqa: E402
from repro_torch.data.synthetic import make_classification  # noqa: E402
from repro_torch.edge import ChannelConfig, DeviceConfig, EdgeConfig  # noqa: E402
from repro_torch.edge.runtime import EdgeRuntime  # noqa: E402
from repro_torch.fed import simulator, strategies  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.utils.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

K, B, ROUNDS = 4, 16, 3
# the stable fim_lbfgs knobs of the edge-run parity tests
KNOBS = dict(max_step_norm=0.5, fim_damping=0.05, fim_ema=0.9)
STATE_TOL = 1e-4
LOSS_RTOL = 1e-5
TRAIN, _ = make_classification(reduced(FMNIST_CNN), n_train=300, n_test=50,
                               seed=0, noise=0.5)
UPLINK = dict(bandwidth_hz=2e5, snr_db_mean=10.0, snr_db_std=3.0,
              fading="rayleigh", server_rate_bps=50e6)
HETERO = dict(flops_per_s_mean=2e9, flops_per_s_sigma=1.0)


def _pair(alg="fim_lbfgs", **kw):
    """The reference's strategy and the port's on the CPU, from the
    reference's initial state."""
    cfg = dict(num_clients=8, seed=0, **KNOBS)
    cfg.update(kw)
    ref = rstrategies.get(alg)(r_reduced(R_FMNIST), RFedConfig(**cfg), 10)
    port = strategies.get(alg)(reduced(FMNIST_CNN), FedConfig(**cfg), 10,
                               device="cpu")
    port.load_state_dict(from_jax(jax.tree.map(np.asarray,
                                               ref.state_dict())))
    return ref, port


def _cohort(rng, k=K, b=B):
    idx = rng.integers(0, len(TRAIN.x), size=(k, b))
    x, y = TRAIN.x[idx], TRAIN.y[idx]
    return ({"x": jnp.asarray(x), "y": jnp.asarray(y)},
            {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})


def _assert_tree_close(p_tree, r_tree, tol=STATE_TOL):
    p_leaves = tree_leaves(to_numpy(p_tree))
    r_leaves = jax.tree.leaves(jax.tree.map(np.asarray, r_tree))
    assert len(p_leaves) == len(r_leaves)
    for p, r in zip(p_leaves, r_leaves, strict=True):
        assert p.shape == r.shape and p.dtype == r.dtype
        if p.dtype.kind in "iub":
            np.testing.assert_array_equal(p, r)
            continue
        err = np.linalg.norm((p - r).astype(np.float64).ravel())
        assert err <= tol * np.linalg.norm(r.astype(np.float64).ravel()) \
            + 1e-12, (err, np.linalg.norm(r))


def _steps(maker, ref, port, fim_mode):
    if maker == "from_strategy":
        return rsim.from_strategy(ref), simulator.from_strategy(port)
    rm, pm = r_reduced(R_FMNIST), reduced(FMNIST_CNN)
    r_step = rsim.make_round_step(
        lambda p, b: rcnn.softmax_loss(p, rm, b), rcnn.per_example_loss_fn(rm),
        ref.ocfg, fim_mode)
    p_step = simulator.make_round_step(
        lambda p, b: cnn.softmax_loss(p, pm, b), cnn.per_example_loss_fn(pm),
        port.ocfg, fim_mode)
    return r_step, p_step


@pytest.mark.parametrize("maker", ["make_round_step", "from_strategy"])
@pytest.mark.parametrize("fim_mode", ["per_example", "microbatch"])
def test_round_step_matches_reference(maker, fim_mode):
    """3 cohort rounds at K = 4, B = 16: the loss each round, then the
    params and the whole FIM-L-BFGS state."""
    ref, port = _pair(fim_mode=fim_mode)
    r_step, p_step = _steps(maker, ref, port, fim_mode)
    rng = np.random.default_rng(0)
    rp, ro, pp, po = ref.params, ref.opt_state, port.params, port.opt_state
    w = np.asarray([16.0, 12.0, 16.0, 9.0], np.float32)
    for _ in range(ROUNDS):
        r_batch, p_batch = _cohort(rng)
        rp, ro, r_stats = r_step(rp, ro, r_batch, jnp.asarray(w))
        pp, po, p_stats = p_step(pp, po, p_batch, torch.from_numpy(w))
        np.testing.assert_allclose(float(p_stats["loss"]),
                                   float(r_stats["loss"]), rtol=LOSS_RTOL)
    _assert_tree_close(pp, rp)
    _assert_tree_close(po, ro)


def test_topk_cohort_matches_reference():
    """``topk:0.1`` round-trips every slot (no error feedback) on both
    sides; the select is exact on equal inputs, so the state stays within
    the same bound."""
    ref, port = _pair(compress="topk:0.1")
    r_step, p_step = rsim.from_strategy(ref), simulator.from_strategy(port)
    assert p_step.codec.spec() == r_step.codec.spec() == "topk:0.1"
    rng = np.random.default_rng(1)
    rp, ro, pp, po = ref.params, ref.opt_state, port.params, port.opt_state
    gen = torch.Generator().manual_seed(0)
    for t in range(ROUNDS):
        r_batch, p_batch = _cohort(rng)
        rp, ro, r_stats = r_step(rp, ro, r_batch, jnp.ones(K),
                                 key=jax.random.PRNGKey(t))
        pp, po, p_stats = p_step(pp, po, p_batch, torch.ones(K), gen)
        np.testing.assert_allclose(float(p_stats["loss"]),
                                   float(r_stats["loss"]), rtol=LOSS_RTOL)
    _assert_tree_close(pp, rp)
    _assert_tree_close(po, ro)


def test_strategy_without_cohort_hooks_raises():
    _, port = _pair("fedavg_sgd")
    with pytest.raises(NotImplementedError, match="cohort"):
        simulator.from_strategy(port)


def test_batched_int8_equals_the_per_slot_loop():
    """The cohort's int8 round-trip (every slot's leaves in one call)
    draws its uniforms in slot order: bit for bit the per-slot
    ``compress_payload`` loop from the same generator state."""
    _, port = _pair(compress="int8")
    _, p_batch = _cohort(np.random.default_rng(2))
    grads, diags, _ = port.cohort_client_fn(port.params, p_batch)
    slots = [tree_map(lambda x, i=i: x[i], (grads, diags)) for i in range(K)]
    batched = port.compress_slots(slots, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    looped = [port.compress_payload(s, gen)[0] for s in slots]
    for a, b in zip(batched, looped, strict=True):
        for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
            assert torch.equal(x, y)
    # and the whole round: the cohort step against the loop's aggregate
    step = simulator.from_strategy(port)
    params, state, _ = step(port.params, port.opt_state, p_batch,
                            torch.ones(K), torch.Generator().manual_seed(5))
    port.server_step(port.aggregate(looped, torch.ones(K)))
    for x, y in zip(tree_leaves(params), tree_leaves(port.params),
                    strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fim_mode", ["per_example", "microbatch"])
def test_cohort_diag_equals_per_slot_calls(fim_mode):
    """``cohort_per_example_diag`` (one fused Γ call for the cohort) equals
    K separate ``per_example_diag`` calls exactly; likewise the
    microbatch proxy."""
    _, port = _pair()
    _, p_batch = _cohort(np.random.default_rng(3))
    pel = cnn.per_example_loss_fn(reduced(FMNIST_CNN))
    params = port.params
    if fim_mode == "per_example":
        got = fim.cohort_per_example_diag(pel, params, p_batch["x"],
                                          p_batch["y"])
        want = [fim.per_example_diag(pel, params, p_batch["x"][i],
                                     p_batch["y"][i]) for i in range(K)]
    else:
        grads, _, _ = port.cohort_client_fn(params, p_batch)
        got = fim.cohort_microbatch_diag(grads)
        want = [fim.microbatch_diag(tree_map(lambda g, i=i: g[i], grads))
                for i in range(K)]
    for i in range(K):
        for x, y in zip(tree_leaves(got), tree_leaves(want[i]), strict=True):
            assert torch.equal(x[i], y)


# ------------------------------------------- mirrors of the reference's tests
def _edge_pair(cfg_kw, n=8):
    ref = REdgeRuntime(REdgeConfig(**cfg_kw(RChannelConfig, RDeviceConfig,
                                            REdgeConfig)), n)
    port = EdgeRuntime(EdgeConfig(**cfg_kw(ChannelConfig, DeviceConfig,
                                           EdgeConfig)), n)
    return ref, port


EDGE_KEYS = ("wall_s", "sim_time_s", "energy_j", "dropped", "barrier_s")


def _edge_stats(stats):
    return {k: stats.get(k) for k in EDGE_KEYS}


def test_from_strategy_threads_codec():
    """tests/test_codecs.py's threads-codec case: given a generator the
    step compresses (the update moves), without one it runs uncompressed."""
    _, port = _pair(compress="topk:0.1")
    _, p_batch = _cohort(np.random.default_rng(0), k=4, b=32)
    step = simulator.from_strategy(port)
    p1, _, stats = step(port.params, port.opt_state, p_batch, torch.ones(4),
                        generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(stats["loss"]))
    p2, _, stats2 = step(port.params, port.opt_state, p_batch, torch.ones(4))
    assert np.isfinite(float(stats2["loss"]))
    assert max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(p1), tree_leaves(p2), strict=True)) > 0


def test_with_edge_costs_codec_wire_bytes_like_the_reference():
    """tests/test_codecs.py's wire-bytes case on both sides: the int8 round
    is cheaper, the stats equal the reference's exactly, and both
    refusals hold (a compressing step without its generator; a billed
    codec other than the one the step round-trips)."""
    rng = np.random.default_rng(0)
    r_batch, p_batch = _cohort(rng, k=4, b=32)
    walls = {}
    for spec in ("none", "int8"):
        ref, port = _pair(compress=spec, learning_rate=0.05)
        r_step = rsim.from_strategy(ref)
        p_step = simulator.from_strategy(port)
        assert p_step.codec.spec() == spec

        def cfg(ch, dv, ec):
            return dict(channel=ch(bandwidth_hz=2e5, fading="none",
                                   snr_db_std=0.0),
                        device=dv(flops_per_s_mean=2e9, flops_per_s_sigma=0.0))

        r_edge, p_edge = _edge_pair(cfg)
        r_estep = rsim.with_edge(r_step, r_edge, ref.n_params())
        p_estep = simulator.with_edge(p_step, p_edge, port.n_params())
        _, _, r_stats = r_estep(ref.params, ref.opt_state, r_batch,
                                jnp.ones(4), key=jax.random.PRNGKey(1))
        _, _, p_stats = p_estep(port.params, port.opt_state, p_batch,
                                torch.ones(4),
                                generator=torch.Generator().manual_seed(1))
        assert _edge_stats(p_stats) == _edge_stats(r_stats)
        walls[spec] = p_stats["wall_s"]
    assert walls["int8"] < walls["none"]
    with pytest.raises(ValueError, match="bills compressed"):
        p_estep(port.params, port.opt_state, p_batch, torch.ones(4))
    with pytest.raises(ValueError, match="round-trips"):
        simulator.with_edge(p_step, p_edge, port.n_params(),
                            compress="topk:0.1")


def test_with_edge_masks_dropped_slots_like_the_reference():
    """tests/test_deadline_enforcement.py's masking case on both sides: the
    same drops and stats, exactly; the barrier within the cut; a dropped
    slot's weight zeroed (the step equals the unmasked step on the
    survivors' weights)."""
    ref, port = _pair()

    def cfg(ch, dv, ec):
        return dict(channel=ch(**UPLINK), device=dv(**HETERO),
                    enforce_deadline_s=2.0)

    r_edge, p_edge = _edge_pair(cfg)
    r_estep = rsim.with_edge(rsim.from_strategy(ref), r_edge, ref.n_params())
    p_step = simulator.from_strategy(port)
    p_estep = simulator.with_edge(p_step, p_edge, port.n_params())
    rng = np.random.default_rng(0)
    r_batch, p_batch = _cohort(rng, k=6, b=32)
    _, _, r_stats = r_estep(ref.params, ref.opt_state, r_batch, jnp.ones(6),
                            clients=np.arange(6))
    new_params, _, p_stats = p_estep(port.params, port.opt_state, p_batch,
                                     torch.ones(6), clients=np.arange(6))
    assert _edge_stats(p_stats) == _edge_stats(r_stats)
    p_dec, r_dec = p_edge.decisions[-1], r_edge.decisions[-1]
    assert sorted(p_dec.dropped) == sorted(r_dec.dropped)
    assert p_stats["barrier_s"] <= 2.0 + 1e-6
    assert p_stats["dropped"] == len(p_dec.dropped) > 0
    mask = torch.tensor([float(i not in p_dec.dropped) for i in range(6)])
    if mask.any():
        want, _, _ = p_step(port.params, port.opt_state, p_batch, mask)
    else:
        want = port.params
    for x, y in zip(tree_leaves(new_params), tree_leaves(want), strict=True):
        assert torch.equal(x, y)


def test_with_edge_refuses_per_client_codecs():
    """tests/test_allocation.py's refusal: adaptive_codec's per-client
    wire formats are refused by the cohort path."""
    _, port = _pair()

    def cfg(ch, dv, ec):
        return dict(channel=ch(**UPLINK), device=dv(**HETERO),
                    scheduler="adaptive_codec")

    _, p_edge = _edge_pair(cfg)
    estep = simulator.with_edge(simulator.from_strategy(port), p_edge,
                                port.n_params())
    _, p_batch = _cohort(np.random.default_rng(0), k=4, b=32)
    with pytest.raises(ValueError, match="per-client upload codecs"):
        estep(port.params, port.opt_state, p_batch, torch.ones(4),
              clients=np.arange(4))
