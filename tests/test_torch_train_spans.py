"""The LLM train step's spans (``make_train_step(..., tracer=)``): a traced
step computes what the untraced one does, bit for bit; its spans nest as
``launch/train.py`` names them; the default ``NULL_TRACER`` enters no
profiler range and makes no event; and on the card the spans add no host
sync and resolve to device time.

The CPU tests run the granite smoke config in f32 on 4 x 32 tokens.  The
card test is marked ``cuda`` and skips without a CUDA device.  This file
imports neither JAX nor the reference.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import obs  # noqa: E402
from repro_torch.configs import granite_8b  # noqa: E402
from repro_torch.data.synthetic import zipf_tokens  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

N_MICRO = 2
SERVER = ["server.fim_ema", "server.gram", "server.two_loop", "server.combine",
          "server.step", "server.smooth_y", "server.curvature", "server.push"]
COHORT = ["train.forward", "train.backward", "train.accumulate"]


def _setup(optimizer="fim_lbfgs", device="cpu", steps=3):
    cfg = granite_8b.smoke_config()
    ocfg = train.opt_config(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt = train.init_train_state(cfg, ocfg, gen, optimizer, device=device)
    toks = torch.from_numpy(zipf_tokens(4 * steps, 32, cfg.vocab_size, seed=3))
    batches = [{"tokens": toks[4 * t:4 * t + 4].to(device)} for t in range(steps)]
    return cfg, ocfg, params, opt, batches


def _run(step, params, opt, batches):
    stats = []
    for b in batches:
        params, opt, st = step(params, opt, b)
        stats.append(st)
    return params, opt, stats


def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("optimizer", ["fim_lbfgs", "fedavg_adam", "fedavg_sgd"])
def test_traced_step_is_bit_identical_to_the_untraced(optimizer):
    cfg, ocfg, params, opt, batches = _setup(optimizer)
    want = _run(train.make_train_step(cfg, ocfg, N_MICRO, optimizer),
                params, opt, batches)
    cfg, ocfg, params, opt, batches = _setup(optimizer)     # the same draws
    tracer = obs.Tracer(wall=True)
    got = _run(train.make_train_step(cfg, ocfg, N_MICRO, optimizer, tracer=tracer),
               params, opt, batches)
    for w, g in zip(want, got):
        assert _same(w, g)
    assert tracer.step == len(batches) - 1
    assert sum(s.name == "train.step" for s in tracer.spans) == len(batches)


def _tree(spans):
    """[(name, parent, depth)] in start order, each span's parent found by
    containment of host intervals (and checked against its ``parent``)."""
    out, stack = [], []
    for s in sorted(spans, key=lambda s: (s.t0, -s.t1)):
        while stack and not (stack[-1].t0 <= s.t0 and s.t1 <= stack[-1].t1):
            stack.pop()
        parent = stack[-1].name if stack else None
        assert s.args.get("parent") == parent, (s.name, s.args, parent)
        out.append((s.name, parent, len(stack)))
        stack.append(s)
    return out


def test_traced_step_span_tree():
    """Names, nesting and order of one step's spans: ``train.step`` around
    ``nm`` cohorts (forward, backward, accumulate), the means and the server
    step with its eight parts; every span carries the tracer's host step
    counter, which starts at 0 whatever ``state.step`` says."""
    cfg, ocfg, params, opt, batches = _setup(steps=3)
    params, opt, _ = train.make_train_step(cfg, ocfg, N_MICRO)(params, opt,
                                                               batches[0])
    tracer = obs.Tracer(wall=True)
    step = train.make_train_step(cfg, ocfg, N_MICRO, tracer=tracer)
    params, opt, _ = _run(step, params, opt, batches[1:])
    assert int(opt.step) == 3
    want = [("train.step", None, 0)]
    for _ in range(N_MICRO):
        want.append(("train.cohort", "train.step", 1))
        want += [(n, "train.cohort", 2) for n in COHORT]
    want += [("train.means", "train.step", 1), ("server", "train.step", 1)]
    want += [(n, "server", 2) for n in SERVER]
    for k in (0, 1):
        spans = [s for s in tracer.spans if s.round_id == k]
        assert _tree(spans) == want
        cohorts = sorted((s.t0, s.args["cohort"]) for s in spans
                         if s.name == "train.cohort")
        assert [c for _, c in cohorts] == list(range(N_MICRO))
        assert all(s.cat == obs.CAT_WALL and s.dur >= 0 for s in spans)
        # on the CPU no event pair: nothing to resolve
        assert not any("device_s" in s.args for s in spans)
    assert tracer.resolve_device() == 0
    # wall spans stay out of the determinism exports by default
    assert "train.step" not in obs.to_jsonl(tracer)
    assert obs.to_jsonl(tracer, include_wall=True).count('"name": "train.step"') == 2


def test_null_tracer_enters_no_profiler_range(monkeypatch):
    """With the default tracer (and a ``Tracer`` without ``wall``) a step
    runs with ``record_function`` and ``torch.cuda.Event`` made to raise:
    each span is the one shared null context."""
    cfg, ocfg, params, opt, batches = _setup(steps=1)

    def boom(*args, **kwargs):
        raise AssertionError("a disabled span reached the profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    for tracer in (None, obs.NULL_TRACER, obs.Tracer()):
        _, opt, st = train.make_train_step(cfg, ocfg, N_MICRO, tracer=tracer)(
            params, opt, batches[0])
        assert torch.isfinite(st["loss"])
    null = obs.NULL_TRACER.wall_span("train.step", round_id=0)
    assert null is obs.NULL_TRACER.wall_span("server", round_id=1, cohort=2)
    assert null is obs.Tracer().wall_span("server")
    with pytest.raises(AssertionError):
        with obs.Tracer(wall=True).wall_span("server"):
            pass


def test_wall_span_inherits_its_device_and_names_its_parent():
    tracer = obs.Tracer(wall=True)
    with tracer.wall_span("outer", round_id=tracer.next_step(), device="cpu"):
        with tracer.wall_span("inner", round_id=tracer.step, cohort=1):
            pass
    with tracer.wall_span("alone"):
        pass
    inner, outer, alone = tracer.spans
    assert (inner.name, inner.args, inner.round_id) == (
        "inner", {"parent": "outer", "cohort": 1}, 0)
    assert outer.args == {} and alone.args == {} and alone.round_id == -1
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1


@pytest.mark.cuda
def test_traced_step_adds_no_host_sync_on_the_card():
    """One traced step at smoke width on the card under
    ``set_sync_debug_mode("error")`` (the untraced step beside it, as the
    control), then each span's event pair resolved after a synchronise:
    every span has a positive device time, and the server's parts sum to
    no more than the server span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the event pairs time the card")
    cuda = torch.device("cuda")
    cfg, ocfg, params, opt, batches = _setup(device=cuda, steps=3)
    plain = train.make_train_step(cfg, ocfg, N_MICRO)
    tracer = obs.Tracer(wall=True)
    traced = train.make_train_step(cfg, ocfg, N_MICRO, tracer=tracer)
    params, opt, _ = plain(params, opt, batches[0])       # builds the kernels
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, opt, _ = plain(params, opt, batches[1])
        params, opt, st = traced(params, opt, batches[2])
    finally:
        torch.cuda.set_sync_debug_mode(before)
    torch.cuda.synchronize()
    assert torch.isfinite(st["loss"]).item()
    n = 1 + N_MICRO * (1 + len(COHORT)) + 2 + len(SERVER)
    assert tracer.resolve_device() == n == len(tracer.spans)
    dev = {}
    for s in tracer.spans:
        assert s.args["device_s"] > 0, s
        dev[s.name] = dev.get(s.name, 0.0) + s.args["device_s"]
    assert sum(dev[k] for k in SERVER) <= dev["server"] <= dev["train.step"]
