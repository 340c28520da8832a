#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the hand-written kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, and drives Algorithm 1
(``FederatedRun(..., "fim_lbfgs")``) at the full width of the paper's
F-MNIST CNN through the kernels.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device: the card's name and power limit, then the kernel build;
  2. each kernel against its plain version at the main path's shapes,
     with CUDA-event times (see ``time_ms``) beside the card's bound;
  3. the main path: 5 rounds on 60,000 synthetic F-MNIST examples, 100
     clients, 20 per round, non-IID-2, once with compress="none" and once
     with "int8"; launch counts, losses and the byte ledger are checked,
     then, for each, one more round with kernels="off" beside
     kernels="auto" from the same state, holding every part of the
     strategy's state after it; last the split of a round's time between
     the client step, the int8 round-trip and the server step;
  4. one JSON line listing every ported kernel, then the result line.

Needs CUDA: without it the script exits 2 and prints no result.  It
imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.configs.paper_models import FMNIST_CNN  # noqa: E402
from repro_torch.data.synthetic import make_classification  # noqa: E402
from repro_torch.fed import codecs  # noqa: E402
from repro_torch.fed.server import FederatedRun  # noqa: E402
from repro_torch.kernels import (_build, codec_ops, fim_diag, ops, ref,  # noqa: E402
                                 vlbfgs)
from repro_torch.models import cnn  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

# launch counters of the kernel wrappers, by kernel name
COUNTERS = {"fim_diag": fim_diag, "vlbfgs_gram": vlbfgs,
            "int8_roundtrip": codec_ops}

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the f32 rate outside the
# tensor cores (the kernels use plain f32 FMAs); rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# main-path configuration (F-MNIST's own split sizes)
N_TRAIN, N_TEST = 60_000, 10_000
RUN = dict(num_clients=100, participation=0.2, noniid_l=2, rounds=5, seed=0)
ROUNDS = RUN["rounds"]
COHORT = int(RUN["participation"] * RUN["num_clients"])

# tolerances, kernel vs plain version on the same inputs:
#   fim_diag: both accumulate in f32 but in other orders -> 1e-5 rel/abs
#   gram: the same, relative to the largest Gram entry -> 1e-5
#   int8: every step correctly rounded on both paths -> bit-identical
FIM_TOL = 1e-5
GRAM_TOL = 1e-5
# one round with kernels="off" vs "auto" from the same state, each part of
# the strategy's state held as ||auto - off|| / ||off||:
#   Fisher diagonal: per-client means of g^2 summed in other orders, then
#   the same cohort mean and EMA -> 1e-5
#   params and history s, y: the Gram matrix sums in other orders and the
#   two-loop divides by curvature products of those sums -> 1e-3
#   under int8 every part: a one-ulp difference in a client's Fisher or
#   gradient can move its stochastic rounding by one level, max|x|/127, i.e.
#   at most 1/127 of that leaf's norm and 1/20 of it after the cohort mean;
#   a few such flips per round stay below 2e-3
FISHER_TOL = 1e-5
STEP_TOL = 1e-3
INT8_STATE_TOL = 2e-3
# GPU spin that hides the host's enqueue cost while timing (~10 ms at the
# H100's ~2 GHz SM clock)
SLEEP_CYCLES = 20_000_000


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, reps: int = 21, per: int = 10,
            warmup: int = 3) -> tuple[float, float]:
    """-> (device ms, call ms) of one call of ``fn``, medians over ``reps``.

    Device ms: ``per`` calls queued behind a ~10 ms ``torch.cuda._sleep``,
    timed by CUDA events around them and divided by ``per``; the host
    enqueues them while the device spins, so its launch cost is hidden.
    Call ms: one call timed by CUDA events from an idle device, which
    includes the host's cost of issuing it (what a caller that waits on
    each call sees)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    device, call = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / per)
        start.record()
        fn()
        end.record()
        end.synchronize()
        call.append(start.elapsed_time(end))
    return statistics.median(device), statistics.median(call)


def timings(kernel, plain, library=None) -> dict:
    k_ms, k_call = time_ms(kernel)
    p_ms, p_call = time_ms(plain)
    return {"kernel_ms": k_ms, "kernel_call_ms": k_call, "plain_ms": p_ms,
            "plain_call_ms": p_call,
            "library_ms": None if library is None else time_ms(library)[0]}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_fim_diag(dev, B, D, dtype):
    gen = torch.Generator(device=dev).manual_seed(B * 7 + D)
    g = torch.randn((B, D), generator=gen, device=dev).to(dtype)
    old = torch.zeros((D,), device=dev)   # the main path's old=0, ema=0
    got = ops.fim_diag_update(g, old, 0.0, mode="on")
    want = ref.fim_diag_ref(g, old, 0.0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=FIM_TOL, atol=FIM_TOL))
    elt = g.element_size()
    b_ms, by = bound_ms(B * D * elt + 2 * D * 4, 2.0 * B * D + 3.0 * D)
    row = {"kernel": "fim_diag", "shape": [B, D], "dtype": str(dtype)[6:],
           "max_err": err, "tol": FIM_TOL,
           **timings(lambda: ops.fim_diag_update(g, old, 0.0, mode="on"),
                     lambda: ref.fim_diag_ref(g, old, 0.0)),
           "bound_ms": b_ms, "bound_by": by}
    emit(row)
    require(ok, f"fim_diag {B}x{D} {dtype}: max err {err} > {FIM_TOL}")
    return row


def check_gram(dev, n, D):
    gen = torch.Generator(device=dev).manual_seed(n * 13 + D)
    basis = torch.randn((n, D), generator=gen, device=dev)
    got = ops.vlbfgs_gram(basis, mode="on")
    want = ref.vlbfgs_gram_ref(basis)
    torch.cuda.synchronize()
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    b_ms, by = bound_ms(n * D * 4 + n * n * 4, 2.0 * D * n * (n + 1) / 2)
    row = {"kernel": "vlbfgs_gram", "shape": [n, D], "dtype": "float32",
           "max_err": err, "rel_err": err / scale, "tol": GRAM_TOL,
           **timings(lambda: ops.vlbfgs_gram(basis, mode="on"),
                     lambda: ref.vlbfgs_gram_ref(basis),
                     lambda: torch.matmul(basis, basis.T)),
           "bound_ms": b_ms, "bound_by": by}
    emit(row)
    require(err / scale <= GRAM_TOL,
            f"vlbfgs_gram {n}x{D}: relative err {err / scale} > {GRAM_TOL}")
    require(bool(torch.equal(got, got.T)), "vlbfgs_gram: not symmetric")
    return row


def check_int8(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=dev) * 0.05
    u = torch.rand(shape, generator=gen, device=dev)
    s = ref.int8_scale(x)
    amax = float(x.abs().max())
    require(float(s) == float(np.float32(amax) / np.float32(127)),
            f"int8_scale on the card is not the correctly rounded "
            f"max/127 for {shape}")
    got = codec_ops.int8_roundtrip(x, u, s)
    want = ref.int8_roundtrip_ref(x, u, s)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    n = x.numel()
    b_ms, by = bound_ms(12.0 * n + 4, 8.0 * n)
    row = {"kernel": "int8_roundtrip", "shape": list(shape), "dtype": "float32",
           "max_err": err, "tol": 0.0,
           **timings(lambda: codec_ops.int8_roundtrip(x, u, s),
                     lambda: ref.int8_roundtrip_ref(x, u, s)),
           "bound_ms": b_ms, "bound_by": by}
    emit(row)
    require(bool(torch.equal(got.view(torch.int32), want.view(torch.int32))),
            f"int8_roundtrip {shape}: not bit-identical (max err {err})")
    return row


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def expected_ledger(plan, rounds: int, cohort: int) -> dict:
    """CommLedger.summary() the plan predicts, accumulated with the
    ledger's own float operations."""
    down = up_star = up_tree = scal = 0.0
    depth = max(1, math.ceil(math.log2(max(cohort, 2))))
    for _ in range(rounds):
        for ph in plan.phases:
            down += ph.down_floats * 4 * cohort
            up_star += ph.wire_up_bytes() * cohort
            up_tree += ph.wire_up_bytes() * depth
        scal += plan.round_scalars * 4
    return {"rounds": rounds, "down_MB_per_round": down / rounds / 1e6,
            "up_star_MB_per_round": up_star / rounds / 1e6,
            "up_tree_MB_per_round": up_tree / rounds / 1e6,
            "scalar_KB_per_round": scal / rounds / 1e3}


def main_path(train, test, compress: str):
    for c in COUNTERS.values():
        c.LAUNCHES = 0
    t0 = time.perf_counter()
    run = FederatedRun(FMNIST_CNN, FedConfig(compress=compress, **RUN), train,
                       test, "fim_lbfgs", device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    history, round_s = [], []
    for t in range(ROUNDS):
        t0 = time.perf_counter()
        info = run.round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        info["round"] = t + 1
        history.append(info)
    acc = run.evaluate()
    launches = {name: c.LAUNCHES for name, c in COUNTERS.items()}
    losses = [h["loss"] for h in history]
    n_leaves = len(tree_leaves(run.params))
    emit({"phase": "main_path", "compress": compress,
          "d": run.strategy.n_params(), "leaves": n_leaves,
          "cohorts": [h["cohort"] for h in history], "losses": losses,
          "accuracy": acc, "setup_s": setup_s, "round_s": round_s,
          "launches": launches, "ledger": run.ledger.summary()})
    require(all(math.isfinite(v) for v in losses), f"{compress}: loss not finite")
    require(losses[-1] < losses[0],
            f"{compress}: last loss {losses[-1]} not below first {losses[0]}")
    require(0.0 <= acc <= 1.0, f"{compress}: accuracy {acc}")
    require(all(h["cohort"] == COHORT for h in history), "cohort size")
    want = {"fim_diag": n_leaves * COHORT * ROUNDS, "vlbfgs_gram": ROUNDS,
            "int8_roundtrip": (2 * n_leaves * COHORT * ROUNDS
                               if compress == "int8" else 0)}
    require(launches == want, f"{compress}: launches {launches} != {want}")
    ledger, plan_ledger = run.ledger.summary(), expected_ledger(run.plan, ROUNDS,
                                                                COHORT)
    require(ledger == plan_ledger,
            f"{compress}: ledger {ledger} != plan {plan_ledger}")
    return run, launches


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])


def kernels_off_beside_auto(run_auto, train, test, compress: str):
    """One more round from the auto run's state, on a kernels="off" run
    with the same state, sampling stream and codec stream.  The off round
    launches no kernel; afterwards every part of the strategy's state
    agrees: params, the Fisher diagonal (this round's fim_diag output) and
    the history pairs (this round's Gram and, under int8, the codec)."""
    run_off = FederatedRun(FMNIST_CNN,
                           FedConfig(compress=compress, kernels="off", **RUN),
                           train, test, "fim_lbfgs", device="cuda")
    run_off.strategy.load_state_dict(run_auto.strategy.state_dict())
    run_off.rng.bit_generator.state = run_auto.rng.bit_generator.state
    run_off.codec_generator.set_state(run_auto.codec_generator.get_state())
    start = _flat(run_auto.params).clone()
    run_auto.round()
    for c in COUNTERS.values():
        c.LAUNCHES = 0
    run_off.round()
    torch.cuda.synchronize()
    off_launches = {name: c.LAUNCHES for name, c in COUNTERS.items()}
    require(not any(off_launches.values()),
            f"{compress}: kernels='off' launched {off_launches}")

    a, b = run_auto.strategy.opt_state, run_off.strategy.opt_state
    parts = {"params": (run_auto.params, run_off.params, STEP_TOL),
             "fim_diag": (a.fim.diag, b.fim.diag, FISHER_TOL),
             "history_s": (a.history.s, b.history.s, STEP_TOL),
             "history_y": (a.history.y, b.history.y, STEP_TOL)}
    rel, tol = {}, {}
    for name, (x, y, t) in parts.items():
        fx, fy = _flat(x), _flat(y)
        rel[name] = float((fx - fy).norm()) / max(float(fy.norm()), 1e-30)
        tol[name] = INT8_STATE_TOL if compress == "int8" else t
    counters = {name: (int(x), int(y)) for name, (x, y) in {
        "history_idx": (a.history.idx, b.history.idx),
        "history_count": (a.history.count, b.history.count),
        "fim_steps": (a.fim.steps, b.fim.steps),
        "step": (a.step, b.step)}.items()}
    step = float((_flat(run_off.params) - start).norm())
    emit({"phase": "kernels_off_vs_auto", "compress": compress,
          "step_norm": step, "rel": rel, "tol": tol, "counters": counters})
    require(step > 0, f"{compress}: kernels='off' round took no step")
    for name, r in rel.items():
        require(r <= tol[name], f"{compress}: kernels='off' vs 'auto': "
                f"{name} differs by {r} > {tol[name]} (relative)")
    for name, (x, y) in counters.items():
        require(x == y, f"{compress}: kernels='off' vs 'auto': {name} "
                f"{x} != {y}")


def round_breakdown(run) -> None:
    """Where a round's time goes: one client step (gradient + per-example
    Fisher), one int8 payload round-trip and one aggregate + server step,
    each the median of 3 synchronised host-clock timings."""
    sizes = [len(p) for p in run.partition]
    k = max(range(len(sizes)), key=sizes.__getitem__)
    data = run._client_data(k)
    int8 = codecs.make("int8")
    gen = torch.Generator(device=run.device).manual_seed(0)

    def timed(fn, reps=3):
        out, times = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, statistics.median(times)

    (payload, _), client_s = timed(lambda: run.strategy.client_step(data, None))
    _, int8_s = timed(lambda: int8.roundtrip(payload, gen))
    weights = torch.full((COHORT,), float(sizes[k]), device=run.device)
    snapshot = run.strategy.state_dict()

    def server():
        run.strategy.load_state_dict(snapshot)
        run.strategy.server_step(run.strategy.aggregate([payload] * COHORT,
                                                        weights))

    _, server_s = timed(server)
    emit({"phase": "round_breakdown", "client_examples": sizes[k],
          "client_step_s": client_s, "int8_payload_s": int8_s,
          "aggregate_server_step_s": server_s,
          "round_estimate_s": COHORT * client_s + server_s})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2

    # phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    # f32 everywhere: cuDNN would run f32 convolutions in TF32 by default
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # phase 2: kernels against their plain versions at the main path's shapes
    leaf_shapes = [tuple(p.shape) for p in
                   tree_leaves(cnn.init(FMNIST_CNN, torch.Generator().manual_seed(0)))]
    # a client of ~600 examples: one (600, D) call per leaf, fc0.w first
    leaf_sizes = sorted({math.prod(s) for s in leaf_shapes}, reverse=True)
    fim_rows = [check_fim_diag(dev, 600, D, torch.float32)
                for D in leaf_sizes]
    fim_rows.append(check_fim_diag(dev, 257, 2049, torch.bfloat16))
    gram_rows = [check_gram(dev, 21, 206_922),
                 check_gram(dev, 21, 10_001)]
    int8_rows = [check_int8(dev, s) for s in leaf_shapes]

    # phase 3: the main path, with launch counts from these runs only
    train, test = make_classification(FMNIST_CNN, n_train=N_TRAIN,
                                      n_test=N_TEST, seed=0)
    run_none, launches_none = main_path(train, test, "none")
    run_int8, launches_int8 = main_path(train, test, "int8")
    total = {k: launches_none[k] + launches_int8[k] for k in COUNTERS}
    kernels_off_beside_auto(run_none, train, test, "none")
    kernels_off_beside_auto(run_int8, train, test, "int8")
    del run_int8
    round_breakdown(run_none)

    # phase 4: the kernels line, then the result line
    def entry(name, source, replaces, rows, launches):
        main = rows[0]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_err"] for r in rows),
                "shape": main["shape"], "ms": main["kernel_ms"],
                "call_ms": main["kernel_call_ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"]}

    int8_tree = {"shape": [list(s) for s in leaf_shapes],
                 "kernel_ms": sum(r["kernel_ms"] for r in int8_rows),
                 "kernel_call_ms": sum(r["kernel_call_ms"] for r in int8_rows),
                 "plain_ms": sum(r["plain_ms"] for r in int8_rows),
                 "bound_ms": sum(r["bound_ms"] for r in int8_rows),
                 "bound_by": "bytes", "library_ms": None,
                 "max_err": max(r["max_err"] for r in int8_rows)}
    emit({"kernels": [
        entry("fim_diag", "src/repro_torch/csrc/fim_diag.cu",
              "src/repro/kernels/fim_diag.py:40", fim_rows, total["fim_diag"]),
        entry("vlbfgs_gram", "src/repro_torch/csrc/vlbfgs.cu",
              "src/repro/kernels/vlbfgs.py:40", gram_rows, total["vlbfgs_gram"]),
        entry("int8_roundtrip", "src/repro_torch/csrc/codec_ops.cu",
              "src/repro/kernels/codec_ops.py:69", [int8_tree],
              total["int8_roundtrip"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
