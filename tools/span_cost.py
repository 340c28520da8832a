#!/usr/bin/env python3
"""What the train step's spans cost with tracing on: one benchmark cell's
closed loop of steps (``feel_bench``'s entry: set-up, weights from the
seed, one step in flight) timed in windows that alternate between the step
built as the benchmark builds it (``NULL_TRACER``) and the same step built
with ``obs.Tracer(wall=True)`` (profiler ranges and event pairs, no
profiler running), on the same parameters and state.

    python3 tools/span_cost.py --workload granite_train.s512 --seed 7 \\
        --seconds 10 --pairs 3

Prints the card's name and power limit, then one JSON row a window (its
tracing, steps, seconds, tokens/s) and last the median tokens/s of each side
and their ratio.  Each traced window ends by resolving its event pairs
(after the window's own synchronise) and dropping its spans.  Needs a CUDA
card (``--device cpu`` rehearses it at the harness's smoke size: its
numbers mean nothing).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "feel_bench"), str(ROOT / "src")]

import torch  # noqa: E402

from harness import manifest  # noqa: E402
from harness.program_spans import traced_step  # noqa: E402


def window(entry, seconds: float) -> tuple[int, float]:
    """Steps completed and seconds of a closed loop of ``seconds``."""
    entry.finish()
    t0 = time.perf_counter()
    units = 0
    while time.perf_counter() - t0 < seconds:
        entry.run_unit()
        units += 1
    entry.finish()
    return units, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT), help="checkout whose BENCHMARK.json "
                    "and data files to read (the code is this one's)")
    args = ap.parse_args(argv)
    from repro_torch import obs

    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    torch.set_num_threads(1)
    root = Path(args.root)
    cell = manifest.Cell(manifest.load(root), args.workload, root)
    entry = cell.entry_class()(cell.config, cell.traffic, args.seed, device)
    entry.setup()
    plain = entry.step_fn
    tracer = obs.Tracer(wall=True)
    traced = traced_step(entry, tracer)
    entry.step_fn = traced
    entry.run_unit()                       # one traced step: nothing left to warm
    entry.finish()
    tracer.resolve_device()
    tracer.spans.clear()
    tokens = cell.traffic["batch"] * cell.traffic["seq_len"]
    rates = {"off": [], "on": []}
    for i in range(2 * args.pairs):
        side = ("off", "on")[i % 2]
        entry.step_fn = plain if side == "off" else traced
        units, s = window(entry, args.seconds)
        if side == "on":
            tracer.resolve_device()
            tracer.spans.clear()
        rates[side].append(units * tokens / s)
        print(json.dumps({"tracing": side, "steps": units, "seconds": s,
                          "tokens_per_s": rates[side][-1]}), flush=True)
    off, on = (statistics.median(rates[k]) for k in ("off", "on"))
    print(json.dumps({"workload": args.workload, "median_off": off, "median_on": on,
                      "on_over_off": on / off}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
