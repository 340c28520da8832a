"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 feel_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (inputs and weights from the seed, every shape warmed up),
measures a closed loop for ``--seconds`` (``--trace 0``: the end-to-end
metrics) or runs the traced window (``--trace 1``: the per-layer metrics),
checks the first steps against the plain reference, and prints one JSON
line.  Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "feel_bench"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import torch

    from harness import manifest, runner

    cell = manifest.Cell(manifest.load(ROOT), args.workload, ROOT)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)      # one host thread: no idle pool spinning
    runner.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), T_START, ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
