"""Readings that set a cell's limits (not part of a benchmark run).

    python3 feel_bench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 [--out FILE]
    python3 feel_bench/calibrate.py --workload <cell> --limits FILE [FILE ...]

For each seed, in one process: the program's set-up and its readings
against the f32 reference's (the lower readings: ``harness/compare.py``'s
two stages); on the first ``--control-seeds`` seeds also the control (the
reference one precision below the configuration's: fp8 for bfloat16) and
the faults planted in the reference put in the program's place (half of
the batch left out, the first step of the leaf it moves most doubled, a
full history that keeps its oldest pair), each against the reference.  A state left unchanged
reads 1 on every leaf-norm number and needs no run.  Prints one JSON line
a reading.

``--limits`` reads such lines (and result lines of ``run.py``, whose
``checks`` are program readings) and prints the limits they give.  Per
number: the lower reading is the largest of the program's; the upper the
least of the control's smallest, where that is 3 x the lower or more, of
each fault's smallest, where that is 10 x the lower or more, and of the
unchanged state's 1, where that is 3 x the lower or more (the ring fault
is read, not counted); the limit lower^(1/3) upper^(2/3), two significant
figures, rounded down; none (printed, not compared) where there is no
upper reading.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CONTROL = {"bfloat16": "fp8"}
FAULTS = ("half_batch", "answer", "ring")
COUNTED = ("half_batch", "answer")           # the contract's faults of one chip
UNCHANGED_READS_1 = ("step1_gap", "fisher1_gap", "change_gap", "wrap_gap")


def _round_down(x: float) -> float:
    e = math.floor(math.log10(x)) - 1
    return float(f"{math.floor(x / 10 ** e)}e{e}")


def limits_from(rows: list[dict], names) -> tuple[dict, dict]:
    """-> (limits, the readings each was set from)."""
    limits, basis = {}, {}
    for k in names:
        side = {}
        for r in rows:
            side.setdefault(r["side"], []).append(r["numbers"][k])
        lower = max(side["program"])
        uppers = {}
        if min(side.get("control", [0.0])) >= 3 * lower:
            uppers["control"] = min(side["control"])
        for f in COUNTED:
            if f in side and min(side[f]) >= 10 * lower:
                uppers[f] = min(side[f])
        if k in UNCHANGED_READS_1 and 1.0 >= 3 * lower:
            uppers["unchanged"] = 1.0
        upper = min(uppers.values()) if uppers else None
        limits[k] = (None if upper is None else
                     _round_down(lower ** (1 / 3) * upper ** (2 / 3)))
        basis[k] = {"lower": lower, "upper": upper,
                    "upper_from": min(uppers, key=uppers.get) if uppers else None,
                    "n_program": len(side["program"]),
                    **{s: min(v) for s, v in side.items() if s != "program"}}
    return limits, basis


def _rows(paths: list[str], cell: str) -> list[dict]:
    rows = []
    for p in paths:
        for line in Path(p).read_text().splitlines():
            if not line.startswith("{"):
                continue
            r = json.loads(line)
            if "checks" in r:
                rows.append({"side": "program",
                             "numbers": {k: v["value"] for k, v in r["checks"].items()}})
            elif r.get("cell") == cell:
                rows.append(r)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_200_000_001)
    ap.add_argument("--out", default=None)
    ap.add_argument("--limits", nargs="+", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    from harness import compare

    if args.limits:
        limits, basis = limits_from(_rows(args.limits, args.workload), compare.NAMES)
        print(json.dumps(limits))
        print(json.dumps(basis, indent=1))
        return 0

    import torch

    from harness import manifest

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = manifest.Cell(manifest.load(ROOT), args.workload, ROOT)
    control = CONTROL[cell.config["torch_dtype"]]
    out = open(args.out, "a") if args.out else sys.stdout

    def emit(**row):
        print(json.dumps({"cell": args.workload, **row}), file=out, flush=True)

    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        entry = cell.entry_class()(cell.config, cell.traffic, seed, device)
        entry.setup()
        entry.follow()
        prog = entry.readings
        entry.release()
        sides = [("program", {})]
        if i < args.control_seeds:
            sides += [("control", {"precision": control})]
            sides += [(f, {"fault": f}) for f in FAULTS]
        wraps = {side: entry.reference_wrap(**kw) for side, kw in sides}
        entry.drop_snapshot()
        ref = {**entry.reference_seed(), "wrap": wraps["program"]}
        emit(seed=seed, side="program", numbers=compare.numbers(prog, ref),
             seconds=time.perf_counter() - t0)
        for side, kw in sides[1:]:
            t1 = time.perf_counter()
            other = {**entry.reference_seed(**kw), "wrap": wraps[side]}
            emit(seed=seed, side=side, numbers=compare.numbers(other, ref),
                 seconds=time.perf_counter() - t1)
        del entry
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
