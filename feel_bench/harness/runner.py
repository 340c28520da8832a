"""One run of one cell: set-up, the measured window (or the traced run),
the comparison with the reference, and the result line.

``run.py`` checks for the card and calls :func:`run_cell`; the harness's
tests call it on the CPU at a smoke size.
"""
from __future__ import annotations

import json
import math
import sys
import time
from types import SimpleNamespace

import torch

from harness import compare, manifest
from harness.trace import WINDOW, Spans, reduce_profile

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _measure(entry, seconds: float, err) -> tuple[int, float]:
    """Closed loop of the entry's units for ``seconds``: -> (units, seconds
    from the first unit's start to the last one's end on the device).  The
    host seconds between unit calls go to stderr as quartiles."""
    stamps = [time.perf_counter()]
    while True:
        entry.run_unit()
        stamps.append(time.perf_counter())
        if stamps[-1] - stamps[0] >= seconds:
            break
    entry.finish()
    total = time.perf_counter() - stamps[0]
    gaps = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    q = [gaps[int(f * (len(gaps) - 1))] for f in (0, 0.25, 0.5, 0.75, 1)]
    print("window unit seconds (min, quartiles, max): "
          + " ".join(f"{v:.4f}" for v in q), file=err)
    return len(gaps), total


def _traced(entry, seconds: float, profile_units: int, device) -> tuple[Spans, dict, int]:
    """Synced spans over ``seconds`` of units, then a profile of
    ``profile_units`` more with the same calls labelled."""
    spans = Spans(entry.sync)
    units = 0
    with entry.hooks(spans.timed):
        t0 = time.perf_counter()
        while True:
            spans.begin_unit()
            a = time.perf_counter()
            entry.run_unit()
            entry.finish()
            spans.end_unit(time.perf_counter() - a)
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break

    def labelled(name, fn):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapper

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with entry.hooks(labelled), torch.profiler.record_function(WINDOW):
            for _ in range(profile_units):
                entry.run_unit()
            entry.finish()
    return spans, reduce_profile(prof, entry.labels, entry.outside), units + profile_units


def _value(x: float):
    return x if math.isfinite(x) else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root=manifest.ROOT, out=sys.stdout, err=sys.stderr) -> dict:
    """Run cell ``name`` and print its result line; -> the result."""
    cell = manifest.Cell(manifest.load(root), name, root)
    entry = cell.entry_class()(cell.config, cell.traffic, seed, device)
    print(f"setup begins {time.perf_counter() - t_start:.3f} s after the "
          "process started", file=err)
    entry.setup()
    setup_s = time.perf_counter() - t_start
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ctx = SimpleNamespace(unit=entry.unit, setup_s=setup_s, spans=None, profile=None)
    if trace:
        ctx.spans, ctx.profile, attempted = _traced(
            entry, seconds, cell.traffic["profile_units"], device)
        wanted = cell.per_layer
    else:
        ctx.units, ctx.window_s = _measure(entry, seconds, err)
        attempted = ctx.units
        wanted = cell.end_to_end
    ctx.window_peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx.work = entry.work()
    metrics = {}
    for m in wanted:
        v = manifest.reader(m["name"])(ctx)
        if v is None:
            print(f"metric {m['name']}: nothing to read", file=err)
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=err)
        raise SystemExit(4)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": max(setup_peak, ctx.window_peak_bytes)}
    if trace:
        dev["busy_s"] = ctx.profile["busy_s"]
        dev["window_s"] = ctx.profile["window_s"]
    entry.follow()
    prog = entry.readings
    entry.release()
    if cuda:
        print(f"program released: {torch.cuda.memory_allocated(device)} bytes "
              "still allocated", file=err)
    nums = compare.numbers(prog, entry.reference())
    ok = compare.judge(nums, cell.limits)
    for k in compare.NAMES:
        print(f"check {k} {nums[k]!r} limit {cell.limits[k]!r}", file=err)
    result = {"correct": ok, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": ctx.profile["device_ops"],
                               "idle_gaps": ctx.profile["idle_gaps"]}
    result["checks"] = {k: {"value": _value(nums[k]), "limit": cell.limits[k]}
                        for k in compare.NAMES}
    print(json.dumps(result), file=out, flush=True)
    return result
