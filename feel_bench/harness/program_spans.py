"""The program's own spans in a traced run, and the attribution of a device
trace to them.

The train step records its spans itself when it is built with
``make_train_step(..., tracer=obs.Tracer(wall=True))``: ``train.step``;
each ``train.cohort`` with its ``train.forward``, ``train.backward`` and
``train.accumulate``; ``train.means``; ``server`` with ``server.fim_ema``,
``.gram``, ``.two_loop``, ``.combine``, ``.step``, ``.smooth_y``,
``.curvature`` and ``.push``.  Each is a host interval, a
``torch.profiler.record_function`` range and, on the card, a timing-event
pair resolved after a synchronise.

:func:`phase` runs once a traced run, after the synced spans and their
profile (whose readings it leaves as they are): the entry's step is
swapped for one built with such a tracer, driven for as long as the synced
window took (device time by span from the event pairs), then profiled for
the traffic's ``profile_units`` steps (launches, kernel seconds and idle
gaps by span), and the step put back.  The per-span table goes to stderr.
The readers of ``combine_ms``, ``two_loop_ms``, ``server_passes_ms``,
``backward_ms``, ``cohort_idle_ms`` and ``launches_per_step`` share it
through ``ctx``.  A program whose train step takes no tracer, or a run
without a card, gives them nothing to read.
"""
from __future__ import annotations

import inspect
import sys
import time
import traceback
from collections import defaultdict

import torch

from harness.trace import WINDOW

SERVER_PASSES = ("server.fim_ema", "server.step", "server.smooth_y",
                 "server.curvature", "server.push")
COHORT = ("train.cohort", "train.forward", "train.backward", "train.accumulate")
TOP = ("train.cohort", "train.means", "server")      # train.step's children
OUTSIDE = "outside"
LEAD_S = 0.1        # idle seconds in the profile before and after its window


# -- the attribution ------------------------------------------------------
def innermost(ranges, t: float):
    """The name of the shortest of ``ranges`` ((name, start_s, end_s)) that
    holds ``t``, or None."""
    inside = [(b - a, name) for name, a, b in ranges if a <= t <= b]
    return min(inside)[1] if inside else None


def device_ops(events, names):
    """-> (program ranges [(name, start_s, end_s)], window (lo, hi) or None,
    device ops [(name, start_s, end_s, launch_s or None)], launch calls
    [host start_s]) from a profile's events (the ``torch.profiler`` kineto
    events' methods).

    A launch call is a runtime or driver call (``cuda*``, ``cu*``) that
    enqueues device work (``*Launch*``, ``*Memcpy*``, ``*Memset*``).  A
    device op's launch is the host start of the call that shares its
    correlation id, else of the operator it is linked to
    (``linked_correlation_id``: the profiler's own join); the mirrors of
    ``record_function`` ranges on the device's timeline are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges, window, dev, calls, ops, launches = [], None, [], {}, {}, []
    for e in events:
        name, a = e.name(), e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        if e.device_type() == cuda:
            if not (name in names or name == WINDOW or _annotation(e)):
                dev.append((name, a, b, e.correlation_id(),
                            e.linked_correlation_id()))
            continue
        if name.startswith("cu") and "::" not in name:
            calls[e.correlation_id()] = a
            if any(k in name for k in ("Launch", "Memcpy", "Memset")):
                launches.append(a)
        elif e.linked_correlation_id() == 0:
            ops[e.correlation_id()] = a
        if name == WINDOW:
            window = (a, b)
        elif name in names:
            ranges.append((name, a, b))
    out = [(n, a, b, calls.get(corr, ops.get(linked)))
           for n, a, b, corr, linked in dev]
    return ranges, window, out, launches


def _annotation(e) -> bool:
    note = getattr(e, "is_user_annotation", None)
    return bool(note()) if note is not None else False


def attribute(ranges, ops, window, launches=()) -> dict:
    """Launches, kernel seconds and idle seconds by program span.

    ``ops`` and ``launches`` as :func:`device_ops` gives them.  Each launch
    call inside ``window`` counts for the innermost span whose host range
    holds it (``OUTSIDE`` where none does): the host's count, which the
    trace keeps whole where it may drop a device op at its start.  A device
    op launched inside the window (by its launch, or by its start where no
    launch was found: ``unlinked``) adds its seconds to the span around its
    launch.  An idle gap in the union of the ops' intervals, clipped to the
    window, goes to the innermost span at its midpoint, as
    ``reduce_profile`` labels them; an op whose device interval lies
    outside the window (the device's clock reads off the host's) is listed
    under ``stray`` and holds no busy time.  -> {"launches": {span: n},
    "kernel_s": {span: s}, "idle_s": {span: s}, "total": n, "device_ops":
    n, "unlinked": n, "stray": [(name, start, end) from lo], "busy_s": s,
    "window_s": s}."""
    lo, hi = window
    launched, kernel_s, idle_s = defaultdict(int), defaultdict(float), defaultdict(float)
    for t in launches:
        if lo <= t <= hi:
            launched[innermost(ranges, t) or OUTSIDE] += 1
    n_ops, unlinked, held, stray = 0, 0, [], []
    for name, a, b, t in ops:
        at = a if t is None else t
        if not lo <= at <= hi:
            continue
        n_ops += 1
        unlinked += t is None
        span = (innermost(ranges, t) if t is not None else None) or OUTSIDE
        kernel_s[span] += b - a
        if b <= lo or a >= hi:
            stray.append((name, a - lo, b - lo))
        else:
            held.append((max(a, lo), min(b, hi)))
    busy, end, gaps = 0.0, lo, []
    for a, b in sorted(held):
        if a > end:                     # a gap, then a new busy interval
            gaps.append((end, a))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    gaps.append((end, hi))
    for a, b in gaps:
        if b > a:
            idle_s[innermost(ranges, 0.5 * (a + b)) or OUTSIDE] += b - a
    return {"launches": dict(launched), "kernel_s": dict(kernel_s),
            "idle_s": dict(idle_s), "total": sum(launched.values()),
            "device_ops": n_ops, "unlinked": unlinked, "stray": stray,
            "busy_s": busy, "window_s": hi - lo}


# -- the phase -------------------------------------------------------------
def _entry(ctx):
    """The cell's entry behind the synced spans (``Spans(entry.sync)``)."""
    return getattr(getattr(ctx.spans, "sync", None), "__self__", None)


def traced_step(entry, tracer):
    """The entry's train step as its set-up builds it, with ``tracer``;
    None where the program's step takes no tracer."""
    from repro_torch.launch import train

    if "tracer" not in inspect.signature(train.make_train_step).parameters:
        return None
    arch = entry.arch()
    ocfg = train.opt_config(arch, learning_rate=entry.cfg["optimizer"]["learning_rate"])
    return train.make_train_step(arch, ocfg, n_micro=entry.traffic["n_micro"],
                                 optimizer="fim_lbfgs", kernels="auto", tracer=tracer)


def _by_name(spans, key):
    out = defaultdict(float)
    for s in spans:
        out[s.name] += key(s)
    return out


def profile(entry, units: int):
    """A finished ``torch.profiler`` trace of ``units`` of the entry's units
    inside ``record_function(WINDOW)``.  The trace may drop its first device
    op and the device's clock reads ~0.2 ms off the host's, so one op runs
    before the window, and the window opens and closes well inside the
    trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if entry.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        torch.zeros(1, device=entry.device)
        entry.sync()
        time.sleep(LEAD_S)
        with torch.profiler.record_function(WINDOW):
            for _ in range(units):
                entry.run_unit()
            entry.finish()
        time.sleep(LEAD_S)
    return prof


def run(entry, seconds: float, profile_units: int, err=None):
    """The phase (module docstring) -> its readings, or None where the
    program records no spans; the table to ``err`` (stderr)."""
    from repro_torch import obs

    if not hasattr(obs.Tracer, "resolve_device"):
        return None
    tracer = obs.Tracer(wall=True)
    step_fn = traced_step(entry, tracer)
    if step_fn is None:
        return None
    cuda = entry.device.type == "cuda"
    kept = entry.step_fn
    entry.step_fn = step_fn
    try:
        entry.finish()
        t0 = time.perf_counter()
        while True:
            entry.run_unit()
            if time.perf_counter() - t0 >= seconds:
                break
        entry.finish()
        wall_s = time.perf_counter() - t0
        timed = tracer.step + 1
        tracer.resolve_device()
        prof = profile(entry, profile_units)
        tracer.resolve_device()
    finally:
        entry.step_fn = kept
    spans = [s for s in tracer.spans if s.cat == obs.CAT_WALL]
    timed_spans = [s for s in spans if s.round_id < timed]
    names = {s.name for s in spans}
    ranges, window, ops, launches = device_ops(prof.profiler.kineto_results.events(),
                                               names)
    att = attribute(ranges, ops, window, launches)
    parents = {s.name: s.args.get("parent") for s in
               sorted(spans, key=lambda s: s.t0)}     # in order of a step
    dev = (_by_name(timed_spans, lambda s: s.args["device_s"])
           if cuda and all("device_s" in s.args for s in timed_spans) else None)
    out = {"steps": timed, "wall_s": wall_s, "profile_units": profile_units,
           "host_ms": {k: 1e3 * v / timed for k, v in
                       _by_name(timed_spans, lambda s: s.dur).items()},
           "device_ms": None if dev is None else
           {k: 1e3 * v / timed for k, v in dev.items()},
           "parents": parents, "profile": att,
           "addcmul_ms": 1e3 * sum(b - a for n, a, b, _ in ops if "addcmul" in n)
           / profile_units}
    _print_table(out, sys.stderr if err is None else err)
    return out


def _self(table: dict, parents: dict) -> dict:
    return {k: v - sum(table.get(c, 0.0) for c, p in parents.items() if p == k)
            for k, v in table.items()}


def _print_table(r: dict, err) -> None:
    n, p = r["steps"], r["profile_units"]
    att = r["profile"]
    dev = r["device_ms"]
    clock = "device (event pairs)" if dev is not None else "host"
    table = dev if dev is not None else r["host_ms"]
    own = _self(table, r["parents"])
    print(f"program spans: ms a step on the {clock} clock over {n} steps "
          f"({r['wall_s']:.3f} s); launches, kernel and idle ms a step from a "
          f"profile of {p}", file=err)
    print(f"{'span':18s} {'ms':>10s} {'self_ms':>10s} {'host_ms':>10s} "
          f"{'launches':>9s} {'kernel_ms':>10s} {'idle_ms':>9s}", file=err)
    for k in list(r["parents"]) + [OUTSIDE]:
        print(f"{k:18s} {table.get(k, 0.0):10.3f} {own.get(k, 0.0):10.3f} "
              f"{r['host_ms'].get(k, 0.0):10.3f} {att['launches'].get(k, 0) / p:9.1f} "
              f"{1e3 * att['kernel_s'].get(k, 0.0) / p:10.3f} "
              f"{1e3 * att['idle_s'].get(k, 0.0) / p:9.3f}", file=err)
    wall_ms = 1e3 * r["wall_s"] / n
    top = sum(table.get(k, 0.0) for k in TOP)
    kids = sum(table.get(k, 0.0) for k, q in r["parents"].items() if q == "server")
    print(f"program spans check: top-level {top:.3f} ms of a {wall_ms:.3f} ms "
          f"step ({100 * top / wall_ms:.2f} %); server's parts {kids:.3f} of "
          f"{table.get('server', 0.0):.3f} ms; combine "
          f"{table.get('server.combine', 0.0):.3f} ms against addcmul "
          f"{r['addcmul_ms']:.3f} ms; launches {att['total'] / p:.2f} a step, "
          f"device ops {att['device_ops'] / p:.2f} ({att['unlinked']} unlinked); "
          f"profile window {att['window_s']:.4f} s, "
          f"busy {att['busy_s']:.4f} s; {len(att['stray'])} ops off the window "
          f"{[(n[:40], round(a, 4), round(b, 4)) for n, a, b in att['stray'][:3]]}",
          file=err)


def phase(ctx):
    """The phase's readings for this traced run, run on the first call;
    None where there is nothing to run it on, or where it failed (its
    traceback on stderr: a reader never fails the run)."""
    if not hasattr(ctx, "program_spans"):
        entry = _entry(ctx)
        ctx.program_spans = None
        if entry is not None and hasattr(entry, "step_fn"):
            seconds = sum(u["unit_s"] for u in ctx.spans.units)
            try:
                ctx.program_spans = run(entry, seconds,
                                        entry.traffic["profile_units"])
            except Exception:                     # noqa: BLE001
                traceback.print_exc(file=sys.stderr)
    return ctx.program_spans


# -- the readers -------------------------------------------------------------
def _device_ms(ctx, *names):
    r = phase(ctx)
    if r is None or r["device_ms"] is None:
        return None
    return sum(r["device_ms"].get(n, 0.0) for n in names)


def combine_ms(ctx):
    return _device_ms(ctx, "server.combine")


def two_loop_ms(ctx):
    return _device_ms(ctx, "server.two_loop")


def server_passes_ms(ctx):
    return _device_ms(ctx, *SERVER_PASSES)


def backward_ms(ctx):
    return _device_ms(ctx, "train.backward")


def _profiled(ctx):
    r = phase(ctx)
    if r is None or r["profile"]["total"] == 0:
        return None
    return r


def cohort_idle_ms(ctx):
    r = _profiled(ctx)
    if r is None:
        return None
    idle = r["profile"]["idle_s"]
    return 1e3 * sum(idle.get(n, 0.0) for n in COHORT) / r["profile_units"]


def launches_per_step(ctx):
    r = _profiled(ctx)
    return None if r is None else r["profile"]["total"] / r["profile_units"]
