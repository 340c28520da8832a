"""Spans around calls into the program, and the reduction of a
``torch.profiler`` trace to device busy time, kernel times and idle gaps.

Spans are recorded from the benchmark's side only: ``wrapped`` replaces a
module or object attribute for the traced run with ``Spans.timed``, which
synchronises the device, times the call on the host clock, synchronises
again and adds the seconds to the current unit (round or step).  The
untraced run never installs them.
"""
from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict

import torch


class Spans:
    """Seconds a named span took, summed within each unit of work."""

    def __init__(self, sync):
        self.sync = sync
        self.units: list[dict] = []
        self._cur: dict = defaultdict(float)

    def begin_unit(self) -> None:
        self._cur = defaultdict(float)

    def end_unit(self, seconds: float) -> None:
        self.units.append({"unit_s": seconds, **self._cur})

    def timed(self, name: str, fn):
        def wrapper(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.sync()
            self._cur[name] += time.perf_counter() - t0
            return out
        return wrapper

    def mean_ms(self, *names: str) -> float | None:
        """Mean over units of the named spans' summed ms; None where no unit
        recorded any of them."""
        if not self.units or not any(n in u for u in self.units for n in names):
            return None
        return 1e3 * sum(sum(u.get(n, 0.0) for n in names)
                         for u in self.units) / len(self.units)

    def mean_unit_ms(self) -> float | None:
        if not self.units:
            return None
        return 1e3 * sum(u["unit_s"] for u in self.units) / len(self.units)


class Clock:
    """Host seconds between the named stages of a set-up, on stderr."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, stage: str) -> None:
        now = time.perf_counter()
        print(f"setup {stage}: {now - self.t:.3f} s", file=sys.stderr)
        self.t = now


@contextlib.contextmanager
def wrapped(obj, attr: str, make):
    """``obj.attr`` replaced by ``make(original)`` inside the block (on an
    instance, an attribute that shadows its class's method, then removed)."""
    own = attr in vars(obj)
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        if own:
            setattr(obj, attr, orig)
        else:
            delattr(obj, attr)


def _device_events(prof, skip=()):
    """(name, start_s, end_s) of every device activity (kernels, copies,
    sets) in a finished profile; ``skip`` names the ``record_function``
    ranges, which the trace also mirrors onto the device's timeline."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.name() in skip:
            continue
        start = e.start_ns() * 1e-9
        out.append((e.name(), start, start + e.duration_ns() * 1e-9))
    return out


def _host_ranges(prof, labels):
    """(label, start_s, end_s) of the ``record_function`` ranges whose name
    is one of ``labels``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            continue
        if e.name() in labels:
            start = e.start_ns() * 1e-9
            out.append((e.name(), start, start + e.duration_ns() * 1e-9))
    return out


WINDOW = "feel_bench.window"


def reduce_profile(prof, labels=(), outside: str = "driver") -> dict:
    """-> {"busy_s", "window_s", "kernels": {name: [count, seconds]},
    "device_ops": top 10 [name, s], "idle_gaps": top 10 [label, s]}.

    The window is the host range ``record_function(WINDOW)``, which ends
    after a device synchronise.  Busy time is the union of the device
    intervals inside it; an idle gap is labelled by the innermost of
    ``labels``' host ranges around its midpoint, or ``outside`` outside
    them."""
    (_, lo, hi), = _host_ranges(prof, {WINDOW})
    events = sorted((n, max(a, lo), min(b, hi)) for n, a, b in
                    _device_events(prof, {WINDOW, *labels}) if b > lo and a < hi)
    kernels: dict = {}
    for name, a, b in events:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += b - a
    busy, gaps = 0.0, []
    cur_a = cur_b = None
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
            elif a > lo:
                gaps.append((lo, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        if hi > cur_b:
            gaps.append((cur_b, hi))
    ranges = _host_ranges(prof, set(labels))
    by_label: dict = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [(rb - ra, name) for name, ra, rb in ranges if ra <= mid <= rb]
        by_label[min(inside)[1] if inside else outside] += b - a
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"busy_s": busy, "window_s": hi - lo, "kernels": kernels,
            "device_ops": [[n, v[1]] for n, v in ops],
            "idle_gaps": sorted(([k, v] for k, v in by_label.items()),
                                key=lambda kv: -kv[1])[:10]}


def kernel_mean_s(kernels: dict, fragment: str) -> float | None:
    """Mean device seconds a launch of the kernels whose name holds
    ``fragment``; None where the trace has none."""
    hits = [v for n, v in kernels.items() if fragment in n]
    count = sum(c for c, _ in hits)
    return sum(s for _, s in hits) / count if count else None
