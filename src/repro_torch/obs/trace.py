"""Typed span/event tracing on the simulated ``EventClock`` timeline.

One traced ``FederatedRun`` answers "where did round 37's time, energy,
and bytes go, and why was client 12 dropped?" without a debugger: every
round is a span, every selected client gets child spans for
allocate → compute → uplink → deadline-verdict → aggregate, and the
async path emits dispatch / land / expiry events.  Span times are
*simulated seconds* (the edge clock); wall-clock measurements
(``wall_span`` blocks) live on a separate timeline so replays of the same
seed stay bit-identical on the sim tracks.

``wall_span`` is also the LLM train step's instrument
(``launch/train.py``, ``core/fim_lbfgs.py``, ``core/lbfgs.py``): under
``Tracer(wall=True)`` each block is a ``torch.profiler.record_function``
range (so a profiler's device trace shows it, on its own clock), a host
interval with its enclosing span's name as ``args["parent"]``, and, where
the block is given (or inherits) a CUDA device, a pair of timing events on
the current stream.  Nothing in a span reads the device or synchronises:
:meth:`Tracer.resolve_device`, called after the caller's own synchronise,
turns the pairs into ``args["device_s"]``.

The default everywhere is :data:`NULL_TRACER` — a shared no-op whose
methods early-out and whose ``metrics`` / ``audit`` are the no-op twins
from :mod:`repro_torch.obs.metrics` — so the instrumented hot path costs one
attribute check when tracing is off, and ``tests/test_determinism.py``
replays are unchanged.

Exports live in :mod:`repro_torch.obs.export`: JSONL event log, CSV metric
summaries, and Chrome trace-event JSON loadable in Perfetto.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field

from repro_torch.obs import metrics as _metrics

# span/event categories (Chrome trace "cat", JSONL "cat")
CAT_ROUND = "round"     # round-level phases on the sim timeline
CAT_CLIENT = "client"   # per-client phases on the sim timeline
CAT_ASYNC = "async"     # buffered-async dispatch / land / expiry
CAT_WALL = "wall"       # host wall-clock measurements (non-deterministic)

# canonical span / event names
ALLOCATE = "allocate"
COMPUTE = "compute"
UPLINK = "uplink"
VERDICT = "deadline_verdict"
AGGREGATE = "aggregate"
DOWNLINK = "downlink"
ROUND = "round"
DISPATCH = "dispatch"
LAND = "land"
EXPIRE = "expire"
FAULT = "scenario_fault"
REALLOC = "reallocate"

# what a disabled wall_span returns: one shared, reusable no-op context
_NULL_SPAN = contextlib.nullcontext()


@dataclass(frozen=True)
class Span:
    """A closed interval on a timeline (simulated seconds unless
    ``cat == CAT_WALL``)."""
    name: str
    cat: str
    t0: float
    t1: float
    round_id: int = -1
    client: int = -1
    args: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclass(frozen=True)
class TraceEvent:
    """An instant on a timeline."""
    name: str
    cat: str
    t: float
    round_id: int = -1
    client: int = -1
    args: dict = field(default_factory=dict)


def render_round(rec: dict) -> str:
    """The console form of one per-round log record — byte-compatible
    with the pre-tracer ``FederatedRun.run`` progress print."""
    return (f"round {rec.get('round', 0):4d} "
            f"loss {rec.get('loss', float('nan')):.4f} "
            f"acc {rec.get('accuracy', float('nan')):.4f}")


class NullTracer:
    """The no-op default: every hook early-outs, the console sink still
    renders per-round progress when asked (so ``verbose=`` keeps working
    without a real tracer attached)."""

    enabled = False
    step = -1           # the host step counter (``next_step``); -1: none

    def __init__(self):
        self.metrics = _metrics.NULL_METRICS
        self.audit = _metrics.NULL_AUDIT

    # -- recording hooks (all no-ops here) -------------------------------
    def span(self, name: str, cat: str, t0: float, t1: float,
             round_id: int = -1, client: int = -1, **args) -> None:
        pass

    def event(self, name: str, cat: str, t: float,
              round_id: int = -1, client: int = -1, **args) -> None:
        pass

    def record_round(self, rec: dict) -> None:
        pass

    def log_round(self, rec: dict, render: bool = False) -> None:
        if render:
            print(render_round(rec))

    def wall_span(self, name: str, round_id: int = -1, client: int = -1,
                  device=None, **args):
        return _NULL_SPAN

    def next_step(self) -> int:
        return -1

    def resolve_device(self) -> int:
        return 0


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Records spans, events, per-round records, and structured logs;
    owns a live :class:`~repro_torch.obs.metrics.MetricsRegistry` and
    :class:`~repro_torch.obs.metrics.PlanAudit`.

    ``sink`` is the console sink for rendered per-round log lines
    (default: ``print``); pass a list's ``append`` or any callable to
    capture them.  ``wall=True`` additionally records ``wall_span``
    context blocks on the host wall-clock timeline (category
    ``CAT_WALL`` — excluded from determinism comparisons by
    construction, since sim and wall categories never mix), each a
    ``record_function`` range and, on a CUDA device, a timing-event pair
    (see the module docstring); ``next_step`` advances the host step
    counter ``step`` that the train step's spans carry as ``round_id``.
    ``audit_max_rows`` caps :class:`~repro_torch.obs.metrics.PlanAudit` row
    retention for fleet-scale runs (None = exhaustive; totals stay
    exact and shortfall rows are always kept either way)."""

    enabled = True

    def __init__(self, wall: bool = False, sink=None, audit_max_rows=None):
        self.metrics = _metrics.MetricsRegistry()
        self.audit = _metrics.PlanAudit(max_rows=audit_max_rows)
        self.spans: list[Span] = []
        self.events: list[TraceEvent] = []
        self.records: list[dict] = []   # per-round edge runtime records
        self.logs: list[dict] = []      # per-round driver log records
        self.wall = bool(wall)
        self.step = -1
        self._open: list[_WallSpan] = []     # the enclosing wall spans
        self._pending: list = []              # (args, start, end) events
        self._sink = print if sink is None else sink
        # CAT_WALL epoch: wall measurement is the opt-in exception to
        # the sim-determinism contract
        self._wall_epoch = time.perf_counter()  # repro: allow[RPL001]

    # -- recording -------------------------------------------------------
    def span(self, name: str, cat: str, t0: float, t1: float,
             round_id: int = -1, client: int = -1, **args) -> None:
        self.spans.append(Span(name, cat, float(t0), float(t1),
                               int(round_id), int(client), args))

    def event(self, name: str, cat: str, t: float,
              round_id: int = -1, client: int = -1, **args) -> None:
        self.events.append(TraceEvent(name, cat, float(t),
                                      int(round_id), int(client), args))

    def record_round(self, rec: dict) -> None:
        self.records.append(dict(rec))

    def log_round(self, rec: dict, render: bool = False) -> None:
        self.logs.append({k: v for k, v in rec.items()
                          if _jsonable(v)})
        if render:
            self._sink(render_round(rec))

    def wall_span(self, name: str, round_id: int = -1, client: int = -1,
                  device=None, **args):
        """A host-clock block (``with tracer.wall_span(...):``), recorded
        only under ``wall=True``; ``device`` (or the enclosing span's)
        being CUDA adds the timing-event pair."""
        if not self.wall:
            return _NULL_SPAN
        return _WallSpan(self, name, round_id, client, device, args)

    def next_step(self) -> int:
        self.step += 1
        return self.step

    def resolve_device(self) -> int:
        """Each recorded event pair's elapsed seconds into its span's
        ``args["device_s"]``; call after a synchronise of the device (an
        event not yet reached raises).  -> the number of spans resolved."""
        for args, start, end in self._pending:
            args["device_s"] = start.elapsed_time(end) / 1e3
        n = len(self._pending)
        self._pending.clear()
        return n

    # -- views -----------------------------------------------------------
    def spans_for(self, round_id: int, cat: str = None,
                  client: int = None) -> list[Span]:
        return [s for s in self.spans
                if s.round_id == round_id
                and (cat is None or s.cat == cat)
                and (client is None or s.client == client)]

    def events_named(self, name: str) -> list[TraceEvent]:
        return [e for e in self.events if e.name == name]


class _WallSpan:
    """One enabled ``wall_span`` block: a ``record_function`` range, the
    host interval on the tracer's wall epoch, and on a CUDA device two
    timing events recorded on the current stream (no synchronise)."""

    __slots__ = ("tracer", "name", "round_id", "client", "device", "args",
                 "t0", "range", "start")

    def __init__(self, tracer, name, round_id, client, device, args):
        self.tracer, self.name = tracer, name
        self.round_id, self.client, self.args = round_id, client, args
        self.device = device

    def __enter__(self):
        import torch

        tr = self.tracer
        parent = tr._open[-1] if tr._open else None
        if parent is not None:
            self.args["parent"] = parent.name
            if self.device is None:
                self.device = parent.device
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        tr._open.append(self)
        self.start = None
        if self.device is not None and torch.device(self.device).type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter() - tr._wall_epoch  # repro: allow[RPL001]
        return self

    def __exit__(self, *exc):
        import torch

        tr = self.tracer
        t1 = time.perf_counter() - tr._wall_epoch  # repro: allow[RPL001]
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            tr._pending.append((self.args, self.start, end))
        self.range.__exit__(*exc)
        tr._open.pop()
        # the span holds self.args itself: resolve_device fills it later
        tr.spans.append(Span(self.name, CAT_WALL, self.t0, t1,
                             int(self.round_id), int(self.client), self.args))
        return False


def _jsonable(v) -> bool:
    if isinstance(v, float):
        return True  # NaN handled at export time
    return isinstance(v, (int, str, bool, type(None)))


def sanitize_float(v):
    """NaN/Inf are not valid JSON scalars; stringify them for export."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    return v
