"""Metrics registry for the edge runtime: counters / gauges / histograms.

Mirrors the strategies / codecs / allocation-policy registries in shape:
metrics are named, self-describing objects looked up (and lazily
created) through one :class:`MetricsRegistry`, so the driver, the edge
runtime, the codecs, and the async aggregator all report into a single
place without threading dozens of attributes around.  A metric point is
``(name, labels, value)``; labels are free-form keyword strings
(``direction="up", topology="star", codec="int8"``).

Standard metric names emitted by the instrumented runtime (see the
README "Observability" table):

  * ``bytes_wire_total``   counter  — direction × topology × codec × phase
  * ``drops_total``        counter  — runtime deadline cutoffs, by reason
  * ``excluded_total``     counter  — a-priori policy exclusions, by reason
  * ``phase_s_total``      counter  — simulated seconds by round phase
  * ``energy_j_total``     counter  — Σ joules drained across the fleet
  * ``barrier_s``          histogram — per-round sync barrier
  * ``cohort_size``        histogram — landed cohort per round
  * ``async_staleness``    histogram — server-version lag of landed updates
  * ``codec_encode_s``     histogram — wall-clock encode time, by codec
  * ``codec_ratio``        gauge    — achieved wire/raw compression ratio
  * ``battery_j``          gauge    — per-client remaining battery
  * ``ef_residual_norm``   gauge    — per-client error-feedback residual

The module also owns :class:`PlanAudit` — the plan == ledger invariant
as a *runtime audit*: every metered upload adds a (round, client, phase,
planned, billed) row, and ``verify(ledger)`` asserts the billed total
equals the ledger's star-uplink actuals, so tests and benchmarks assert
one object instead of each re-deriving the invariant.

``NULL_METRICS`` / ``NULL_AUDIT`` are shared no-op instances: the
default ``NullTracer`` carries them so the instrumented hot path costs a
single attribute load when tracing is off.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def reason_key(reason: str) -> str:
    """Collapse a prose drop/exclusion reason into a stable label bucket
    (metrics labels must have low cardinality; the full prose stays on
    the RoundDecision)."""
    r = reason.lower()
    # scenario buckets first: their prose mentions "blackout"/"battery"
    # etc., which must not leak into the policy-exclusion buckets below
    if "unavailable" in r or "availability" in r:
        return "unavailable"
    if "fault" in r or "blackout" in r or "battery-gated" in r:
        return "fault"
    if "battery" in r:
        return "battery"
    if "energy" in r:
        return "energy_budget"
    if "hz" in r or "bandwidth" in r:
        return "bandwidth_infeasible"
    if "deadline" in r or "finish" in r:
        return "deadline"
    return (r.split() or ["other"])[0]


# ---------------------------------------------------------------------------
# Metric kinds
# ---------------------------------------------------------------------------
class Metric:
    kind = ""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v: dict[tuple, object] = {}

    def labelsets(self) -> list[dict]:
        return [dict(k) for k in self._v]

    def items(self):
        """-> [(labels_dict, value)] in insertion order."""
        return [(dict(k), v) for k, v in self._v.items()]


class Counter(Metric):
    """Monotone accumulator per labelset."""
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        self._v[k] = self._v.get(k, 0.0) + float(value)

    def value(self, **labels) -> float:
        return float(self._v.get(_label_key(labels), 0.0))

    def total(self) -> float:
        return float(sum(self._v.values()))


class Gauge(Metric):
    """Last-written value per labelset."""
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._v[_label_key(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        v = self._v.get(_label_key(labels))
        return None if v is None else float(v)


class Histogram(Metric):
    """Streaming count/sum/min/max per labelset (no buckets: the trace
    itself is the full-resolution record; the histogram is the cheap
    always-on aggregate)."""
    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        k = _label_key(labels)
        s = self._v.get(k)
        if s is None:
            self._v[k] = {"count": 1, "sum": v, "min": v, "max": v}
        else:
            s["count"] += 1
            s["sum"] += v
            s["min"] = min(s["min"], v)
            s["max"] = max(s["max"], v)

    def stats(self, **labels) -> dict:
        return dict(self._v.get(_label_key(labels),
                                {"count": 0, "sum": 0.0,
                                 "min": float("nan"), "max": float("nan")}))

    def total_count(self) -> int:
        return int(sum(s["count"] for s in self._v.values()))

    def total_sum(self) -> float:
        return float(sum(s["sum"] for s in self._v.values()))


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named metrics, created lazily on first use (get-or-create, like
    the strategy/codec registries resolve by name)."""

    enabled = True

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested as {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def get(self, name: str) -> Metric:
        if name not in self._metrics:
            raise KeyError(f"unknown metric {name!r}; "
                           f"known: {sorted(self._metrics)}")
        return self._metrics[name]

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def to_rows(self) -> list[list]:
        """Flatten to CSV-able rows: [name, kind, labels-json, field,
        value] — histograms expand to count/sum/min/max rows."""
        rows = []
        for name in self.names():
            m = self._metrics[name]
            for labels, v in m.items():
                lbl = json.dumps(labels, sort_keys=True)
                if m.kind == "histogram":
                    for f in ("count", "sum", "min", "max"):
                        rows.append([name, m.kind, lbl, f, v[f]])
                else:
                    rows.append([name, m.kind, lbl, "value", v])
        return rows

    def as_dict(self) -> dict:
        return {name: {"kind": m.kind,
                       "points": [[labels, v] for labels, v in m.items()]}
                for name, m in sorted(self._metrics.items())}


# ---------------------------------------------------------------------------
# PlanAudit: plan == ledger as a runtime invariant
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PlanAuditRow:
    round_id: int
    client: int
    phase: str
    planned_bytes: float      # the plan's wire bytes under this client's codec
    billed_bytes: float       # what the ledger actually metered (tx_frac cut)


class PlanAudit:
    """Planned vs billed upload bytes, per (round, client, phase).

    billed == planned for every landed client; billed < planned exactly
    for deadline-dropped clients (only on-air bytes billed), so
    Σ billed == ``CommLedger.up_star_bytes`` always — the
    "ledger ≤ plan, equality iff no drops" contract as one assertable
    object instead of per-test re-derivations.

    ``max_rows`` (None = exhaustive, the default) bounds row retention
    for fleet-scale runs: once the cap is reached, clean (billed ==
    planned) rows are counted but not stored (``dropped_rows``), while
    *shortfall* rows — the interesting ones, billed < planned — are
    ALWAYS retained.  The running ``planned_total`` / ``billed_total``
    cover every ``add`` regardless of retention, so :meth:`verify`
    still checks the full invariant; only :meth:`per_client` is limited
    to the retained rows."""

    enabled = True

    def __init__(self, max_rows: Optional[int] = None):
        self.rows: list[PlanAuditRow] = []
        self.max_rows = None if max_rows is None else int(max_rows)
        self.dropped_rows = 0           # clean rows counted but not stored
        self._planned_total = 0.0
        self._billed_total = 0.0

    def add(self, round_id: int, client: int, phase: str,
            planned_bytes: float, billed_bytes: float) -> None:
        planned_bytes = float(planned_bytes)
        billed_bytes = float(billed_bytes)
        self._planned_total += planned_bytes
        self._billed_total += billed_bytes
        # only CLEAN rows are droppable: a mismatch in either direction
        # (shortfall, or an over-billing bug verify must see) is retained
        if (self.max_rows is not None and len(self.rows) >= self.max_rows
                and billed_bytes == planned_bytes):
            self.dropped_rows += 1
            return
        self.rows.append(PlanAuditRow(int(round_id), int(client), str(phase),
                                      planned_bytes, billed_bytes))

    def planned_total(self) -> float:
        return self._planned_total

    def billed_total(self) -> float:
        return self._billed_total

    def shortfall_rows(self) -> list[PlanAuditRow]:
        """Rows billed under plan — exactly the deadline-dropped uploads."""
        return [r for r in self.rows if r.billed_bytes < r.planned_bytes]

    def per_client(self) -> dict[int, dict[str, float]]:
        out: dict[int, dict[str, float]] = {}
        for r in self.rows:
            d = out.setdefault(r.client, {"planned": 0.0, "billed": 0.0})
            d["planned"] += r.planned_bytes
            d["billed"] += r.billed_bytes
        return out

    def verify(self, ledger, tol: float = 1e-6) -> None:
        """Assert the audit's billed total equals the ledger's star-uplink
        actuals (and billed ≤ planned row-wise).  Raises ValueError with
        the decomposition on mismatch."""
        billed = self.billed_total()
        actual = float(ledger.up_star_bytes)
        if abs(billed - actual) > tol * max(actual, 1.0):
            raise ValueError(
                f"PlanAudit billed {billed:.6g}B != CommLedger star uplink "
                f"{actual:.6g}B (planned {self.planned_total():.6g}B over "
                f"{len(self.rows)} rows)")
        bad = [r for r in self.rows
               if r.billed_bytes > r.planned_bytes * (1 + 1e-9)]
        if bad:
            raise ValueError(
                f"{len(bad)} audit rows billed ABOVE plan, e.g. {bad[0]}")


# ---------------------------------------------------------------------------
# No-op twins for the untraced hot path
# ---------------------------------------------------------------------------
class _NullMetric:
    def inc(self, value: float = 1.0, **labels) -> None:
        pass

    def set(self, value: float, **labels) -> None:
        pass

    def observe(self, value: float, **labels) -> None:
        pass

    def value(self, **labels) -> float:
        return 0.0

    def total(self) -> float:
        return 0.0

    def items(self):
        return []


_NULL_METRIC = _NullMetric()


class NullMetricsRegistry(MetricsRegistry):
    enabled = False

    def __init__(self):
        super().__init__()

    def counter(self, name: str, help: str = ""):
        return _NULL_METRIC

    gauge = counter
    histogram = counter


class NullPlanAudit(PlanAudit):
    enabled = False

    def add(self, round_id, client, phase, planned_bytes, billed_bytes):
        pass


NULL_METRICS = NullMetricsRegistry()
NULL_AUDIT = NullPlanAudit()
