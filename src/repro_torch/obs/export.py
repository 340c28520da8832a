"""Trace / metrics exporters: JSONL, CSV and Chrome trace-event JSON.

  * :func:`to_jsonl` / :func:`parse_jsonl` — a line-per-record log of
    every span, event, per-round record, and structured log entry.  The
    export contains *only simulated-timeline data by default* (wall
    category excluded), so two same-seed replays serialize to identical
    strings — the determinism lock for the tracer itself.
  * :func:`to_chrome` — Chrome trace-event JSON (the ``traceEvents``
    envelope) loadable in Perfetto / ``chrome://tracing``: one process
    for the simulated edge timeline with a thread per client (thread 0
    carries round-level phases), plus an optional wall-clock process.
  * :func:`metrics_to_csv` — the flattened metric points.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.obs.trace import CAT_WALL, Span, TraceEvent, Tracer, sanitize_float


# ---------------------------------------------------------------------------
# JSONL
# ---------------------------------------------------------------------------
def _clean(d: dict) -> dict:
    return {k: sanitize_float(v) for k, v in d.items()}


def to_jsonl(tracer: Tracer, include_wall: bool = False) -> str:
    """One JSON object per line, in recording order per section."""
    lines = []
    for s in tracer.spans:
        if s.cat == CAT_WALL and not include_wall:
            continue
        lines.append({"type": "span", "name": s.name, "cat": s.cat,
                      "t0": sanitize_float(s.t0), "t1": sanitize_float(s.t1),
                      "round": s.round_id, "client": s.client,
                      "args": _clean(s.args)})
    for e in tracer.events:
        if e.cat == CAT_WALL and not include_wall:
            continue
        lines.append({"type": "event", "name": e.name, "cat": e.cat,
                      "t": sanitize_float(e.t), "round": e.round_id,
                      "client": e.client, "args": _clean(e.args)})
    for r in tracer.records:
        lines.append({"type": "round", **_clean(r)})
    for r in tracer.logs:
        lines.append({"type": "log", **_clean(r)})
    return "\n".join(json.dumps(ln, sort_keys=True) for ln in lines)


def write_jsonl(tracer: Tracer, path: str, include_wall: bool = False) -> str:
    with open(path, "w") as f:
        f.write(to_jsonl(tracer, include_wall=include_wall) + "\n")
    return path


def parse_jsonl(text: str) -> dict:
    """-> {"spans": [Span], "events": [TraceEvent], "records": [dict],
    "logs": [dict]} — the inverse of :func:`to_jsonl` (wall-free)."""
    out = {"spans": [], "events": [], "records": [], "logs": []}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        d = json.loads(line)
        t = d.pop("type")
        if t == "span":
            out["spans"].append(Span(d["name"], d["cat"], d["t0"], d["t1"],
                                     d["round"], d["client"], d["args"]))
        elif t == "event":
            out["events"].append(TraceEvent(d["name"], d["cat"], d["t"],
                                            d["round"], d["client"],
                                            d["args"]))
        elif t == "round":
            out["records"].append(d)
        elif t == "log":
            out["logs"].append(d)
        else:
            raise ValueError(f"unknown trace record type {t!r}")
    return out


# ---------------------------------------------------------------------------
# Chrome trace-event JSON (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------
_SIM_PID = 1
_WALL_PID = 2


def _tid(client: int) -> int:
    # thread 0 = round-level track; client k = thread k+1
    return 0 if client < 0 else int(client) + 1


def _top_clients(tracer: Tracer, k: int) -> set:
    """The ``k`` clients with the latest span end (slowest finish first)
    on the simulated timeline — the stragglers a fleet-scale trace is
    usually opened to find."""
    latest: dict[int, float] = {}
    for s in tracer.spans:
        if s.cat == CAT_WALL or s.client < 0:
            continue
        latest[s.client] = max(latest.get(s.client, float("-inf")), s.t1)
    ranked = sorted(latest, key=lambda c: (-latest[c], c))
    return set(ranked[:max(int(k), 0)])


def to_chrome(tracer: Tracer, include_wall: bool = True,
              top_k_clients: Optional[int] = None) -> dict:
    """The ``traceEvents`` envelope: complete ("X") events for spans,
    instant ("i") events for point events, metadata ("M") rows naming
    the processes and per-client threads.  Simulated seconds map to
    trace microseconds 1:1 (1 sim second == 1s on the Perfetto ruler).

    ``top_k_clients`` (None = everyone) bounds the per-client tracks for
    fleet-scale traces: only the k slowest-finishing clients keep their
    threads; the round-level track (thread 0) is always complete."""
    ev: list[dict] = []
    ev.append({"name": "process_name", "ph": "M", "pid": _SIM_PID, "tid": 0,
               "args": {"name": "edge-sim"}})
    keep = (None if top_k_clients is None
            else _top_clients(tracer, top_k_clients))
    tids = {0}
    for s in tracer.spans:
        if s.cat == CAT_WALL:
            continue
        if keep is not None and s.client >= 0 and s.client not in keep:
            continue
        tids.add(_tid(s.client))
        ev.append({"name": s.name, "cat": s.cat, "ph": "X",
                   "ts": s.t0 * 1e6, "dur": max(s.dur, 0.0) * 1e6,
                   "pid": _SIM_PID, "tid": _tid(s.client),
                   "args": _clean({"round": s.round_id, **s.args})})
    for e in tracer.events:
        if e.cat == CAT_WALL:
            continue
        if keep is not None and e.client >= 0 and e.client not in keep:
            continue
        tids.add(_tid(e.client))
        ev.append({"name": e.name, "cat": e.cat, "ph": "i", "s": "t",
                   "ts": e.t * 1e6, "pid": _SIM_PID, "tid": _tid(e.client),
                   "args": _clean({"round": e.round_id, **e.args})})
    for tid in sorted(tids):
        ev.append({"name": "thread_name", "ph": "M", "pid": _SIM_PID,
                   "tid": tid,
                   "args": {"name": "rounds" if tid == 0
                            else f"client {tid - 1}"}})
    wall = [s for s in tracer.spans if s.cat == CAT_WALL]
    if wall and include_wall:
        ev.append({"name": "process_name", "ph": "M", "pid": _WALL_PID,
                   "tid": 0, "args": {"name": "host-wall"}})
        for s in wall:
            ev.append({"name": s.name, "cat": s.cat, "ph": "X",
                       "ts": s.t0 * 1e6, "dur": max(s.dur, 0.0) * 1e6,
                       "pid": _WALL_PID, "tid": _tid(s.client),
                       "args": _clean({"round": s.round_id, **s.args})})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_chrome(tracer: Tracer, path: str, include_wall: bool = True,
                 top_k_clients: Optional[int] = None) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome(tracer, include_wall=include_wall,
                            top_k_clients=top_k_clients), f)
    return path


# ---------------------------------------------------------------------------
# Metrics CSV
# ---------------------------------------------------------------------------
def metrics_to_csv(registry) -> str:
    lines = ["metric,kind,labels,field,value"]
    for name, kind, labels, fld, v in registry.to_rows():
        lbl = labels.replace('"', '""')
        lines.append(f'{name},{kind},"{lbl}",{fld},{v}')
    return "\n".join(lines)


def write_metrics_csv(registry, path: str) -> str:
    with open(path, "w") as f:
        f.write(metrics_to_csv(registry) + "\n")
    return path
