"""Observability of the port (``repro_torch.obs``): a traced
``FederatedRun(..., edge=..., tracer=Tracer())`` against the
reference's traced run on the CPU, for three edge runs of ``fim_lbfgs``
(sync energy_opt under churn, adaptive_codec's per-client top-k, the
async expiry path), each also held as tests/test_torch_edge_run.py
holds a run.

Everything on the simulated timeline is numpy and must be equal: the
spans, the events, the ``PlanAudit`` rows, the per-round records and
the metrics (apart from ``codec_encode_s``, the host's wall time, and
``ef_residual_norm``, the norm of model floats, held within 1e-4).
``to_jsonl(include_wall=False)`` is byte-identical on every span, event
and round line; its log lines carry the model's loss and accuracy, so
those two fields are held as the whole-slice tests hold them and every
other field byte for byte.
"""
import functools
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import obs as r_obs  # noqa: E402
from repro_torch import obs  # noqa: E402
from test_torch_edge_run import (assert_run_matches, make_runs,  # noqa: E402
                                 record_staleness)

SCENARIO = "markov:p_drop=0.2,p_join=0.4|snr_burst:prob=0.4,scale=0.1"
CASES = {
    # sync energy_opt under churn with re-allocation: allocate, verdict,
    # fault and reallocate events, the span tree, a priori exclusions
    "energy_opt_churn": dict(scheduler="energy_opt", enforce_deadline_s=3.0,
                             scenario=SCENARIO, reallocate=True),
    # per-client top-k: codec metrics and the per_client billing path
    "adaptive_codec": dict(scheduler="adaptive_codec",
                           enforce_deadline_s=1.4),
    # buffered async: dispatch, land and expiry events
    "async_expiry": dict(scheduler="uniform", enforce_deadline_s=3.0,
                         mode="async", buffer_size=3),
}
WALL_METRICS = {"codec_encode_s"}
FLOAT_METRICS = {"ef_residual_norm"}


@functools.lru_cache(maxsize=None)
def _traced(case):
    """One traced reference run and one traced port run of ``case``
    (cached: the export test reads the churn case's tracers again)."""
    r_lines, p_lines = [], []
    r_tracer = r_obs.Tracer(sink=r_lines.append)
    p_tracer = obs.Tracer(sink=p_lines.append)
    ref, (port,) = make_runs("fim_lbfgs", 3, tracers=(r_tracer, [p_tracer]),
                             **CASES[case])
    staleness = (record_staleness(port) if port.edge.async_agg is not None
                 else None)
    r_hist = ref.run(rounds=3, eval_every=3, verbose=True)
    p_hist = port.run(rounds=3, eval_every=3, verbose=True)
    return (ref, r_tracer, r_hist, r_lines), (port, p_tracer, p_hist,
                                              p_lines), staleness


def _fields(items) -> list:
    return [vars(x) for x in items]


def _metric_points(tracer, skip):
    return {name: pts for name, pts in tracer.metrics.as_dict().items()
            if name not in skip}


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_run_matches_reference(case):
    (ref, r_tr, r_hist, r_lines), (port, p_tr, p_hist, p_lines), stale = \
        _traced(case)
    # the run itself, as tests/test_torch_edge_run.py holds it
    assert_run_matches(ref, port, r_hist, p_hist)
    # the packages' Span/TraceEvent classes differ: compare their fields
    assert _fields(p_tr.spans) == _fields(r_tr.spans)
    assert _fields(p_tr.events) == _fields(r_tr.events) and p_tr.events
    # async rounds have no sync span tree, only dispatch/land/expiry
    assert bool(p_tr.spans) == (port.edge.async_agg is None)
    assert p_tr.records == r_tr.records
    assert _fields(p_tr.audit.rows) == _fields(r_tr.audit.rows)
    assert p_tr.audit.billed_total() == r_tr.audit.billed_total()
    p_tr.audit.verify(port.ledger)
    skip = WALL_METRICS | FLOAT_METRICS
    assert _metric_points(p_tr, skip) == _metric_points(r_tr, skip)
    assert set(p_tr.metrics.names()) == set(r_tr.metrics.names())
    for name in FLOAT_METRICS & set(r_tr.metrics.names()):
        got = dict((json.dumps(lb, sort_keys=True), v)
                   for lb, v in p_tr.metrics.get(name).items())
        want = dict((json.dumps(lb, sort_keys=True), v)
                    for lb, v in r_tr.metrics.get(name).items())
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    # the JSONL export: simulated-timeline lines byte for byte
    p_text = obs.to_jsonl(p_tr, include_wall=False).splitlines()
    r_text = r_obs.to_jsonl(r_tr, include_wall=False).splitlines()
    assert len(p_text) == len(r_text)
    for p_line, r_line in zip(p_text, r_text, strict=True):
        p_rec, r_rec = json.loads(p_line), json.loads(r_line)
        if r_rec["type"] != "log":
            assert p_line == r_line
            continue
        for key in ("loss", "accuracy"):
            if key in r_rec:
                tol = 1e-5 * abs(r_rec[key]) if key == "loss" else 0.011
                assert abs(p_rec.pop(key) - r_rec.pop(key)) <= tol
        assert json.dumps(p_rec, sort_keys=True) == \
            json.dumps(r_rec, sort_keys=True)
    # the console sink: the reference's renderer, byte for byte
    assert p_lines == [obs.render_round(h) for h in p_hist
                       if "accuracy" in h]
    for rec in r_hist + p_hist:
        assert obs.render_round(rec) == r_obs.render_round(rec)
    # each case exercises what it claims
    names = {e.name for e in p_tr.events}
    if case == "energy_opt_churn":
        assert {obs.ALLOCATE, obs.VERDICT, obs.FAULT} <= names, names
    if case == "adaptive_codec":
        assert "codec_ratio" in p_tr.metrics.names()
        assert p_tr.metrics.get("codec_encode_s").total_count() > 0
        # per-client top-k at several ratios, residuals kept per client
        ks = {d.codec_for(i).spec() for d in port.edge.decisions
              for i in d.selected if d.codec_for(i) is not None}
        assert len(ks) >= 2, ks
        assert sorted(port._ef_residual) == \
            sorted(int(c) for c in ref._ef_residual)
    if case == "async_expiry":
        assert {obs.DISPATCH, obs.LAND, obs.EXPIRE} <= names, names
        assert max(stale) > 0


def test_chrome_and_csv_exports_match_reference():
    """The Chrome trace (simulated process only) and the metrics CSV
    (without the wall-time histogram) of one traced run."""
    (_, r_tr, _, _), (_, p_tr, _, _), _ = _traced("energy_opt_churn")
    assert (obs.to_chrome(p_tr, include_wall=False, top_k_clients=4)
            == r_obs.to_chrome(r_tr, include_wall=False, top_k_clients=4))
    assert obs.metrics_to_csv(p_tr.metrics) == \
        r_obs.metrics_to_csv(r_tr.metrics)
    parsed = obs.parse_jsonl(obs.to_jsonl(p_tr))
    assert _fields(parsed["spans"]) == _fields(p_tr.spans)
    assert len(parsed["logs"]) == 3
