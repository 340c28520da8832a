"""repro_torch.obs — observability for the federated edge runtime (port
of ``repro.obs``; stdlib only, the reference's own code with imports
rerooted).

Span tracing on the simulated clock (:mod:`repro_torch.obs.trace`), a
counters/gauges/histograms registry plus the plan==ledger
:class:`PlanAudit` (:mod:`repro_torch.obs.metrics`), and exporters — JSONL,
CSV, Perfetto-loadable Chrome trace JSON (:mod:`repro_torch.obs.export`).

Attach a :class:`Tracer` to a run::

    from repro_torch import obs
    tracer = obs.Tracer()
    run = FederatedRun(mcfg, fcfg, train, test, "fim_lbfgs", tracer=tracer)
    run.run(rounds=8)
    obs.write_chrome(tracer, "trace.json")       # load in ui.perfetto.dev
    obs.write_jsonl(tracer, "trace.jsonl")
    tracer.audit.verify(run.ledger)              # plan == ledger, audited

The LLM train step takes one too: ``launch.train.make_train_step(...,
tracer=obs.Tracer(wall=True))`` records its spans on the host clock, as
``torch.profiler`` ranges and, on the card, as device time
(:meth:`Tracer.resolve_device` after a synchronise).

The default is :data:`NULL_TRACER` — a shared no-op — so the
instrumented hot path costs nothing when tracing is off.
"""
from repro_torch.obs.export import (metrics_to_csv, parse_jsonl, to_chrome,
                                    to_jsonl, write_chrome, write_jsonl,
                                    write_metrics_csv)
from repro_torch.obs.metrics import (NULL_AUDIT, NULL_METRICS, Counter,
                                     Gauge, Histogram, MetricsRegistry,
                                     PlanAudit, reason_key)
from repro_torch.obs.trace import (AGGREGATE, ALLOCATE, CAT_ASYNC,
                                   CAT_CLIENT, CAT_ROUND, CAT_WALL, COMPUTE,
                                   DISPATCH, DOWNLINK, EXPIRE, FAULT, LAND,
                                   NULL_TRACER, REALLOC, ROUND, UPLINK,
                                   VERDICT, NullTracer, Span, TraceEvent,
                                   Tracer, render_round)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "PlanAudit",
    "NULL_AUDIT", "NULL_METRICS", "NULL_TRACER", "NullTracer", "Span",
    "TraceEvent", "Tracer", "render_round", "reason_key",
    "metrics_to_csv", "parse_jsonl", "to_chrome", "to_jsonl",
    "write_chrome", "write_jsonl", "write_metrics_csv",
    "AGGREGATE", "ALLOCATE", "CAT_ASYNC", "CAT_CLIENT", "CAT_ROUND",
    "CAT_WALL", "COMPUTE", "DISPATCH", "DOWNLINK", "EXPIRE", "FAULT",
    "LAND", "REALLOC", "ROUND", "UPLINK", "VERDICT",
]
