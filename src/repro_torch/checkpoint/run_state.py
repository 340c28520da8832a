"""Mid-run checkpoint/resume for :class:`repro_torch.fed.server.FederatedRun`
(port of ``repro.checkpoint.run_state``).

``save_run(path, run)`` captures everything that mutates across sync
rounds — the strategy's server state (params + optimizer), the driver's
random streams (the numpy generator state and the codec's
``torch.Generator`` state), the ``CommLedger`` counters, and the edge
runtime's clock / batteries / channel rng / scenario state — so
``load_run(path, run)`` into a freshly constructed run with the *same
configs* continues exactly where the original left off: the resumed
run's ledger and per-round drop sets are bit-identical to the
uninterrupted run's tail, scenario on or off.

Two artifacts per checkpoint: ``<path>`` is the npz array tree
(:func:`repro_torch.checkpoint.save`), ``<path>.meta.json`` the scalar
state (numpy rng states carry arbitrary-precision ints, which JSON keeps
exact and npz floats would not).  Both writes are atomic (tmp + rename).
The codec generator's state (``get_state()``, a CPU byte tensor also for
a CUDA generator) is saved as a ``uint8`` array and put back with
``set_state``.

The format is the port's own: a checkpoint written by the reference
cannot be loaded, since its threefry compression key has no torch
counterpart.

Scope (raises otherwise):
  * sync mode only — the async in-flight heap/holds are not captured;
  * no pending error-feedback residuals (per-client EF trees).

Round *numbering* restarts at 0 in the resumed run (trace round ids,
``history`` indices): it is observability only — no simulation state
reads it.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from repro_torch.checkpoint.checkpoint import restore, save

_LEDGER_FIELDS = ("down_bytes", "up_star_bytes", "up_tree_bytes",
                  "scalar_bytes", "rounds")
_EDGE_COUNTERS = ("energy_j", "dropped_total", "deadline_dropped_total",
                  "unavailable_total", "realloc_rounds")


def _check_resumable(run) -> None:
    edge = run.edge
    if edge is not None and edge.async_agg is not None:
        raise ValueError(
            "run_state checkpoints sync-mode runs only: the async "
            "aggregator's in-flight uploads / held spectrum are live "
            "event-heap state this format does not capture")
    if run._ef_residual:
        raise ValueError(
            "run has pending per-client error-feedback residuals; "
            "run_state does not capture EF state — checkpoint with "
            "compress='none'/'int8' (no EF) or at an EF-free boundary")


def _array_tree(run) -> dict:
    """The npz side: every mutable array, as one tree."""
    tree: dict = {"strategy": run.strategy.state_dict(),
                  "codec_generator": run.codec_generator.get_state()}
    edge = run.edge
    if edge is not None:
        tree["battery_j"] = np.asarray(edge.fleet.battery_j)
        if edge.scenario is not None:
            tree["scenario"] = edge.scenario.state_dict()["arrays"]
    return tree


def _meta(run) -> dict:
    """The JSON side: rng states, counters, the simulated clock."""
    m: dict = {
        "algorithm": run.algorithm,
        "rng": run.rng.bit_generator.state,
        "ledger": {f: getattr(run.ledger, f) for f in _LEDGER_FIELDS},
    }
    edge = run.edge
    if edge is not None:
        m["edge"] = {
            "clock_s": edge.clock.now,
            "rng": edge.rng.bit_generator.state,
            "channel_rng": edge.channel._rng.bit_generator.state,
            "drop_reasons": dict(edge.drop_reasons),
            "phase_s": dict(edge.phase_s),
        }
        for f in _EDGE_COUNTERS:
            m["edge"][f] = getattr(edge, f)
        if edge.scenario is not None:
            m["scenario"] = edge.scenario.state_dict()["meta"]
    return m


def save_run(path: str, run) -> None:
    """Checkpoint ``run`` (a sync-mode FederatedRun) at a round
    boundary: arrays to ``path`` (npz tree), scalar state to
    ``path + '.meta.json'``."""
    _check_resumable(run)
    save(path, _array_tree(run))
    meta_path = path + ".meta.json"
    d = os.path.dirname(os.path.abspath(meta_path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(_meta(run), fh)
        os.replace(tmp, meta_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_run(path: str, run):
    """Restore a checkpoint into ``run`` — a freshly constructed
    FederatedRun with the same configs as the saved one — and return
    it.  The fresh run supplies the tree template (dtypes, shapes,
    devices), so a config mismatch fails loudly instead of resuming
    wrong."""
    _check_resumable(run)
    with open(path + ".meta.json") as fh:
        meta = json.load(fh)
    if meta["algorithm"] != run.algorithm:
        raise ValueError(
            f"checkpoint was saved from algorithm {meta['algorithm']!r}, "
            f"this run is {run.algorithm!r}")
    # check the scenario spec BEFORE the array restore: two different
    # scenarios usually disagree on their state arrays too, and the raw
    # KeyError would mask the actual config mismatch
    sc = None if run.edge is None else run.edge.scenario
    if sc is not None and "scenario" in meta:
        ckpt_spec = meta["scenario"].get("spec", sc.spec)
        if ckpt_spec != sc.spec:
            raise ValueError(
                f"scenario spec mismatch: checkpoint has {ckpt_spec!r}, "
                f"this run has {sc.spec!r}")
    tree = restore(path, _array_tree(run))

    run.strategy.load_state_dict(tree["strategy"])
    run.codec_generator.set_state(tree["codec_generator"])
    run.rng.bit_generator.state = meta["rng"]
    for f in _LEDGER_FIELDS:
        setattr(run.ledger, f, meta["ledger"][f])

    edge = run.edge
    if (edge is None) != ("edge" not in meta):
        raise ValueError("checkpoint and run disagree on whether an edge "
                         "runtime is configured")
    if edge is not None:
        em = meta["edge"]
        # a fresh EventClock at the saved simulated time (sync mode: the
        # heap is empty between rounds, only `now` carries over)
        edge.clock = type(edge.clock)(em["clock_s"])
        edge.rng.bit_generator.state = em["rng"]
        edge.channel._rng.bit_generator.state = em["channel_rng"]
        edge.fleet.battery_j[:] = tree["battery_j"]
        for f in _EDGE_COUNTERS:
            setattr(edge, f, em[f])
        edge.drop_reasons = dict(em["drop_reasons"])
        edge.phase_s = dict(em["phase_s"])
        if edge.scenario is not None:
            if "scenario" not in meta:
                raise ValueError("run has a scenario but the checkpoint "
                                 "saved none")
            edge.scenario.load_state_dict(
                {"arrays": tree.get("scenario", {}), "meta": meta["scenario"]})
        elif "scenario" in meta:
            raise ValueError("checkpoint saved scenario state but the run "
                             "has no scenario configured")
    return run
