"""Server-side federated orchestration (port of ``repro.fed.server``).

``FederatedRun`` is a generic round driver over the strategy registry —
it never branches on the algorithm name.  Each registered strategy
declares its per-round resource footprint (a ``RoundPlan``) and supplies
client/aggregate/server steps; the driver owns everything
algorithm-independent:

  * client sampling and per-client resource allocation (optionally
    through a repro_torch.edge AllocationPolicy, fed by the plan's
    predicted *wire* bytes and FLOPs — the policy's RoundDecision fixes
    each selected client's uplink bandwidth share and, optionally, its
    own upload codec),
  * CommLedger metering, driven once per round from the plan — the
    ledger's actuals equal the plan's prediction by construction, under
    every payload codec,
  * upload compression through the run codec (``FedConfig.compress``)
    including the per-client error-feedback residuals the sparsifiers
    need — keyed by true client id, so stale async deltas keep their
    correction,
  * synchronous edge finishing and buffered-async aggregation — async is
    available to any strategy whose plan marks its payload ``summable``,
  * deadline enforcement: a client whose realized finish busts its grant
    is cut off at the barrier (its client step never runs, on-air bytes
    are billed, the on-time partial cohort is aggregated with
    re-normalized weights; async dispatches get per-client expiry
    events that hand granted spectrum back to the pool),
  * observability: spans, events, metrics and the plan-vs-billed
    ``PlanAudit`` through ``tracer=`` (``repro_torch.obs``),
  * checkpoint/resume of sync-mode runs (``save`` / ``restore_from``,
    ``repro_torch.checkpoint.run_state``).

The run lives on one device.  The training set is moved there once; the
client sampling and the whole edge layer draw the reference's numpy
streams call for call, so a seed selects the same cohorts, drops and
clocks as ``repro.fed.server.FederatedRun``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import load_run, save_run
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import CNNConfig
from repro_torch.data.partition import noniid_partition
from repro_torch.data.synthetic import Dataset
from repro_torch.edge.runtime import EdgeRuntime
from repro_torch.fed import codecs, comm, strategies
from repro_torch.obs import trace as obs
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves


def _tree_norm(tree) -> float:
    """L2 norm over every leaf of a tree (error-feedback residuals): each
    leaf's f32 dot, summed in f64, read with one host sync."""
    sq = torch.stack([torch.vdot(leaf.reshape(-1), leaf.reshape(-1))
                      for leaf in tree_leaves(tree)])
    return float(sq.double().sum().sqrt().item())


class FederatedRun:
    """Generic federated round driver: ``algorithm`` resolves through the
    strategy registry; everything per-algorithm lives in the strategy."""

    def __init__(self, model_cfg: CNNConfig, fed_cfg: FedConfig,
                 train: Dataset, test: Dataset, algorithm: str,
                 tracer=None, device="cuda"):
        self.device = resolve_device(device)
        self.mcfg = model_cfg
        self.fcfg = fed_cfg
        self.train, self.test = train, test
        self.algorithm = algorithm
        # obs: spans/events/metrics/audit; the shared no-op default keeps
        # the untraced driver free (one attribute check per site)
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self.rng = np.random.default_rng(fed_cfg.seed)
        self.ledger = comm.CommLedger()
        # per-client error-feedback residuals of the sparsifying codecs
        self._ef_residual: dict[int, object] = {}
        # the codec's random stream (the reference's PRNGKey(seed + 17)
        # chain); a CUDA generator for CUDA payloads
        self.codec_generator = torch.Generator(
            device=self.device).manual_seed(fed_cfg.seed + 17)
        self.partition = noniid_partition(
            train.y, fed_cfg.num_clients, fed_cfg.noniid_l, train.n_classes,
            seed=fed_cfg.seed,
        )
        self.strategy = strategies.get(algorithm)(
            model_cfg, fed_cfg, train.n_classes, device=self.device)
        # round_plan() validates the (strategy, codec) pair
        self.plan = self.strategy.round_plan()
        self.codec = self.strategy.codec
        # ---- optional resource-constrained edge simulation
        self.edge: Optional[EdgeRuntime] = None
        if fed_cfg.edge is not None:
            if fed_cfg.edge.mode == "async" and not self.plan.summable:
                raise ValueError(
                    "async edge mode needs summable client payloads; "
                    f"{algorithm!r} supports sync edge simulation only")
            self.edge = EdgeRuntime(fed_cfg.edge, fed_cfg.num_clients,
                                    fed_cfg.seed, tracer=self.tracer,
                                    device=self.device)
            if self.edge.policy.needs_summable and not self.plan.summable:
                raise ValueError(
                    f"allocation policy {fed_cfg.edge.scheduler!r} emits "
                    "per-client sparsifying codecs, which only additive "
                    f"(summable) payloads survive; {algorithm!r} uploads "
                    "distinct models/components (summable=False)")
        self._edge_est = None
        self._decision = None           # this round's RoundDecision
        self._round_verdict = None      # its DeadlineVerdict (None = no
                                        # finite deadline this round)
        self._flops_cache: dict[int, float] = {}
        # eligible ids + per-client flops are run-constant (the partition
        # never changes)
        self._eligible: Optional[list[int]] = None
        self._eligible_flops: Optional[np.ndarray] = None
        self._train_x = torch.from_numpy(train.x).to(self.device)
        self._train_y = torch.from_numpy(train.y).to(self.device)
        self._client_idx: dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------------
    # checkpoint/resume (repro_torch.checkpoint.run_state): sync-mode runs
    # round-trip bit-identically — save at a round boundary, restore
    # into a freshly constructed run with the same configs
    def save(self, path: str) -> None:
        save_run(path, self)

    def restore_from(self, path: str) -> "FederatedRun":
        return load_run(path, self)

    @property
    def params(self):
        return getattr(self.strategy, "params", None)

    # ------------------------------------------------------------------
    # planning: the strategy's RoundPlan feeds scheduling + estimation
    def _plan_flops(self, k: int) -> float:
        """Per-client round FLOPs (partition sizes are run-constant)."""
        if k not in self._flops_cache:
            self._flops_cache[k] = self.plan.flops(len(self.partition[k]))
        return self._flops_cache[k]

    def _wire_fn(self, codec=None) -> tuple[float, float]:
        """One client's (aggregatable, non-aggregatable) upload wire
        bytes under a per-client codec override (None = the plan's
        phase codecs): the one byte authority the allocation policy, the
        ledger and the edge clock all consume."""
        agg = nonagg = 0.0
        for ph in self.plan.phases:
            if not ph.up_floats:
                continue
            wire = (codec or ph.codec).wire_bytes(ph.up_floats)
            if ph.aggregatable:
                agg += wire
            else:
                nonagg += wire
        return agg, nonagg

    def _decision_bytes(self) -> tuple[np.ndarray, np.ndarray]:
        """(total, non-aggregatable) per-client wire bytes aligned with
        the current decision's selected cohort."""
        if not self._decision.heterogeneous_codecs:
            n = self._decision.n_selected
            agg0, nonagg0 = self._wire_fn(None)
            return np.full(n, agg0 + nonagg0), np.full(n, nonagg0)
        pairs = [self._wire_fn(self._decision.codec_for(i))
                 for i in self._decision.selected]
        agg = np.asarray([p[0] for p in pairs])
        nonagg = np.asarray([p[1] for p in pairs])
        return agg + nonagg, nonagg

    def sample_clients(self) -> list[int]:
        k = max(1, int(self.fcfg.participation * self.fcfg.num_clients))
        if self._eligible is None:
            self._eligible = [i for i in range(self.fcfg.num_clients)
                              if len(self.partition[i]) > 0]
            self._eligible_flops = np.asarray(
                [self._plan_flops(i) for i in self._eligible])
        eligible = self._eligible
        if self.edge is None:
            return list(self.rng.choice(eligible, size=min(k, len(eligible)),
                                        replace=False))
        flops = self._eligible_flops
        if self.edge.async_agg is not None:  # don't re-pick in-flight clients
            eligible = [i for i in eligible if i not in self.edge.busy]
            flops = np.asarray([self._plan_flops(i) for i in eligible])
        selected, est, decision = self.edge.decide(
            k, eligible, self._wire_fn, flops,
            summable=self.plan.summable, codec=self.codec)
        self._edge_est = est
        self._decision = decision
        # pin the round <-> verdict pairing at decide time, so metering
        # can never scale bytes by a different round's tx_frac
        self._round_verdict = self.edge.verdicts[-1]
        return selected

    def _meter_round(self, selected: list[int]) -> None:
        """CommLedger metering, generically from the plan: the ledger's
        actuals are the plan's predictions by construction — also under
        per-client codec overrides, where each client is billed its own
        wire size.  An empty cohort still counts as a round but bills
        nothing.

        Deadline drops truncate billing: a client cut off at the barrier
        is billed only the ``tx_frac`` of its upload that was on the air
        before the cutoff, and the Gram scalar exchange covers only the
        clients whose uploads landed — so ledger ≤ plan, with equality
        iff nobody was dropped.

        With a tracer attached, every ledger delta is mirrored into the
        ``bytes_wire_total`` counter and every upload adds a
        per-(round, client, phase) planned-vs-billed row to the
        :class:`~repro_torch.obs.metrics.PlanAudit`."""
        n_selected = len(selected)
        if n_selected == 0:
            self.ledger.end_round()
            return
        tr = self.tracer
        rid = self.ledger.rounds        # 0-based: end_round not called yet
        hetero = (self._decision is not None
                  and self._decision.heterogeneous_codecs)
        verdict = self._round_verdict
        frac = {}
        frac_arr = None
        if verdict is not None and verdict.any_dropped:
            frac = {int(c): float(f)
                    for c, f in zip(verdict.clients, verdict.tx_frac,
                                    strict=True)
                    if f < 1.0}
            # aligned fast path: on the edge sync path the verdict judges
            # exactly the selected cohort in order
            if np.array_equal(verdict.clients, np.asarray(selected)):
                frac_arr = verdict.tx_frac
            else:
                frac_arr = np.asarray([frac.get(int(i), 1.0)
                                       for i in selected])
        for ph in self.plan.phases:
            if ph.down_floats:
                # every selected client received the broadcast, including
                # the ones later cut off on the uplink
                added = self.ledger.broadcast(ph.down_floats, n_selected)
                if tr.enabled:
                    tr.metrics.counter("bytes_wire_total").inc(
                        added, direction="down", topology="shared",
                        phase=ph.name, codec="none")
            if not ph.up_floats:
                continue
            if hetero:
                planned = [(self._decision.codec_for(i) or ph.codec)
                           .wire_bytes(ph.up_floats) for i in selected]
                billed = [w * frac.get(int(i), 1.0)
                          for w, i in zip(planned, selected, strict=True)]
                d_star, d_tree = self.ledger.upload_per_client(
                    billed, aggregatable=ph.aggregatable)
                codec_label = "per_client"
            elif frac:
                # uniform codec + deadline drops: tx_frac of the uniform
                # wire size as one array op
                w_uniform = ph.wire_up_bytes()
                planned = np.full(n_selected, w_uniform)
                billed = planned * frac_arr
                d_star, d_tree = self.ledger.upload_per_client(
                    billed, aggregatable=ph.aggregatable)
                codec_label = ph.codec.spec()
            else:
                w_uniform = ph.wire_up_bytes()
                planned = billed = [w_uniform] * n_selected
                d_star, d_tree = self.ledger.upload(
                    ph.up_floats, n_selected, aggregatable=ph.aggregatable,
                    wire_bytes=w_uniform)
                codec_label = ph.codec.spec()
            if tr.enabled:
                c = tr.metrics.counter("bytes_wire_total")
                c.inc(d_star, direction="up", topology="star",
                      phase=ph.name, codec=codec_label)
                c.inc(d_tree, direction="up", topology="tree",
                      phase=ph.name, codec=codec_label)
                for i, p, b in zip(selected, planned, billed, strict=True):
                    tr.audit.add(rid, int(i), ph.name, p, b)
        n_landed = n_selected - (0 if self._decision is None
                                 else self._decision.n_dropped)
        n_scalars = (self.plan.round_scalars
                     + self.plan.scalars_per_client * n_landed)
        if n_scalars and n_landed:
            added = self.ledger.scalars(n_scalars)
            if tr.enabled:
                tr.metrics.counter("bytes_wire_total").inc(
                    added, direction="scalar", topology="shared",
                    phase="gram", codec="none")
        self.ledger.end_round()

    def _edge_sync_finish(self, info: dict) -> dict:
        if self.edge is not None and self.edge.async_agg is None:
            # per-client byte arrays, so heterogeneous codecs cost each
            # uplink correctly; the plan's aggregatable flags carve out
            # the share that must reach the root individually
            up, nonagg = self._decision_bytes()
            rec = self.edge.finish_round_sync(
                self._edge_est, up, self.plan.downlink_bytes(),
                nonagg_bytes=nonagg)
            info.update(wall_s=rec["wall_s"], sim_time_s=rec["clock_s"],
                        energy_j=rec["energy_j"])
            if "barrier_s" in rec:
                info["barrier_s"] = rec["barrier_s"]
        return info

    def _client_data(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        idx = self._client_idx.get(k)
        if idx is None:
            idx = torch.from_numpy(self.partition[k]).to(self.device)
            self._client_idx[k] = idx
        return self._train_x[idx], self._train_y[idx]

    def _compress(self, payload, cid: int, codec):
        """Round-trip one client's payload through ``codec`` with its
        error-feedback residual; traced runs also record the encode's
        wall time, the achieved ratio and the residual's norm."""
        residual = self._ef_residual.get(cid)
        if not self.tracer.enabled:
            return self.strategy.compress_payload(
                payload, self.codec_generator, residual, codec=codec)
        # wall-clock encode cost + achieved ratio live in the metrics
        # registry only — never on the sim timeline, so traced replays
        # stay deterministic; the device is synchronised only here
        t0 = time.perf_counter()
        payload, res = self.strategy.compress_payload(
            payload, self.codec_generator, residual, codec=codec)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        m = self.tracer.metrics
        m.histogram("codec_encode_s").observe(time.perf_counter() - t0,
                                              codec=codec.spec())
        n_up = sum(ph.up_floats for ph in self.plan.phases)
        m.gauge("codec_ratio").set(codecs.achieved_ratio(codec, n_up),
                                   codec=codec.spec())
        if res is not None:
            m.gauge("ef_residual_norm").set(_tree_norm(res), client=cid)
        return payload, res

    def round(self) -> dict:
        """One generic federated round: meter from the plan, run the
        optional cohort pre-phase, collect the landed clients' payloads
        (round-tripped through the run codec or the policy's per-client
        codec, with per-client error feedback), then either dispatch
        into the async buffer or aggregate synchronously.

        An empty cohort is recorded as ``cohort=0`` with no ``loss``
        entry and the server step skipped.  Clients the runtime cut off
        at the barrier (``decision.dropped``) never land: their client
        step is not run (no partial delta, no error-feedback update)."""
        selected = self.sample_clients()
        n_dropped = (0 if self._decision is None
                     else self._decision.n_dropped)
        # survivors preserves selection order on both decision types
        landed = (selected if not n_dropped
                  else self._decision.survivors)
        self._meter_round(selected)
        datas = [self._client_data(i) for i in landed]
        context = self.strategy.round_context(datas, self.rng)
        payloads, weights, losses = [], [], []
        for j, (cid, data) in enumerate(zip(landed, datas, strict=True)):
            payload, loss = self.strategy.client_step(
                data, self.rng, None if context is None else context[j])
            # the allocation policy may hand this client its own wire
            # format (adaptive_codec); it runs the run's kernel knob
            codec = self.codec
            if self._decision is not None:
                override = self._decision.codec_for(cid)
                if override is not None:
                    codec = codecs.make(override, kernels=self.fcfg.kernels)
            if not codec.identity:
                payload, res = self._compress(payload, int(cid), codec)
                if res is not None:
                    self._ef_residual[int(cid)] = res
            payloads.append(payload)
            weights.append(len(data[0]))
            losses.append(loss)
        info = {"cohort": len(landed)}
        if n_dropped:
            info["dropped"] = n_dropped
        if losses:
            # the round's one host sync: the per-client losses
            host = torch.stack(losses).double().cpu().numpy()
            info["loss"] = float(np.mean(host))
        if self.edge is not None and self.edge.async_agg is not None:
            # buffered async: dispatch this cohort, aggregate whatever
            # buffer of (possibly stale) results arrives first
            self.edge.dispatch_async(self._edge_est, weights, payloads,
                                     self.plan.downlink_bytes())
            entries, w_st = self.edge.pop_async_buffer()
            if entries:
                agg = self.strategy.aggregate(
                    [e.payload for e in entries],
                    torch.tensor(np.asarray(w_st), dtype=torch.float32,
                                 device=self.device))
                self.strategy.server_step(agg)
            rec = self.edge.history[-1]
            info.update(wall_s=rec["wall_s"], sim_time_s=rec["clock_s"],
                        energy_j=rec["energy_j"], aggregated=len(entries))
            return info
        if payloads:
            agg = self.strategy.aggregate(
                payloads, torch.tensor(weights, dtype=torch.float32,
                                       device=self.device))
            self.strategy.server_step(agg)
        return self._edge_sync_finish(info)

    def evaluate(self, max_examples: int = 2000) -> float:
        x = torch.from_numpy(self.test.x[:max_examples]).to(self.device)
        y = torch.from_numpy(self.test.y[:max_examples]).to(self.device)
        return self.strategy.evaluate(x, y)

    def run(self, rounds: Optional[int] = None, eval_every: int = 5,
            target_accuracy: Optional[float] = None, verbose: bool = False):
        """Drive ``rounds`` federated rounds, evaluating every
        ``eval_every``.  Per-round progress goes through the tracer's
        structured log (``log_round``): the default NULL_TRACER renders
        the reference's line to stdout when ``verbose``; a real
        ``Tracer`` also keeps every record for export."""
        rounds = rounds or self.fcfg.rounds
        history = []
        for t in range(rounds):
            info = self.round()
            info["round"] = t + 1
            is_eval = (t + 1) % eval_every == 0 or t == rounds - 1
            if is_eval:
                info["accuracy"] = self.evaluate()
            self.tracer.log_round(info, render=verbose and is_eval)
            history.append(info)
            if (is_eval and target_accuracy
                    and info["accuracy"] >= target_accuracy):
                return history
        return history
