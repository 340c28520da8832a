"""EdgeConfig + EdgeRuntime: the glue under ``FederatedRun``.

``EdgeConfig`` is an optional field on ``FedConfig``; when present, the
federated loop routes client selection AND per-client resource
allocation through an :class:`repro_torch.edge.allocation.AllocationPolicy`
and converts every round's (already ledger-counted) bytes plus the
client compute work into simulated wall-clock time and energy:

  sync round   wall = t_downlink + max_k t_comp,k + t_agg(topology)
  async round  wall = until the aggregation buffer fills (stragglers
                      land in later buffers, staleness-discounted)

Each round the policy sees a :class:`RoundState` (eligible clients with
cost estimates under a nominal equal split of ``bandwidth_budget_hz``)
and returns a :class:`RoundDecision`: per selected client an uplink
subchannel width drawn from the shared budget and, optionally, a
per-client upload codec.  Bandwidth-only policies never change WHAT is
transmitted — `CommLedger` byte counts are allocation-independent, only
WHO transmits, WHEN it lands, and HOW FAST it crosses the air change;
per-client codecs change bytes only through their ``wire_bytes``, and
the ledger still equals the plan per client.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.edge.allocation import (JIT_NOT_PORTED, ClientEstimate,
                                         FleetDecision, FleetRoundState,
                                         RoundDecision, RoundState,
                                         make_policy)
from repro_torch.edge.async_agg import AsyncAggregator
from repro_torch.edge.channel import Channel, ChannelConfig
from repro_torch.edge.device import DeviceConfig, DeviceFleet
from repro_torch.edge.events import (DEADLINE_EXPIRED, DeadlineVerdict,
                                     EventClock, enforce_deadlines,
                                     reallocated_finish)
from repro_torch.edge.scenario import RoundEffects, Scenario, make_scenario
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import reason_key


@dataclass(frozen=True)
class EdgeConfig:
    """Knobs for the simulated wireless edge (all times seconds, energies
    joules).  ``scheduler`` names the allocation policy (the legacy field
    name is kept): uniform | deadline | energy_threshold |
    capacity_proportional | bandwidth_opt | energy_opt | adaptive_codec,
    or any registered ``repro_torch.edge.allocation`` name;
    ``mode`` ∈ {sync, async}.

    ``bandwidth_budget_hz`` is the shared round uplink budget every
    policy apportions; 0 (default) resolves to ``k × channel.bandwidth_hz``
    — the equal-split policies then reproduce the fixed-subchannel
    behavior exactly at full cohort."""
    channel: ChannelConfig = field(default_factory=ChannelConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    scheduler: str = "uniform"           # allocation-policy name
    bandwidth_budget_hz: float = 0.0     # 0 -> k * channel.bandwidth_hz
    deadline_s: float = 1.0              # deadline / energy_opt policies
    min_clients: int = 1
    # runtime deadline enforcement: Allocation.deadline_s is a contract —
    # a client whose realized finish exceeds min(its grant,
    # enforce_deadline_s) is cut off at the barrier (upload discarded,
    # only on-air bytes billed).  enforce_deadline_s (inf = off) is a
    # hard per-round cap applied to EVERY client regardless of policy;
    # deadline_tolerance_s is the slack before a finish counts as late
    # (absorbs predicted-vs-realized float jitter — it widens admission,
    # never the billing cutoff).
    enforce_deadline_s: float = float("inf")
    deadline_tolerance_s: float = 1e-9
    battery_floor_j: float = 0.0         # energy_threshold policy
    round_budget_j: float = float("inf")
    adaptive_ratio: float = 0.25         # adaptive_codec: top-k ratio at the
    adaptive_ratio_floor: float = 0.02   # cohort-median rate, and its floor
    mode: str = "sync"
    buffer_size: int = 0                 # async: 0 -> ceil(cohort/2)
    staleness_alpha: float = 0.5         # async: (1+τ)^-alpha discount
    seed: int = 0
    # fleet fast path (the reference's repro.edge.fleet): run the sync hot path as array
    # ops over the population instead of per-client dicts.  "auto"
    # engages it when the population reaches fleet_threshold (and the
    # policy has a vectorized form; sync mode only — the async tail
    # keeps the EventClock/dict path).  fleet_backend "exact" uses the
    # shared vectorized-numpy cores (bit-identical to the dict path);
    # "jit" the x64 lax kernels (equal up to float reassociation).
    fleet: str = "auto"                  # "auto" | "on" | "off"
    fleet_threshold: int = 4096          # auto: engage at population >= this
    fleet_backend: str = "exact"         # "exact" | "jit"
    # fleet rounds keep tracing O(summary): per-client spans/events are
    # emitted only while the cohort fits this cap (the chrome exporter's
    # top_k_clients bounds the file the same way)
    trace_top_k_clients: int = 64
    # scenario: availability churn + fault injection, a
    # repro_torch.edge.scenario spec string (e.g. "diurnal:period=600,amp=0.4"
    # or "markov:p_drop=0.2|snr_burst:prob=0.3,scale=0.25"); None keeps
    # the static always-reachable fleet.  The scenario draws from its
    # own seeded stream (seed + cfg.seed + 4), so enabling one never
    # perturbs the channel/fleet/policy draws of an existing replay.
    scenario: Optional[str] = None
    # mid-round re-allocation: when enforce_deadlines cuts a straggler,
    # re-offer its granted width to the surviving uploaders still on the
    # air (pro rata, piecewise-constant in time) — the drop set, tx
    # fractions and billing are unchanged, only the realized barrier
    # shrinks.  Sync mode; opt-in.
    reallocate: bool = False

    def __post_init__(self):
        if self.fleet not in ("auto", "on", "off"):
            raise ValueError(f"EdgeConfig.fleet must be 'auto', 'on' or "
                             f"'off', got {self.fleet!r}")
        if self.fleet_backend not in ("exact", "jit"):
            raise ValueError(f"EdgeConfig.fleet_backend must be 'exact' or "
                             f"'jit', got {self.fleet_backend!r}")
        if self.fleet_backend == "jit":
            raise NotImplementedError(f"EdgeConfig: {JIT_NOT_PORTED}")


class EdgeRuntime:
    """Mutable per-run edge state: channel fading, fleet batteries, the
    simulation clock, and (in async mode) the in-flight buffer."""

    def __init__(self, cfg: EdgeConfig, num_clients: int, seed: int = 0,
                 tracer=None):
        self.cfg = cfg
        self.num_clients = num_clients
        # obs: spans/events/metrics go here; the shared no-op default
        # keeps the untraced hot path free (one attribute check per site)
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        s = seed + cfg.seed
        self.channel = Channel(cfg.channel, num_clients, seed=s + 1)
        self.fleet = DeviceFleet(cfg.device, num_clients, seed=s + 2)
        self.rng = np.random.default_rng(s + 3)
        self.scenario: Optional[Scenario] = (
            make_scenario(cfg.scenario, num_clients, seed=s + 4)
            if cfg.scenario else None)
        self._effects: Optional[RoundEffects] = None  # this round's scenario
        self.clock = EventClock()
        # make_policy drops the knobs a policy does not accept, so every
        # EdgeConfig knob can ride along unconditionally
        self.policy = make_policy(
            cfg.scheduler, deadline_s=cfg.deadline_s,
            min_clients=cfg.min_clients, battery_floor_j=cfg.battery_floor_j,
            round_budget_j=cfg.round_budget_j, ratio=cfg.adaptive_ratio,
            ratio_floor=cfg.adaptive_ratio_floor)
        self.async_agg: Optional[AsyncAggregator] = None
        if cfg.mode == "async":
            # buffer_size 0 = auto: half the dispatched cohort, resolved at
            # the first dispatch (see dispatch_async)
            self.async_agg = AsyncAggregator(
                self.clock, buffer_size=max(cfg.buffer_size, 1),
                alpha=cfg.staleness_alpha, tracer=self.tracer)
        self.busy: set[int] = set()      # async: clients with work in flight
        self._held_hz: dict[int, float] = {}  # async: spectrum still on the
                                              # air from earlier dispatches
        self._expiry: dict[int, float] = {}   # async: client -> clock time a
                                              # busted grant lapses (spectrum
                                              # + busy released then)
        self._expired_unrecorded = 0     # async: grants that lapsed outside
                                         # a pop (decide-time release), still
                                         # owed to a history record
        self._buffer_resolved = False    # async auto-buffer picked yet?
        self.energy_j = 0.0
        self.dropped_total = 0           # policy exclusions (a priori)
        self.deadline_dropped_total = 0  # runtime cutoffs (at the barrier)
        self.unavailable_total = 0       # scenario: never answered the round
        self.realloc_rounds = 0          # rounds where freed width re-landed
        # breakdowns for summary(): why clients never landed (exclusion
        # reason buckets + runtime "deadline" cutoffs), and where the
        # simulated seconds went — maintained unconditionally (cheap),
        # mirrored into tracer metrics when tracing is on
        self.drop_reasons: dict[str, int] = {}
        self.phase_s = {"downlink": 0.0, "barrier": 0.0, "drain": 0.0}
        self.history: list[dict] = []
        self.decisions: list[RoundDecision] = []
        # one verdict per decision (None when no finite deadline applies);
        # _verdict is the pending one finish_round_sync / dispatch_async
        # consumes for the in-progress round
        self.verdicts: list[Optional[DeadlineVerdict]] = []
        self._verdict: Optional[DeadlineVerdict] = None
        self._fleet_round = False   # last commit used the fleet fast path
                                    # (caps per-client tracing to
                                    # cfg.trace_top_k_clients)

    # ------------------------------------------------------------------
    def fleet_active(self) -> bool:
        """Whether rounds run on the struct-of-arrays fast path: enabled
        by cfg.fleet ("on", or "auto" once the population reaches
        fleet_threshold), sync mode only (the async tail keeps the
        EventClock/dict path), and only for policies with a vectorized
        form — others silently fall back to the scalar path."""
        cfg = self.cfg
        if cfg.mode != "sync" or cfg.fleet == "off":
            return False
        if cfg.fleet == "auto" and self.num_clients < cfg.fleet_threshold:
            return False
        return bool(getattr(self.policy, "vectorized", False))

    # ------------------------------------------------------------------
    def budget_hz(self, k: int) -> float:
        """The shared round bandwidth budget (0 = auto: k subchannels).
        In async mode, spectrum still held by in-flight uploads from
        earlier dispatches is subtracted — a straggler keeps its granted
        subchannel until its payload lands, so a new cohort can only be
        carved from what is actually free (the pool is never
        oversubscribed; with the auto budget and equal splits this
        reproduces the fixed-subchannel model exactly)."""
        if self.cfg.bandwidth_budget_hz > 0:
            total = float(self.cfg.bandwidth_budget_hz)
        else:
            total = float(max(k, 1)) * self.channel.cfg.bandwidth_hz
        return max(total - sum(self._held_hz.values()), 0.0)

    def estimate(self, clients, up_bytes, flops) -> ClientEstimate:
        """Predicted per-client round cost at the channel's CURRENT
        per-client rates.  ``up_bytes`` and ``flops`` are scalars or (n,)
        arrays aligned with ``clients`` (per-client codecs / |D_k|)."""
        c = np.asarray(clients, dtype=int)
        fl = np.broadcast_to(np.asarray(flops, dtype=float), c.shape)
        t_comp = fl / np.maximum(self.fleet.flops_per_s[c], 1.0)
        t_up = self.channel.uplink_time_s(up_bytes, c)
        e_comp = fl * self.fleet.cfg.joules_per_flop
        e_tx = self.channel.uplink_energy_j(up_bytes, c)
        return ClientEstimate(clients=c, time_s=t_comp + t_up,
                              energy_j=e_comp + e_tx,
                              battery_j=self.fleet.battery_j[c].copy())

    def _empty_est(self) -> ClientEstimate:
        return ClientEstimate(np.zeros(0, int), np.zeros(0), np.zeros(0),
                              np.zeros(0))

    def _round_state(self, k: int, clients: np.ndarray, wire_fn, flops,
                     summable: bool, codec=None, payload_mult=None
                     ) -> RoundState:
        """Nominal equal split of the budget -> estimates -> RoundState."""
        budget = self.budget_hz(k)
        self.channel.set_bandwidth(clients, budget / max(k, 1))
        agg0, nonagg0 = wire_fn(None)
        mult = (np.ones(clients.shape) if payload_mult is None
                else np.asarray(payload_mult, dtype=float))
        fl = np.broadcast_to(np.asarray(flops, dtype=float), clients.shape)
        est = self.estimate(clients, (agg0 + nonagg0) * mult, fl)
        t_comp = fl / np.maximum(self.fleet.flops_per_s[clients], 1.0)
        return RoundState(
            k=k, est=est, t_comp_s=t_comp,
            spectral_eff=self.channel.spectral_efficiency(clients),
            budget_hz=budget, rng=self.rng, codec=codec, summable=summable,
            wire_fn=wire_fn, payload_mult=payload_mult)

    def _apply(self, decision: RoundDecision, state: RoundState, wire_fn,
               flops) -> ClientEstimate:
        """Commit a decision: per-client subchannel widths into the
        channel, re-estimate the selected cohort at its allocated rates
        and per-client wire bytes, then judge the realized finishes
        against the granted deadlines (``_enforce``).  ``flops`` aligns
        with ``state.est.clients``."""
        self._fleet_round = False
        self.decisions.append(decision)
        self.dropped_total += len(decision.excluded)
        rid = len(self.decisions) - 1
        for reason in decision.excluded.values():
            key = f"excluded:{reason_key(reason)}"
            self.drop_reasons[key] = self.drop_reasons.get(key, 0) + 1
        tr = self.tracer
        if tr.enabled:
            for _cid, reason in decision.excluded.items():
                tr.metrics.counter("excluded_total").inc(
                    1, reason=reason_key(reason), policy=self.policy.name)
            for cid, a in decision.allocations.items():
                tr.event(obs.ALLOCATE, obs.CAT_CLIENT, self.clock.now,
                         round_id=rid, client=int(cid),
                         bandwidth_hz=float(a.bandwidth_hz),
                         deadline_s=(float(a.deadline_s)
                                     if np.isfinite(a.deadline_s) else None),
                         codec=(None if a.codec is None else a.codec.spec()))
        sel = decision.selected
        if not sel:
            self.verdicts.append(None)
            self._verdict = None
            return self._empty_est()
        pos = {int(c): j for j, c in enumerate(state.est.clients)}
        missing = [int(i) for i in sel if int(i) not in pos]
        if missing:
            raise ValueError(
                f"allocation policy {self.policy.name!r} selected client "
                f"ids {missing} outside the round's eligible set of "
                f"{len(state.est.clients)} clients")
        self.channel.set_bandwidth(sel, decision.bandwidth())
        mult = state.mult()
        up = np.asarray([sum(wire_fn(decision.codec_for(i)))
                         * mult[pos[int(i)]] for i in sel], dtype=float)
        fl_sel = np.asarray([flops[pos[int(i)]] for i in sel], dtype=float)
        fl_sel = self._realized_faults(sel, fl_sel, decision.bandwidth())
        est_sel = self.estimate(sel, up, fl_sel)
        self._enforce(decision, est_sel, fl_sel)
        return est_sel

    def _enforce(self, decision: RoundDecision, est_sel: ClientEstimate,
                 fl_sel: np.ndarray) -> None:
        """Judge the allocated cohort's REALIZED finishes (compute +
        uplink at the granted widths, this round's channel draw) against
        the effective per-client deadlines: min(the policy's grant,
        cfg.enforce_deadline_s).  Late clients are marked dropped on the
        decision with a reason; the verdict (drop mask + on-air byte
        fractions) is held for finish_round_sync / dispatch_async."""
        c = est_sel.clients
        grants = np.asarray([decision.allocations[int(i)].deadline_s
                             for i in c], dtype=float)
        d_eff = np.minimum(grants, self.cfg.enforce_deadline_s)
        if not np.isfinite(d_eff).any():
            self.verdicts.append(None)
            self._verdict = None
            return
        t_comp = fl_sel / np.maximum(self.fleet.flops_per_s[c], 1.0)
        verdict = enforce_deadlines(c, est_sel.time_s, t_comp, d_eff,
                                    self.cfg.deadline_tolerance_s,
                                    tracer=self.tracer, t0=self.clock.now,
                                    round_id=len(self.decisions) - 1)
        decision.dropped.update(verdict.reasons())
        self._maybe_reallocate(
            est_sel, verdict,
            [decision.allocations[int(i)].bandwidth_hz for i in c], d_eff)
        self.deadline_dropped_total += verdict.n_dropped
        if verdict.n_dropped:
            self.drop_reasons["deadline_cutoff"] = (
                self.drop_reasons.get("deadline_cutoff", 0)
                + verdict.n_dropped)
            if self.tracer.enabled:
                self.tracer.metrics.counter("drops_total").inc(
                    verdict.n_dropped, reason="deadline",
                    policy=self.policy.name)
        self.verdicts.append(verdict)
        self._verdict = verdict

    def _fleet_state(self, k: int, clients: np.ndarray, wire_fn, fl,
                     payload_mult=None) -> tuple[FleetRoundState, float]:
        """The struct-of-arrays twin of :meth:`_round_state`: identical
        channel writes and float ops, no per-client dicts and no eligible-
        set estimate (the vectorized policies never consult it)."""
        budget = self.budget_hz(k)
        self.channel.set_bandwidth(clients, budget / max(k, 1))
        agg0, nonagg0 = wire_fn(None)
        t_comp = fl / np.maximum(self.fleet.flops_per_s[clients], 1.0)
        fstate = FleetRoundState(
            k=k, ids=clients, t_comp_s=t_comp,
            spectral_eff=self.channel.spectral_efficiency(clients),
            budget_hz=budget, rng=self.rng, up_bits=8.0 * (agg0 + nonagg0),
            payload_mult=payload_mult, backend=self.cfg.fleet_backend)
        return fstate, agg0 + nonagg0

    def _decide_fleet(self, k: int, clients: np.ndarray, wire_fn, fl,
                      payload_mult=None
                      ) -> tuple[FleetDecision, ClientEstimate]:
        fstate, tot_bytes = self._fleet_state(k, clients, wire_fn, fl,
                                              payload_mult=payload_mult)
        decision = self.policy.decide_vectorized(fstate)
        assert decision is not None, \
            f"policy {self.policy.name!r} advertises vectorized=True but " \
            f"decide_vectorized returned None"
        decision.validate()
        est_sel = self._commit_fleet(decision, fstate, tot_bytes, fl)
        return decision, est_sel

    def _commit_fleet(self, decision: FleetDecision,
                      fstate: FleetRoundState, tot_bytes: float,
                      fl: np.ndarray) -> ClientEstimate:
        """The fleet twin of :meth:`_apply` + :meth:`_enforce`: identical
        bookkeeping and float ops (realized estimate at granted widths,
        deadline verdict), array-shaped.  Tracing is summary-level past
        ``cfg.trace_top_k_clients`` — counters stay exact, per-client
        events are skipped — so a traced fleet round stays O(cohort) in
        metrics and O(top-k) in span volume."""
        self._fleet_round = True
        self.decisions.append(decision)
        self.dropped_total += decision.n_excluded
        rid = len(self.decisions) - 1
        if decision.n_excluded:
            key = f"excluded:{decision.excluded_bucket or 'policy'}"
            self.drop_reasons[key] = (self.drop_reasons.get(key, 0)
                                      + decision.n_excluded)
        tr = self.tracer
        trace_clients = (tr.enabled and decision.n_selected
                         <= self.cfg.trace_top_k_clients)
        if tr.enabled:
            if decision.n_excluded:
                tr.metrics.counter("excluded_total").inc(
                    decision.n_excluded,
                    reason=decision.excluded_bucket or "policy",
                    policy=self.policy.name)
            if trace_clients:
                for cid, w, d in zip(decision.ids,
                                     decision.bandwidth_hz_arr,
                                     decision.deadline_s_arr,
                                     strict=True):
                    tr.event(obs.ALLOCATE, obs.CAT_CLIENT, self.clock.now,
                             round_id=rid, client=int(cid),
                             bandwidth_hz=float(w),
                             deadline_s=(float(d) if np.isfinite(d)
                                         else None),
                             codec=None)
            elif decision.n_selected:
                tr.event(obs.ALLOCATE, obs.CAT_ROUND, self.clock.now,
                         round_id=rid, cohort=decision.n_selected,
                         total_hz=decision.total_bandwidth_hz(),
                         min_hz=float(decision.bandwidth_hz_arr.min()),
                         max_hz=float(decision.bandwidth_hz_arr.max()))
        if decision.n_selected == 0:
            self.verdicts.append(None)
            self._verdict = None
            return self._empty_est()
        sel = decision.positions
        self.channel.set_bandwidth(decision.ids, decision.bandwidth_hz_arr)
        up = tot_bytes * fstate.mult()[sel]
        fl_sel = self._realized_faults(decision.ids, fl[sel],
                                       decision.bandwidth_hz_arr)
        est_sel = self.estimate(decision.ids, up, fl_sel)
        d_eff = np.minimum(decision.deadline_s_arr,
                           self.cfg.enforce_deadline_s)
        if not np.isfinite(d_eff).any():
            self.verdicts.append(None)
            self._verdict = None
            return est_sel
        t_comp = fl_sel / np.maximum(
            self.fleet.flops_per_s[decision.ids], 1.0)
        verdict = enforce_deadlines(
            decision.ids, est_sel.time_s, t_comp, d_eff,
            self.cfg.deadline_tolerance_s,
            tracer=(self.tracer if trace_clients else None),
            t0=self.clock.now, round_id=rid)
        decision.set_verdict(verdict)
        self._maybe_reallocate(est_sel, verdict, decision.bandwidth_hz_arr,
                               d_eff)
        self.deadline_dropped_total += verdict.n_dropped
        if verdict.n_dropped:
            self.drop_reasons["deadline_cutoff"] = (
                self.drop_reasons.get("deadline_cutoff", 0)
                + verdict.n_dropped)
            if tr.enabled:
                tr.metrics.counter("drops_total").inc(
                    verdict.n_dropped, reason="deadline",
                    policy=self.policy.name)
        self.verdicts.append(verdict)
        self._verdict = verdict
        return est_sel

    # -- scenario (repro_torch.edge.scenario): churn, faults, re-allocation --
    def _begin_scenario_round(self, eligible: np.ndarray, fl: np.ndarray
                              ) -> tuple[np.ndarray, np.ndarray,
                                         Optional[np.ndarray]]:
        """Draw this round's scenario effects and apply the
        allocation-visible ones: the availability mask filters the
        eligible set (absences bucketed ``unavailable`` for the process,
        ``fault`` for blackout/battery-gate injectors), and workload
        shedding scales the FLOPs + upload floats every policy sizes
        against.  Returns the filtered ``(eligible, flops,
        payload_mult)``; the realized-side faults are held on
        ``self._effects`` for :meth:`_realized_faults`."""
        self._effects = None
        if self.scenario is None:
            return eligible, fl, None
        eff = self._effects = self.scenario.begin_round(
            len(self.decisions), self.clock.now, self.fleet.battery_j)
        avail = eff.available[eligible]
        n_fault = int(eff.fault_off[eligible].sum())
        n_proc = int((eff.proc_off[eligible]
                      & ~eff.fault_off[eligible]).sum())
        self.unavailable_total += n_proc + n_fault
        if n_proc:
            self.drop_reasons["unavailable"] = (
                self.drop_reasons.get("unavailable", 0) + n_proc)
        if n_fault:
            self.drop_reasons["fault"] = (
                self.drop_reasons.get("fault", 0) + n_fault)
        tr = self.tracer
        if tr.enabled:
            tr.metrics.gauge("availability_frac").set(
                float(avail.mean()) if avail.size else 0.0)
            if n_proc:
                tr.metrics.counter("excluded_total").inc(
                    n_proc, reason="unavailable", policy=self.policy.name)
            if n_fault:
                tr.metrics.counter("excluded_total").inc(
                    n_fault, reason="fault", policy=self.policy.name)
            if (n_fault or eff.has_channel_fault or eff.has_compute_fault
                    or eff.has_shedding):
                tr.event(obs.FAULT, obs.CAT_ROUND, self.clock.now,
                         round_id=len(self.decisions), forced_off=n_fault,
                         snr_hit=int((eff.snr_scale != 1.0).sum()),
                         slowed=int((eff.compute_scale != 1.0).sum()),
                         workload_frac=float(eff.workload_frac.mean()))
        eligible, fl = eligible[avail], fl[avail]
        mult = None
        if eligible.size and eff.has_shedding:
            mult = eff.workload_frac[eligible]
            fl = fl * mult
        return eligible, fl, mult

    def _realized_faults(self, ids, fl_sel: np.ndarray,
                         widths) -> np.ndarray:
        """Apply the realized-side scenario faults to a committed
        cohort: SNR bursts degrade the channel AFTER the grant (the
        policy provisioned against the clean draw; the granted widths
        are re-applied at the degraded SNR), and straggler slowdowns
        scale the realized FLOPs — time and, at fixed power, energy.
        Returns the (possibly scaled) per-client flops."""
        eff = self._effects
        if eff is None:
            return fl_sel
        ids = np.asarray(ids, dtype=int)
        if eff.has_channel_fault:
            self.channel.scale_snr(eff.snr_scale)
            self.channel.set_bandwidth(ids, widths)
        if eff.has_compute_fault:
            fl_sel = fl_sel * eff.compute_scale[ids]
        return fl_sel

    def _maybe_reallocate(self, est_sel: ClientEstimate,
                          verdict: DeadlineVerdict, widths,
                          d_eff: np.ndarray) -> None:
        """Opt-in mid-round re-allocation (``cfg.reallocate``): the
        widths of cut clients re-land on the survivors still on the air
        (see :func:`repro_torch.edge.events.reallocated_finish`).  Runs
        strictly after the verdict — the drop set, tx fractions and
        billing are untouched, so "ledger <= plan" and seeded replays
        hold — and rewrites the survivors' realized finishes and tx
        energy in place, so the barrier/idle/battery math downstream
        sees the shrunk round for free.  Sync mode only (async grants
        release spectrum through the expiry path instead)."""
        if (not self.cfg.reallocate or self.async_agg is not None
                or not verdict.any_dropped
                or verdict.n_dropped == verdict.clients.size):
            return
        w = np.broadcast_to(np.asarray(widths, dtype=float),
                            verdict.clients.shape)
        new_fin = reallocated_finish(est_sel.time_s, verdict.t_comp_s,
                                     verdict.deadline_s, w, verdict.dropped)
        if not np.any(new_fin < est_sel.time_s):
            return
        tr = self.tracer
        before = (float(np.max(np.minimum(est_sel.time_s, d_eff)))
                  if tr.enabled else 0.0)
        dt = est_sel.time_s - new_fin
        # the freed spectrum re-landed on the survivors mid-round: their
        # realized subchannel rate rose, so the air-time floor inside
        # finish_round_sync's server-drain term must see the effective
        # rate (same bits, less air time), or the stale granted widths
        # would hold the round open past the shrunk barrier
        air_old = est_sel.time_s - verdict.t_comp_s
        air_new = new_fin - verdict.t_comp_s
        improved = (~verdict.dropped) & (dt > 0.0)
        scale = np.where(improved & (air_new > 0.0),
                         air_old / np.maximum(air_new, 1e-300), 1.0)
        c = est_sel.clients
        self.channel.rates_bps[c] = self.channel.rates_bps[c] * scale
        est_sel.energy_j = (est_sel.energy_j
                            - self.channel.cfg.tx_power_w * dt)
        est_sel.time_s = new_fin
        verdict.finish_s = new_fin
        self.realloc_rounds += 1
        if tr.enabled:
            after = float(np.max(np.minimum(new_fin, d_eff)))
            tr.event(obs.REALLOC, obs.CAT_ROUND, self.clock.now,
                     round_id=len(self.decisions) - 1,
                     freed_hz=float(w[verdict.dropped].sum()),
                     n_dropped=int(verdict.n_dropped),
                     barrier_before=before, barrier_after=after)
            tr.metrics.counter("realloc_rounds_total").inc(
                1, policy=self.policy.name)
            tr.metrics.histogram("realloc_barrier_saved_s").observe(
                before - after)

    def decide(self, k: int, eligible, wire_fn: Callable, flops,
               summable: bool = True, codec=None
               ) -> tuple[list[int], ClientEstimate, RoundDecision]:
        """Start a round: re-draw fading, filter dead clients, run the
        allocation policy.  ``wire_fn(codec_override|None)`` maps a codec
        to one client's (aggregatable, non-aggregatable) upload wire
        bytes.  Returns (cohort ids, allocation-aware estimates for the
        cohort, the RoundDecision)."""
        # grants that lapsed since the last pop free their spectrum now;
        # the next pop's history record picks up the count so
        # Σ history['dropped'] reconciles with deadline_dropped_total
        self._expired_unrecorded += self._release_expired()
        self.channel.sample()
        eligible = np.asarray(eligible, dtype=int)
        fl = np.broadcast_to(np.asarray(flops, dtype=float), eligible.shape)
        # scenario availability filters BEFORE the policy runs: no
        # registered policy can select an unavailable client, and an
        # all-unavailable round degrades to the standard empty-cohort
        # round below (clock unchanged, nothing billed)
        eligible, fl, mult = self._begin_scenario_round(eligible, fl)
        alive = self.fleet.alive(eligible)
        if alive.size == 0:
            decision = RoundDecision(budget_hz=self.budget_hz(k))
            self.decisions.append(decision)
            self.verdicts.append(None)
            self._verdict = None
            return [], self._empty_est(), decision
        keep = np.isin(eligible, alive)
        if self.fleet_active():
            decision, est_sel = self._decide_fleet(
                k, eligible[keep], wire_fn, fl[keep],
                payload_mult=None if mult is None else mult[keep])
            return decision.selected, est_sel, decision
        state = self._round_state(k, eligible[keep], wire_fn, fl[keep],
                                  summable, codec,
                                  payload_mult=None if mult is None
                                  else mult[keep])
        decision = self.policy.decide(state)
        est_sel = self._apply(decision, state, wire_fn, fl[keep])
        if self.async_agg is not None:
            # the grant persists until the upload lands (pop_async_buffer
            # releases it); only this driver path dispatches into the
            # buffer, so only it holds spectrum
            for i in decision.selected:
                self._held_hz[int(i)] = decision.allocations[i].bandwidth_hz
        return decision.selected, est_sel, decision

    def allocate_for(self, clients, wire_fn: Callable, flops,
                     summable: bool = True, codec=None
                     ) -> tuple[ClientEstimate, RoundDecision]:
        """Allocation without selection: the cohort is already fixed
        (the vmapped simulator path), so run only the policy's
        ``allocate`` stage over it and commit the result.

        Cohort slots may repeat a fleet entry (the with_edge mod
        fallback when the cohort outnumbers the fleet): a device has one
        radio, so it gets ONE subchannel and carries one payload per
        slot — the returned estimate covers the unique clients with
        their payload multiplicity priced in, never silently dropping
        slots.  The budget is still provisioned per slot (k × W auto)."""
        clients = np.asarray(clients, dtype=int)
        self.channel.sample()
        fl = np.broadcast_to(np.asarray(flops, dtype=float), clients.shape)
        uniq, inv, counts = np.unique(clients, return_inverse=True,
                                      return_counts=True)
        fl_uniq = np.zeros(len(uniq))
        np.add.at(fl_uniq, inv, fl)
        # scenario: this cohort is externally fixed, so the availability
        # mask does not filter here (decide() is the selection path) —
        # but faults still strike: workload shedding scales the
        # allocation-visible FLOPs/floats now, and the realized-side
        # faults hit in _apply/_commit_fleet as usual
        self._effects = None
        counts = np.asarray(counts, dtype=float)
        if self.scenario is not None:
            eff = self._effects = self.scenario.begin_round(
                len(self.decisions), self.clock.now, self.fleet.battery_j)
            if eff.has_shedding:
                frac = eff.workload_frac[uniq]
                fl_uniq = fl_uniq * frac
                counts = counts * frac
        if self.fleet_active():
            fstate, tot_bytes = self._fleet_state(
                len(clients), uniq, wire_fn, fl_uniq, payload_mult=counts)
            sel = np.arange(len(uniq))
            w, d = self.policy.allocate_vectorized(fstate, sel)
            decision = FleetDecision(uniq, w, d, fstate.budget_hz,
                                     positions=sel).validate()
            est_sel = self._commit_fleet(decision, fstate, tot_bytes,
                                         fl_uniq)
            return est_sel, decision
        # payload_mult: m slots on one device = m payloads over its single
        # subchannel — the policy sizes allocations against m·bits, and
        # the estimates/clock bill every slot
        state = self._round_state(len(clients), uniq, wire_fn, fl_uniq,
                                  summable, codec, payload_mult=counts)
        decision = RoundDecision(
            allocations=self.policy.allocate([int(c) for c in uniq], state),
            excluded={}, budget_hz=state.budget_hz).validate()
        est_sel = self._apply(decision, state, wire_fn, fl_uniq)
        return est_sel, decision

    # ------------------------------------------------------------------
    def finish_round_sync(self, est_sel: ClientEstimate, up_bytes,
                          down_bytes: float, aggregatable: bool = True,
                          nonagg_bytes=None) -> dict:
        """Advance the clock over a synchronous round and drain batteries.

        star: barrier at the slowest client's compute+uplink finish.
        tree: compute barrier, then the aggregation phase (log2(τ) hops
        for summable payloads, serialized root link otherwise).

        Deadline enforcement: if the round's decision granted finite
        deadlines (the verdict ``decide``/``allocate_for`` computed), the
        barrier is min(deadline, max_k t_k) — a late client is cut off
        at its grant and never holds the round open.  Its on-air bytes
        (``tx_frac`` of the upload) still cross the shared server slice
        and its battery is drained for the work actually done (compute
        up to the cutoff, transmit up to the cutoff), but the payload is
        gone: ``up_bytes`` here are the wire bytes the caller billed,
        scaled internally by the verdict's fractions.

        ``up_bytes`` / ``nonagg_bytes`` are scalars or per-client arrays
        aligned with ``est_sel.clients`` (heterogeneous codecs);
        ``nonagg_bytes`` carves that share of ``up_bytes`` out as
        non-aggregatable (mixed payloads, e.g. FedDANE's gradient + model
        phases) and overrides ``aggregatable`` when given."""
        verdict, self._verdict = self._verdict, None
        c = est_sel.clients
        if c.size == 0:
            # empty cohort: nothing is broadcast or transmitted — the
            # clock must agree with the ledger's zero-byte round
            return self._record(0.0, 0.0, c)
        if verdict is not None and not np.array_equal(verdict.clients, c):
            verdict = None      # est does not cover the judged cohort
        t_down = self.channel.downlink_time_s(down_bytes)
        up = np.broadcast_to(np.asarray(up_bytes, dtype=float), c.shape)
        if nonagg_bytes is None:
            nonagg = up * 0.0 if aggregatable else up
        else:
            nonagg = np.minimum(
                np.broadcast_to(np.asarray(nonagg_bytes, dtype=float),
                                c.shape), up)
        if verdict is None:
            deadlines = np.full(c.shape, np.inf)
            frac = np.ones(c.shape)
            n_dropped = 0
        else:
            deadlines = verdict.deadline_s
            frac = verdict.tx_frac
            n_dropped = verdict.n_dropped
        # only the bytes on the air before each cutoff cross the network
        agg = (up - nonagg) * frac
        nonagg = nonagg * frac
        # a client is active until min(its finish, its deadline)
        active = np.minimum(est_sel.time_s, deadlines)
        t_comp = (verdict.t_comp_s if verdict is not None
                  else est_sel.time_s - self.channel.uplink_time_s(up, c))
        if self.channel.cfg.topology == "tree":
            fl_t = np.minimum(est_sel.time_s
                              - self.channel.uplink_time_s(up, c), deadlines)
            barrier = float(np.max(fl_t))
            t_round = barrier + self.channel.comm_round_time_split(
                agg, nonagg, c)
        else:
            # per-client completions in parallel subchannels, then the
            # shared server slice drains the cohort's payloads
            barrier = self.clock.round_time(est_sel.time_s, cap_s=deadlines)
            t_round = max(barrier,
                          self.channel.comm_round_time_split(agg, nonagg, c))
        t0 = self.clock.now
        self.phase_s["downlink"] += t_down
        self.phase_s["barrier"] += barrier
        self.phase_s["drain"] += max(t_round - barrier, 0.0)
        if self.tracer.enabled:
            self._trace_sync_round(t0, t_down, t_round, barrier, c, t_comp,
                                   active, verdict)
        self.clock.advance(t_down + t_round)
        # synchronous barrier: a client that finishes early (or was cut
        # off) sits idle until the round closes, draining idle_power_w
        idle_s = np.maximum(t_round - active, 0.0)
        if verdict is None:
            spend_j = est_sel.energy_j
        else:
            spend_j = verdict.capped_spend_j(est_sel.time_s,
                                             est_sel.energy_j,
                                             self.channel.cfg.tx_power_w)
        spend_j = spend_j + self.fleet.cfg.idle_power_w * idle_s
        e = float(spend_j.sum())
        self.fleet.spend(c, spend_j)
        if self.tracer.enabled:
            self._meter_energy(c, e)
        landed = c if verdict is None else c[~verdict.dropped]
        return self._record(t_down + t_round, e, landed,
                            dropped=n_dropped, barrier_s=barrier)

    def _trace_sync_round(self, t0: float, t_down: float, t_round: float,
                          barrier: float, c: np.ndarray, t_comp: np.ndarray,
                          active: np.ndarray,
                          verdict: Optional[DeadlineVerdict]) -> None:
        """Emit the round's span tree on the simulated timeline: the
        round envelope, the shared downlink, per-client compute+uplink
        children (uplink truncated at any enforced cutoff), and the
        aggregation drain past the barrier.  One client's span durations
        sum to its active time min(finish, deadline), so under star
        topology max_k Σ durations == the recorded ``barrier_s``."""
        tr = self.tracer
        rid = len(self.decisions) - 1
        tr.span(obs.ROUND, obs.CAT_ROUND, t0, t0 + t_down + t_round,
                round_id=rid, cohort=int(c.size))
        if t_down > 0:
            tr.span(obs.DOWNLINK, obs.CAT_ROUND, t0, t0 + t_down,
                    round_id=rid)
        start = t0 + t_down
        tr.metrics.histogram("barrier_s").observe(barrier)
        for phase, dt in (("downlink", t_down), ("barrier", barrier),
                          ("drain", max(t_round - barrier, 0.0))):
            tr.metrics.counter("phase_s_total").inc(dt, phase=phase)
        idx = range(len(c))
        if self._fleet_round and c.size > self.cfg.trace_top_k_clients:
            # fleet rounds keep span volume O(top-k): only the slowest
            # (latest-active) clients get per-client tracks — the same
            # clients export.to_chrome(top_k_clients=...) would keep
            idx = np.argsort(active, kind="stable")
            idx = idx[-self.cfg.trace_top_k_clients:]
        for j in idx:
            cl = int(c[j])
            comp_end = start + min(float(t_comp[j]), float(active[j]))
            tr.span(obs.COMPUTE, obs.CAT_CLIENT, start, comp_end,
                    round_id=rid, client=cl)
            tr.span(obs.UPLINK, obs.CAT_CLIENT, comp_end,
                    start + float(active[j]), round_id=rid, client=cl,
                    dropped=(bool(verdict.dropped[j])
                             if verdict is not None else False))
        tr.span(obs.AGGREGATE, obs.CAT_ROUND, start + barrier,
                t0 + t_down + t_round, round_id=rid)

    def _meter_energy(self, c: np.ndarray, spent_j: float) -> None:
        m = self.tracer.metrics
        m.counter("energy_j_total").inc(spent_j)
        if self._fleet_round and c.size > self.cfg.trace_top_k_clients:
            # summary-level battery metering at fleet scale: label
            # cardinality stays O(1) instead of O(population)
            batt = self.fleet.battery_j[c]
            m.gauge("battery_j_min").set(float(batt.min()))
            m.gauge("battery_j_mean").set(float(batt.mean()))
            return
        for cl in c:
            m.gauge("battery_j").set(float(self.fleet.battery_j[int(cl)]),
                                     client=int(cl))

    def dispatch_async(self, est_sel: ClientEstimate, n_samples, payloads,
                       down_bytes: float) -> None:
        """Submit the cohort's results into the in-flight buffer (energy is
        spent at dispatch — the client does the work regardless of when
        its update lands).

        Deadline enforcement: a dispatched client whose realized finish
        busts its granted deadline never lands — instead of a completion
        it gets a per-client *expiry event* at its cutoff; when the clock
        passes it, the granted spectrum returns to the pool and the
        device becomes selectable again (``_release_expired``).  Its
        battery is drained only for the work done before the cutoff.
        ``n_samples`` / ``payloads`` align with the SURVIVORS — a cut-off
        client's payload is never materialized."""
        assert self.async_agg is not None, "EdgeConfig.mode != 'async'"
        verdict, self._verdict = self._verdict, None
        if est_sel.clients.size == 0:
            return  # empty cohort: nothing broadcast, nothing in flight
        if verdict is not None and not np.array_equal(verdict.clients,
                                                      est_sel.clients):
            verdict = None
        drop = (np.zeros(est_sel.clients.shape, bool) if verdict is None
                else verdict.dropped)
        n_surv = int((~drop).sum())
        if len(payloads) != n_surv:
            raise ValueError(
                f"dispatch_async got {len(payloads)} payloads for "
                f"{n_surv} surviving clients (cohort {est_sel.clients.size}, "
                f"{int(drop.sum())} past deadline)")
        if self.cfg.buffer_size == 0 and not self._buffer_resolved:
            self.async_agg.buffer_size = max(1, (n_surv + 1) // 2)
            self._buffer_resolved = True
        self.clock.advance(self.channel.downlink_time_s(down_bytes))
        if verdict is None:
            spend_j = est_sel.energy_j
        else:
            spend_j = verdict.capped_spend_j(est_sel.time_s,
                                             est_sel.energy_j,
                                             self.channel.cfg.tx_power_w)
        self.fleet.spend(est_sel.clients, spend_j)
        self.energy_j += float(spend_j.sum())
        tr = self.tracer
        if tr.enabled:
            self._meter_energy(est_sel.clients, float(spend_j.sum()))
        rid = len(self.decisions) - 1
        j = 0
        for i, cl in enumerate(est_sel.clients):
            cl = int(cl)
            self.busy.add(cl)
            if drop[i]:
                # the grant lapses at the cutoff: spectrum + device are
                # released when the clock reaches it, the upload never
                # enters the buffer
                expires = self.clock.now + float(verdict.deadline_s[i])
                self._expiry[cl] = expires
                self.clock.push(expires, kind=DEADLINE_EXPIRED, client=cl)
                if tr.enabled:
                    tr.event(obs.EXPIRE, obs.CAT_ASYNC, expires,
                             round_id=rid, client=cl,
                             deadline_s=float(verdict.deadline_s[i]),
                             tx_frac=float(verdict.tx_frac[i]))
            else:
                if tr.enabled:
                    tr.event(obs.DISPATCH, obs.CAT_ASYNC, self.clock.now,
                             round_id=rid, client=cl,
                             eta_s=float(est_sel.time_s[i]),
                             version=self.async_agg.version)
                self.async_agg.submit(cl, float(est_sel.time_s[i]),
                                      float(np.asarray(n_samples)[j]),
                                      payloads[j])
                j += 1

    def _release_expired(self) -> int:
        """Release spectrum + busy state for every expired grant the
        clock has passed; returns how many lapsed."""
        lapsed = [cl for cl, t in self._expiry.items()
                  if t <= self.clock.now + 1e-12]
        for cl in lapsed:
            del self._expiry[cl]
            self._held_hz.pop(cl, None)
            self.busy.discard(cl)
        return len(lapsed)

    def pop_async_buffer(self):
        """Drain the next buffer; advances the clock to its last arrival.
        Returns (entries, staleness weights summing to 1)."""
        assert self.async_agg is not None
        t0 = self.clock.now
        entries, w = self.async_agg.pop_buffer()
        for e in entries:
            self.busy.discard(e.client)
            self._held_hz.pop(e.client, None)  # subchannel released
        expired = self._release_expired() + self._expired_unrecorded
        self._expired_unrecorded = 0
        self._record(self.clock.now - t0, 0.0,
                     np.asarray([e.client for e in entries], int),
                     dropped=expired)
        return entries, w

    # ------------------------------------------------------------------
    def _record(self, wall_s: float, energy_j: float, clients,
                dropped: int = 0, barrier_s: Optional[float] = None) -> dict:
        """``clients`` are the LANDED cohort (an all-dropped round records
        cohort=0); ``barrier_s`` is the enforced client-completion
        barrier — min(deadline, max_k t_k) — before the shared server
        drain and downlink are added.  Sync rounds record ``dropped`` at
        judgment; async records a drop when its lapsed grant is released
        (Σ history drops == deadline_dropped_total once every pending
        expiry has passed)."""
        self.energy_j += energy_j
        rec = {"wall_s": float(wall_s), "clock_s": self.clock.now,
               "energy_j": self.energy_j, "cohort": len(clients),
               "dropped": int(dropped)}
        if barrier_s is not None:
            rec["barrier_s"] = float(barrier_s)
        self.history.append(rec)
        if self.tracer.enabled:
            rec_t = dict(rec)
            rec_t["round_id"] = len(self.history) - 1
            self.tracer.record_round(rec_t)
            self.tracer.metrics.histogram("cohort_size").observe(len(clients))
        return rec

    def summary(self) -> dict:
        return {
            "wall_clock_s": self.clock.now,
            "energy_j": self.energy_j,
            "rounds": len(self.history),
            "dropped_total": self.dropped_total,
            "deadline_dropped_total": self.deadline_dropped_total,
            "unavailable_total": self.unavailable_total,
            "realloc_rounds": self.realloc_rounds,
            "depleted_clients": int((self.fleet.battery_j <= 0).sum()),
            "in_flight": 0 if self.async_agg is None else self.async_agg.in_flight,
            # why clients never landed, and where the simulated seconds
            # went — maintained whether or not a tracer is attached
            "drop_reasons": dict(self.drop_reasons),
            "phase_s": dict(self.phase_s),
        }
