"""FleetEngine: drive sync rounds over a 10⁵–10⁶-client population
(port of ``repro.edge.fleet.engine``).

A standalone round driver for mega-scale edge simulation — the same
round semantics as ``EdgeRuntime`` + ``FederatedRun``'s edge loop, with
a fixed synthetic payload (``up_bytes`` wire bytes up, ``down_bytes``
broadcast down, ``flops`` of client work) instead of a training loop:

  sample fading → filter dead clients → cohort draw → width allocation
  (the policy's vectorized form) → realized finish → deadline verdict →
  capped barrier / energy / battery update.

Backends:
  * ``"exact"`` — delegates to an internal :class:`EdgeRuntime` with the
    fleet fast path forced on (``EdgeConfig.fleet="on"``), so every
    number is bit-identical to what a full federated run would record.
  * ``"jit"`` (the reference's name, kept so configs carry over) — the
    fused device backend: struct-of-arrays state (:class:`FleetState`,
    numpy on the host) plus the float64 torch kernels in
    :mod:`repro_torch.edge.fleet.kernel` on the engine's ``device`` (the
    card unless the caller passes ``device="cpu"``).  The rng streams are
    laid out exactly as ``EdgeRuntime``'s (channel at seed+1, devices at
    seed+2, cohort draws at seed+3), so cohorts, populations, and fading
    draws match the exact backend bitwise; float results agree up to
    float-op reassociation.  Star topology only (tree aggregation stays
    on the numpy path).

Both backends advance a plain scalar clock — the ``EventClock`` heap is
reserved for the async tail, which the engine does not simulate.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.edge.allocation import FleetRoundState, make_policy
from repro_torch.edge.fleet import kernel
from repro_torch.edge.fleet.state import FleetState
from repro_torch.edge.runtime import EdgeConfig, EdgeRuntime
from repro_torch.edge.scenario import make_scenario
from repro_torch.utils.device import resolve_device


class FleetEngine:
    """Sync-round driver over one population (see module docstring).
    ``device``: where the ``"jit"`` backend's kernels run; an entry point,
    so it is the card unless the caller asks for the CPU, and CUDA must be
    present when asked for (on either backend)."""

    def __init__(self, cfg: EdgeConfig, population: int, *,
                 up_bytes: float, flops: float, down_bytes: float = 0.0,
                 seed: int = 0, backend: str = None, device="cuda"):
        self.device = resolve_device(device)
        backend = cfg.fleet_backend if backend is None else backend
        if backend not in ("exact", "jit"):
            raise ValueError(f"FleetEngine backend must be 'exact' or "
                             f"'jit', got {backend!r}")
        if population < 1:
            raise ValueError(f"population must be >= 1, got {population}")
        self.cfg = dataclasses.replace(cfg, mode="sync", fleet="on",
                                       fleet_backend=backend)
        self.population = int(population)
        self.up_bytes = float(up_bytes)
        self.down_bytes = float(down_bytes)
        self.flops = float(flops)
        self.backend = backend
        self.last_decision = None   # the most recent round's decision
        if backend == "exact":
            self._rt = EdgeRuntime(self.cfg, self.population, seed=seed)
            self.state = FleetState.from_runtime(self._rt)
            self.policy = self._rt.policy
            self.rng = self._rt.rng
            return
        if cfg.channel.topology != "star":
            raise ValueError(
                "FleetEngine backend='jit' implements star topology only "
                "(tree in-network aggregation needs the numpy path); use "
                "backend='exact'")
        self._rt = None
        s = seed + cfg.seed
        self.state = FleetState.draw(cfg.channel, cfg.device,
                                     self.population, seed=s)
        self.rng = np.random.default_rng(s + 3)
        self.policy = make_policy(
            cfg.scheduler, deadline_s=cfg.deadline_s,
            min_clients=cfg.min_clients, battery_floor_j=cfg.battery_floor_j,
            round_budget_j=cfg.round_budget_j, ratio=cfg.adaptive_ratio,
            ratio_floor=cfg.adaptive_ratio_floor)
        if not getattr(self.policy, "vectorized", False):
            raise ValueError(
                f"policy {cfg.scheduler!r} has no vectorized form; use "
                f"backend='exact' (scalar fallback)")
        # scenario stream at s+4, as in EdgeRuntime — same seed, same
        # population, so the availability/fault draws match the exact
        # backend's (bitwise for processes that do not read the clock)
        self.scenario = (make_scenario(cfg.scenario, self.population,
                                       seed=s + 4)
                         if cfg.scenario else None)
        self._unavailable = 0
        self._realloc_rounds = 0
        self._clock_s = 0.0
        self._energy_j = 0.0
        self._history: list[dict] = []
        self._dropped = 0
        self._dl_dropped = 0
        self._drop_reasons: dict[str, int] = {}
        self._phase = {"downlink": 0.0, "barrier": 0.0, "drain": 0.0}

    # ------------------------------------------------------------------
    @property
    def clock_s(self) -> float:
        return self._rt.clock.now if self._rt is not None else self._clock_s

    @property
    def energy_j(self) -> float:
        return self._rt.energy_j if self._rt is not None else self._energy_j

    @property
    def history(self) -> list[dict]:
        return self._rt.history if self._rt is not None else self._history

    @property
    def dropped_total(self) -> int:
        return (self._rt.dropped_total if self._rt is not None
                else self._dropped)

    @property
    def deadline_dropped_total(self) -> int:
        return (self._rt.deadline_dropped_total if self._rt is not None
                else self._dl_dropped)

    # ------------------------------------------------------------------
    def run_round(self, k: int) -> dict:
        """One sync round with a cohort target of ``k``; returns the same
        record dict ``EdgeRuntime._record`` appends to ``history``."""
        if self._rt is not None:
            rt = self._rt

            def wire(codec=None):
                return (self.up_bytes, 0.0)

            _, est, dec = rt.decide(k, np.arange(self.population), wire,
                                    self.flops, summable=True)
            rec = rt.finish_round_sync(est, self.up_bytes, self.down_bytes,
                                       aggregatable=True)
            self.last_decision = dec
            return rec
        return self._run_round_jit(k)

    def run(self, rounds: int, k: int) -> list[dict]:
        return [self.run_round(k) for _ in range(int(rounds))]

    # ------------------------------------------------------------------
    def _run_round_jit(self, k: int) -> dict:
        cfg, st = self.cfg, self.state
        st.sample()
        eligible = np.arange(self.population)
        eff = None
        if self.scenario is not None:
            # same sequencing as EdgeRuntime._begin_scenario_round:
            # availability filters the eligible set pre-policy, faults
            # are held for the realized side below
            eff = self.scenario.begin_round(len(self._history),
                                            self._clock_s, st.battery_j)
            n_fault = int(eff.fault_off.sum())
            n_proc = int((eff.proc_off & ~eff.fault_off).sum())
            self._unavailable += n_proc + n_fault
            if n_proc:
                self._drop_reasons["unavailable"] = (
                    self._drop_reasons.get("unavailable", 0) + n_proc)
            if n_fault:
                self._drop_reasons["fault"] = (
                    self._drop_reasons.get("fault", 0) + n_fault)
            eligible = eligible[eff.available]
        alive = eligible[st.alive_mask()[eligible]]
        if alive.size == 0:
            self.last_decision = None
            return self._record(0.0, 0.0, 0, 0, None)
        # budget_hz: no async holds in a sync-only engine
        budget = (float(cfg.bandwidth_budget_hz)
                  if cfg.bandwidth_budget_hz > 0
                  else float(max(k, 1)) * cfg.channel.bandwidth_hz)
        mult = None
        fl_alive = self.flops
        if eff is not None and eff.has_shedding:
            mult = eff.workload_frac[alive]
            fl_alive = self.flops * mult
        t_comp = fl_alive / np.maximum(st.flops_per_s[alive], 1.0)
        fstate = FleetRoundState(
            k=k, ids=alive, t_comp_s=t_comp,
            spectral_eff=st.channel.spectral_efficiency(alive),
            budget_hz=budget, rng=self.rng, up_bits=8.0 * self.up_bytes,
            payload_mult=mult, backend="jit", device=self.device)
        dec = self.policy.decide_vectorized(fstate)
        dec.validate()
        self.last_decision = dec
        if dec.n_excluded:
            self._dropped += dec.n_excluded
            key = f"excluded:{dec.excluded_bucket or 'policy'}"
            self._drop_reasons[key] = (self._drop_reasons.get(key, 0)
                                       + dec.n_excluded)
        if dec.n_selected == 0:
            return self._record(0.0, 0.0, 0, 0, None)
        sel = alive[dec.positions]
        d_eff = np.minimum(dec.deadline_s_arr, cfg.enforce_deadline_s)
        # realized-side faults (EdgeRuntime._realized_faults): the grant
        # was provisioned against the clean draw; the round runs on the
        # degraded channel / throttled compute
        snr_sel = st.snr_round[sel]
        fl_sel = (fl_alive[dec.positions] if mult is not None
                  else self.flops)
        t_comp_sel = t_comp[dec.positions]
        if eff is not None and eff.has_channel_fault:
            snr_sel = snr_sel * eff.snr_scale[sel]
        if eff is not None and eff.has_compute_fault:
            fl_sel = fl_sel * eff.compute_scale[sel]
            t_comp_sel = fl_sel / np.maximum(st.flops_per_s[sel], 1.0)
        up_air = (self.up_bytes if mult is None
                  else self.up_bytes * mult[dec.positions])
        out = kernel.sync_round_jit(
            dec.bandwidth_hz_arr, snr_sel, t_comp_sel, up_air,
            fl_sel * cfg.device.joules_per_flop, d_eff,
            cfg.deadline_tolerance_s, cfg.channel.tx_power_w,
            max(cfg.channel.server_rate_bps, 1e-6),
            cfg.device.idle_power_w, st.battery_j[sel],
            bill_bytes=self.up_bytes, reallocate=cfg.reallocate,
            device=self.device)
        st.fleet.battery_j[sel] = out["battery_j"]
        if out["n_realloc"]:
            self._realloc_rounds += 1
        n_drop = out["n_dropped"]
        if n_drop:
            self._dl_dropped += n_drop
            self._drop_reasons["deadline_cutoff"] = (
                self._drop_reasons.get("deadline_cutoff", 0) + n_drop)
        t_down = st.channel.downlink_time_s(self.down_bytes)
        self._phase["downlink"] += t_down
        self._phase["barrier"] += out["barrier_s"]
        self._phase["drain"] += max(out["t_round_s"] - out["barrier_s"], 0.0)
        return self._record(t_down + out["t_round_s"], out["spend_j"],
                            dec.n_selected - n_drop, n_drop,
                            out["barrier_s"])

    def _record(self, wall_s: float, energy_j: float, cohort: int,
                dropped: int, barrier_s) -> dict:
        self._clock_s += wall_s
        self._energy_j += energy_j
        rec = {"wall_s": float(wall_s), "clock_s": self._clock_s,
               "energy_j": self._energy_j, "cohort": int(cohort),
               "dropped": int(dropped)}
        if barrier_s is not None:
            rec["barrier_s"] = float(barrier_s)
        self._history.append(rec)
        return rec

    def summary(self) -> dict:
        if self._rt is not None:
            return self._rt.summary()
        return {
            "wall_clock_s": self._clock_s,
            "energy_j": self._energy_j,
            "rounds": len(self._history),
            "dropped_total": self._dropped,
            "deadline_dropped_total": self._dl_dropped,
            "depleted_clients": int((self.state.battery_j <= 0.0).sum()),
            "in_flight": 0,
            "drop_reasons": dict(self._drop_reasons),
            "phase_s": dict(self._phase),
            "unavailable_total": self._unavailable,
            "realloc_rounds": self._realloc_rounds,
        }
