"""Fault injectors: per-round perturbations layered on the availability
process.

Two phases (see the package docstring): ``blackout`` and
``battery_gate`` fold into the *allocation-visible* availability mask
(``fault_off`` — no policy can select a faulted client, and its absence
is bucketed under ``fault`` rather than ``unavailable``);
``data_exclusion`` scales the allocation-visible workload; ``snr_burst``
and ``straggler`` are *realized-side* — they strike after the policy
granted widths and deadlines, which is what makes ``enforce_deadlines``
cut provisioned clients and gives mid-round re-allocation freed
spectrum to hand out."""
from __future__ import annotations

import numpy as np

from repro_torch.edge.scenario.base import (FaultInjector, RoundEffects,
                                            register_fault)


class Blackout(FaultInjector):
    """A channel blackout window on EventClock time: clients in the
    affected subset are unreachable while ``start <= t mod period < end``
    (``period=0`` makes it a one-shot window on absolute clock time)."""

    name = "blackout"

    def __init__(self, start: float = 0.0, end: float = 0.0,
                 period: float = 0.0, frac: float = 1.0):
        self.start = float(start)
        self.end = float(end)
        self.period = float(period)
        self.frac = float(frac)

    def reset(self, population: int, rng: np.random.Generator) -> None:
        super().reset(population, rng)
        self.affected = (rng.uniform(0.0, 1.0, population) < self.frac
                         if self.frac < 1.0
                         else np.ones(population, dtype=bool))

    def apply(self, round_id: int, t_s: float, battery_j: np.ndarray,
              eff: RoundEffects, rng: np.random.Generator) -> None:
        t = t_s % self.period if self.period > 0 else t_s
        if self.start <= t < self.end:
            eff.fault_off |= self.affected


class SnrBurst(FaultInjector):
    """Per-round, per-client SNR-degradation bursts: each client's
    realized linear SNR is scaled by ``scale`` with probability
    ``prob`` — *after* allocation, so the policy provisioned against
    the clean channel and the upload sees the degraded one."""

    name = "snr_burst"

    def __init__(self, prob: float = 0.1, scale: float = 0.1):
        self.prob = float(prob)
        self.scale = float(scale)

    def apply(self, round_id: int, t_s: float, battery_j: np.ndarray,
              eff: RoundEffects, rng: np.random.Generator) -> None:
        hit = rng.uniform(0.0, 1.0, self.population) < self.prob
        eff.snr_scale = np.where(hit, eff.snr_scale * self.scale,
                                 eff.snr_scale)


class Straggler(FaultInjector):
    """Compute slowdown bursts: a hit client's realized FLOP count is
    scaled by ``slow`` (a throttled clock at fixed power — both compute
    time *and* compute energy grow), after the policy already committed
    to the nominal profile."""

    name = "straggler"

    def __init__(self, prob: float = 0.1, slow: float = 4.0):
        self.prob = float(prob)
        self.slow = float(slow)

    def apply(self, round_id: int, t_s: float, battery_j: np.ndarray,
              eff: RoundEffects, rng: np.random.Generator) -> None:
        hit = rng.uniform(0.0, 1.0, self.population) < self.prob
        eff.compute_scale = np.where(hit, eff.compute_scale * self.slow,
                                     eff.compute_scale)


class BatteryGate(FaultInjector):
    """Battery-gated dropout: a client whose remaining battery is at or
    below ``floor_j`` refuses the round entirely (stricter than the
    policies' ``battery_floor_j`` exclusion — the device never answers
    the scheduler, so it is a ``fault`` bucket absence, not a policy
    exclusion)."""

    name = "battery_gate"

    def __init__(self, floor_j: float = 0.0):
        self.floor_j = float(floor_j)

    def apply(self, round_id: int, t_s: float, battery_j: np.ndarray,
              eff: RoundEffects, rng: np.random.Generator) -> None:
        eff.fault_off |= np.asarray(battery_j) <= self.floor_j


class DataExclusion(FaultInjector):
    """Per-client workload shedding à la threshold-based data exclusion
    (arXiv:2104.05509): each round every client keeps an independent
    uniform fraction in ``[thresh, 1]`` of its local workload, scaling
    the *allocation-visible* FLOPs and upload floats the policies size
    widths and deadlines against.  Billing stays at full plan bytes —
    the ledger's "equal to plan iff no drops" invariant is about what
    the protocol commits to, not what the device elects to run."""

    name = "data_exclusion"

    def __init__(self, thresh: float = 0.5):
        if not 0.0 < float(thresh) <= 1.0:
            raise ValueError(f"data_exclusion threshold must be in (0, 1], "
                             f"got {thresh}")
        self.thresh = float(thresh)

    def apply(self, round_id: int, t_s: float, battery_j: np.ndarray,
              eff: RoundEffects, rng: np.random.Generator) -> None:
        frac = rng.uniform(self.thresh, 1.0, self.population)
        eff.workload_frac = eff.workload_frac * frac


register_fault("blackout", Blackout)
register_fault("snr_burst", SnrBurst)
register_fault("straggler", Straggler)
register_fault("battery_gate", BatteryGate)
register_fault("data_exclusion", DataExclusion)
