"""Availability processes: who is reachable, per round.

All processes are vectorized over the population, keyed to EventClock
time (never a wall clock), and draw from the scenario's private RNG
stream with a *fixed* number of draws per round — so a seeded replay,
and a checkpoint/resume at any round boundary, is bit-identical."""
from __future__ import annotations

import json

import numpy as np

from repro_torch.edge.scenario.base import (AvailabilityProcess, register_process)


class AlwaysOn(AvailabilityProcess):
    """The static fleet: every client reachable every round."""

    name = "always_on"

    def mask(self, round_id: int, t_s: float,
             rng: np.random.Generator) -> np.ndarray:
        return np.ones(self.population, dtype=bool)


class Diurnal(AvailabilityProcess):
    """Sinusoidal connect probability with per-client phase.

    ``p_i(t) = clip(base + amp * sin(2*pi*(t/period + phase_i)), 0, 1)``
    where ``phase_i`` is a static per-client draw — clients in different
    "time zones" churn out of phase, the classic cross-device diurnal
    pattern (arXiv:2009.00081 §device availability).

    ``unit="round"`` counts the period in *rounds* instead of simulated
    seconds: same sinusoid, but invariant to anything that moves the
    clock (mid-round re-allocation, backend float drift) — the variant
    A/B comparisons like benchmarks Part F need, where both arms must
    draw identical churn while their barriers differ."""

    name = "diurnal"

    def __init__(self, period: float = 86400.0, amp: float = 0.4,
                 base: float = 0.6, phase_jitter: float = 1.0,
                 unit: str = "s"):
        if unit not in ("s", "round"):
            raise ValueError(f"diurnal unit must be 's' or 'round', "
                             f"got {unit!r}")
        self.period = float(period)
        self.amp = float(amp)
        self.base = float(base)
        self.phase_jitter = float(phase_jitter)
        self.unit = unit

    def reset(self, population: int, rng: np.random.Generator) -> None:
        super().reset(population, rng)
        self.phase = rng.uniform(0.0, 1.0, population) * self.phase_jitter

    def mask(self, round_id: int, t_s: float,
             rng: np.random.Generator) -> np.ndarray:
        x = (float(round_id) if self.unit == "round" else t_s) / self.period
        p = self.base + self.amp * np.sin(2.0 * np.pi * (x + self.phase))
        u = rng.uniform(0.0, 1.0, self.population)
        return u < np.clip(p, 0.0, 1.0)


class Markov(AvailabilityProcess):
    """Per-client two-state on/off chain: sticky sessions rather than
    independent coin flips — an on client drops with ``p_drop``, an off
    client rejoins with ``p_join``.  Starts from the stationary mix so
    round 0 is not a transient."""

    name = "markov"

    def __init__(self, p_drop: float = 0.1, p_join: float = 0.3,
                 p_start: float | None = None):
        self.p_drop = float(p_drop)
        self.p_join = float(p_join)
        denom = self.p_drop + self.p_join
        self.p_start = (float(p_start) if p_start is not None
                        else (self.p_join / denom if denom > 0 else 1.0))

    def reset(self, population: int, rng: np.random.Generator) -> None:
        super().reset(population, rng)
        self.state = rng.uniform(0.0, 1.0, population) < self.p_start

    def mask(self, round_id: int, t_s: float,
             rng: np.random.Generator) -> np.ndarray:
        u = rng.uniform(0.0, 1.0, self.population)
        self.state = np.where(self.state, u >= self.p_drop, u < self.p_join)
        return self.state

    def state_dict(self) -> dict[str, np.ndarray]:
        return {"state": self.state}

    def load_state_dict(self, state: dict[str, np.ndarray]) -> None:
        self.state = np.asarray(state["state"], dtype=bool)


class Trace(AvailabilityProcess):
    """Replay availability deltas from a JSONL trace.

    Each line is ``{"t": <event-clock seconds>, ...}`` with any of
    ``"on": [ids]``, ``"off": [ids]``, or ``"set": [ids]`` (wholesale
    replacement).  Records must be sorted by ``t``; every record with
    ``t <= now`` is applied once, cursor-style, so the process is a pure
    function of EventClock time and resumes from a checkpointed cursor."""

    name = "trace"

    def __init__(self, path: str):
        self.path = str(path)
        with open(self.path) as fh:
            self.records = [json.loads(line) for line in fh
                            if line.strip()]
        ts = [float(r.get("t", 0.0)) for r in self.records]
        if ts != sorted(ts):
            raise ValueError(f"availability trace {self.path} is not "
                             f"sorted by 't'")

    def reset(self, population: int, rng: np.random.Generator) -> None:
        super().reset(population, rng)
        self.state = np.ones(population, dtype=bool)
        self.cursor = 0

    def mask(self, round_id: int, t_s: float,
             rng: np.random.Generator) -> np.ndarray:
        while (self.cursor < len(self.records)
               and float(self.records[self.cursor].get("t", 0.0)) <= t_s):
            rec = self.records[self.cursor]
            if "set" in rec:
                self.state = np.zeros(self.population, dtype=bool)
                self.state[np.asarray(rec["set"], dtype=int)] = True
            if "on" in rec:
                self.state[np.asarray(rec["on"], dtype=int)] = True
            if "off" in rec:
                self.state[np.asarray(rec["off"], dtype=int)] = False
            self.cursor += 1
        return self.state.copy()

    def state_dict(self) -> dict[str, np.ndarray]:
        return {"state": self.state, "cursor": np.asarray(self.cursor)}

    def load_state_dict(self, state: dict[str, np.ndarray]) -> None:
        self.state = np.asarray(state["state"], dtype=bool)
        self.cursor = int(state["cursor"])


register_process("always_on", AlwaysOn)
register_process("diurnal", Diurnal)
register_process("markov", Markov)
register_process("trace", Trace)
