"""Scenario layer: seeded availability churn and fault injection.

Without a scenario the edge runtime models a *static* fleet — every client
reachable every round, channels that never black out, stragglers whose
granted spectrum dies with them at the barrier.  The FEEL design-issues
survey (arXiv:2009.00081) names device mobility/availability as exactly
the gap this ignores.  This package closes it with a fourth registry
subsystem (mirroring strategies / codecs / allocation policies): a
:class:`Scenario` composes one pluggable **availability process** with
any number of **fault injectors**, all driven by a dedicated seeded RNG
stream and by *EventClock* time only — never a wall clock (RPL001).

Spec-string grammar
-------------------
A scenario is configured on ``EdgeConfig.scenario`` as a ``|``-separated
spec string.  Each component is ``name``, ``name:<positional>`` or
``name:key=val,key=val``; at most one component may name an availability
process (default ``always_on``), the rest name fault injectors::

    "diurnal:period=600,amp=0.4,base=0.7"
    "markov:p_drop=0.2,p_join=0.5|snr_burst:prob=0.3,scale=0.25"
    "trace:/tmp/avail.jsonl|blackout:start=10,end=20|data_exclusion:0.5"

Two effect phases
-----------------
*Allocation-visible* effects are applied **before** the policy runs:
the availability mask (process ``off`` states, ``blackout`` windows,
``battery_gate``) filters the eligible set — no registered policy can
select an unavailable client — and ``data_exclusion`` workload shedding
scales the FLOPs and upload floats every policy sizes against (the
threshold-exclusion knob of arXiv:2104.05509, generalized to partial
per-client workloads).

*Realized-side* faults (``snr_burst``, ``straggler``) strike **after**
allocation, between the grant and the transmission — the channel the
policy provisioned against is not the channel the upload sees.  That is
what makes deadline enforcement bite (a provisioned client can now bust
its granted cutoff) and mid-round re-allocation meaningful.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np


# ---------------------------------------------------------------------------
# Per-round effect bundle
# ---------------------------------------------------------------------------
@dataclass
class RoundEffects:
    """Vectorized scenario output for one round, over the full population.

    ``available`` is the composed mask the runtime filters eligibility
    with; ``proc_off`` / ``fault_off`` split it by cause so drops land
    in distinct ``unavailable`` / ``fault`` reason buckets.  The scale
    arrays are realized-side unless noted; all default to no-op."""
    proc_off: np.ndarray       # (N,) bool — availability process says off
    fault_off: np.ndarray      # (N,) bool — a fault injector forced off
    snr_scale: np.ndarray      # (N,) float — realized-side channel fault
    compute_scale: np.ndarray  # (N,) float >= 1 — realized-side slowdown
    workload_frac: np.ndarray  # (N,) float in (0,1] — allocation-visible
    available: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        self.available = ~(self.proc_off | self.fault_off)

    @property
    def has_channel_fault(self) -> bool:
        return bool(np.any(self.snr_scale != 1.0))

    @property
    def has_compute_fault(self) -> bool:
        return bool(np.any(self.compute_scale != 1.0))

    @property
    def has_shedding(self) -> bool:
        return bool(np.any(self.workload_frac != 1.0))


def _noop_effects(population: int) -> RoundEffects:
    return RoundEffects(
        proc_off=np.zeros(population, dtype=bool),
        fault_off=np.zeros(population, dtype=bool),
        snr_scale=np.ones(population, dtype=float),
        compute_scale=np.ones(population, dtype=float),
        workload_frac=np.ones(population, dtype=float),
    )


# ---------------------------------------------------------------------------
# Component protocols
# ---------------------------------------------------------------------------
class AvailabilityProcess:
    """Who is reachable this round.  Stateful components keep their
    evolution in arrays exposed via ``state_dict`` so a checkpointed run
    resumes bit-identically.  ``mask`` must consume a *fixed* number of
    RNG draws per round regardless of the outcome."""

    name = "base"

    def reset(self, population: int, rng: np.random.Generator) -> None:
        self.population = population

    def mask(self, round_id: int, t_s: float,
             rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def state_dict(self) -> dict[str, np.ndarray]:
        return {}

    def load_state_dict(self, state: dict[str, np.ndarray]) -> None:
        pass


class FaultInjector:
    """A per-round perturbation written into :class:`RoundEffects`.
    Injectors mutate ``eff`` in place and are applied in spec order."""

    name = "base"

    def reset(self, population: int, rng: np.random.Generator) -> None:
        self.population = population

    def apply(self, round_id: int, t_s: float, battery_j: np.ndarray,
              eff: RoundEffects, rng: np.random.Generator) -> None:
        raise NotImplementedError

    def state_dict(self) -> dict[str, np.ndarray]:
        return {}

    def load_state_dict(self, state: dict[str, np.ndarray]) -> None:
        pass


# ---------------------------------------------------------------------------
# The Scenario object
# ---------------------------------------------------------------------------
class Scenario:
    """One availability process + ordered fault injectors, on a private
    seeded stream (``seed + cfg.seed + 4`` in the runtime's layout, so
    enabling a scenario never perturbs the channel/fleet/policy draws).

    ``begin_round`` must be called exactly once per round, with the
    EventClock time — both the dict runtime and the fleet engine call it
    at the same point, so the two paths consume an identical stream and
    stay bit-identical under churn."""

    def __init__(self, availability: AvailabilityProcess,
                 faults: list[FaultInjector], population: int, seed: int,
                 spec: str = ""):
        self.availability = availability
        self.faults = list(faults)
        self.population = int(population)
        self.seed = int(seed)
        self.spec = spec
        self.rng = np.random.default_rng(self.seed)
        self.availability.reset(self.population, self.rng)
        for f in self.faults:
            f.reset(self.population, self.rng)
        self.rounds_seen = 0

    def begin_round(self, round_id: int, t_s: float,
                    battery_j: np.ndarray) -> RoundEffects:
        eff = _noop_effects(self.population)
        eff.proc_off = ~self.availability.mask(round_id, t_s, self.rng)
        for f in self.faults:
            f.apply(round_id, t_s, battery_j, eff, self.rng)
        eff.__post_init__()  # recompose the mask after injectors ran
        self.rounds_seen += 1
        return eff

    # -- checkpoint/resume support (the reference's repro.checkpoint.save_run) ---------
    def state_dict(self) -> dict[str, Any]:
        arrays: dict[str, np.ndarray] = {}
        for k, v in self.availability.state_dict().items():
            arrays[f"avail/{k}"] = v
        for i, f in enumerate(self.faults):
            for k, v in f.state_dict().items():
                arrays[f"fault{i}/{k}"] = v
        meta = {"rng": self.rng.bit_generator.state,
                "rounds_seen": self.rounds_seen, "spec": self.spec}
        return {"arrays": arrays, "meta": meta}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        meta = state["meta"]
        if meta.get("spec", self.spec) != self.spec:
            raise ValueError(
                f"scenario spec mismatch: checkpoint has {meta['spec']!r}, "
                f"this run has {self.spec!r}")
        self.rng.bit_generator.state = meta["rng"]
        self.rounds_seen = int(meta["rounds_seen"])
        arrays = state["arrays"]
        self.availability.load_state_dict(
            {k[len("avail/"):]: v for k, v in arrays.items()
             if k.startswith("avail/")})
        for i, f in enumerate(self.faults):
            pre = f"fault{i}/"
            f.load_state_dict({k[len(pre):]: v for k, v in arrays.items()
                               if k.startswith(pre)})


# ---------------------------------------------------------------------------
# Registries + spec-string parsing (the fourth registry subsystem)
# ---------------------------------------------------------------------------
_PROCESSES: dict[str, Callable[..., AvailabilityProcess]] = {}
_FAULTS: dict[str, Callable[..., FaultInjector]] = {}


def register_process(name: str,
                     factory: Callable[..., AvailabilityProcess]) -> None:
    _PROCESSES[name] = factory


def register_fault(name: str, factory: Callable[..., FaultInjector]) -> None:
    _FAULTS[name] = factory


def process_names() -> list[str]:
    return sorted(_PROCESSES)


def fault_names() -> list[str]:
    return sorted(_FAULTS)


def _coerce(text: str) -> Any:
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    return text


def _parse_component(token: str) -> tuple[str, list[Any], dict[str, Any]]:
    """``name``, ``name:<positional>`` or ``name:k=v,k=v``."""
    name, _, rest = token.partition(":")
    name = name.strip()
    if not rest:
        return name, [], {}
    if "=" not in rest:
        return name, [_coerce(rest.strip())], {}
    kw: dict[str, Any] = {}
    for pair in rest.split(","):
        k, eq, v = pair.partition("=")
        if not eq:
            raise ValueError(f"bad scenario component {token!r}: "
                             f"expected key=val, got {pair!r}")
        kw[k.strip()] = _coerce(v.strip())
    return name, [], kw


def _build(factory: Callable[..., Any], name: str, args: list[Any],
           kw: dict[str, Any]) -> Any:
    sig = inspect.signature(factory)
    unknown = [k for k in kw if k not in sig.parameters]
    if unknown:
        raise ValueError(f"scenario component {name!r} does not accept "
                         f"{unknown} (accepts {list(sig.parameters)})")
    return factory(*args, **kw)


def parse_spec(spec: str) -> tuple[AvailabilityProcess, list[FaultInjector]]:
    """Parse a ``|``-separated spec string into instantiated components."""
    availability: AvailabilityProcess | None = None
    faults: list[FaultInjector] = []
    for token in spec.split("|"):
        token = token.strip()
        if not token:
            continue
        name, args, kw = _parse_component(token)
        if name in _PROCESSES:
            if availability is not None:
                raise ValueError(f"scenario spec {spec!r} names two "
                                 f"availability processes")
            availability = _build(_PROCESSES[name], name, args, kw)
        elif name in _FAULTS:
            faults.append(_build(_FAULTS[name], name, args, kw))
        else:
            raise ValueError(
                f"unknown scenario component {name!r}; processes: "
                f"{process_names()}, faults: {fault_names()}")
    if availability is None:
        availability = _PROCESSES["always_on"]()
    return availability, faults


def make_scenario(spec: "str | Scenario", population: int,
                  seed: int = 0) -> Scenario:
    """Build a seeded :class:`Scenario` from a spec string (the
    ``EdgeConfig.scenario`` entry point)."""
    if isinstance(spec, Scenario):
        if spec.population != population:
            raise ValueError(f"scenario built for population "
                             f"{spec.population}, runtime has {population}")
        return spec
    availability, faults = parse_spec(spec)
    return Scenario(availability, faults, population, seed, spec=spec)
