"""Per-client resource allocation for the edge runtime.

The paper's resource-constrained FEEL formulation is about *how much* of
the wireless budget each client gets, not just *who* transmits.  An
``AllocationPolicy`` therefore returns a :class:`RoundDecision` — per
selected client an :class:`Allocation` (uplink ``bandwidth_hz`` drawn
from a shared round budget, an optional per-client upload codec, and a
deadline) plus the ids it deliberately excluded, with reasons.  Client
*selection* (the old ``Scheduler.select`` API) is the degenerate case
where every selected client gets an equal split of the budget.

Policies (register your own with :func:`register`):
  * uniform               — sample k uniformly (the paper's protocol),
                            equal bandwidth split.
  * deadline              — uniform proposal, then exclude clients whose
                            predicted finish exceeds the round deadline
                            (straggler dropping; the quantile-barrier
                            view of synchronous FEEL); equal split.
  * energy_threshold      — exclude clients whose battery is below a
                            floor or whose round energy exceeds a budget,
                            à la the threshold-based exclusion design of
                            arXiv:2104.05509 (exclusion == an allocation
                            of zero); equal split.
  * capacity_proportional — sample with probability ∝ predicted capacity
                            1/t_k, the resource-allocation reading of
                            arXiv:1910.13067; equal split.
  * bandwidth_opt         — uniform cohort, then minimize the sync-round
                            barrier max_k t_k subject to Σ_k W_k ≤ budget
                            by bisection on the arXiv:1910.13067 capacity
                            form t_k = t_comp,k + bits / (W_k·log2(1+γ_k)).
  * energy_opt            — the dual: minimize Σ_k E_k subject to every
                            selected client finishing within the round
                            deadline (and Σ_k W_k ≤ budget), by bisection
                            on the same capacity form; feasibility-aware
                            (clients that cannot meet the deadline at any
                            width within budget are excluded, with
                            reasons).
  * adaptive_codec        — uniform cohort + equal split, but each
                            client's top-k upload ratio is scheduled from
                            its sampled channel rate (fast links send
                            denser payloads); summable plans only.

Every policy sees the same :class:`RoundState`: the eligible ids with a
per-client :class:`ClientEstimate` under a *nominal* equal split, the
compute-only times, this round's spectral efficiencies, the shared
bandwidth budget, and the upload wire format.  Bandwidth-only policies
never change WHAT is transmitted — CommLedger bytes are allocation-
independent; per-client codecs change bytes only through the codec's
``wire_bytes``, and the ledger still equals the plan per client.
"""
from __future__ import annotations

import inspect
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Shared bisection core (the ONE scalar reference the fleet kernel mirrors)
# ---------------------------------------------------------------------------
# Both optimizing policies search a monotone scalar -> Σ widths map against
# the shared budget: bandwidth_opt bisects the barrier T (Σ W_k(T)
# decreasing in T), energy_opt the KKT multiplier λ (Σ max(floor, λ·√c)
# increasing in λ).  They share one iteration count and one width/slack
# tolerance so the vectorized fleet kernel (repro.edge.fleet.kernel) has
# exactly one reference to mirror.
BISECT_ITERS = 64       # bisection refinement steps (both policies)
BISECT_EPS = 1e-12      # width / budget slack floor shared by both searches

# the reference's x64 JAX fleet backend (repro.edge.fleet.kernel) has no
# port yet; the "exact" numpy backend is the port's fast path
JIT_NOT_PORTED = ("fleet_backend='jit' is not ported yet (ROADMAP item 6, "
                  "the fleet engine); use fleet_backend='exact'")


def bisect_budget(fn: Callable[[float], float], lo: float, hi: float,
                  budget: float, iters: int = BISECT_ITERS,
                  increasing: bool = False) -> float:
    """Bisect a monotone ``fn: scalar -> Σ widths`` against ``budget`` and
    return the feasible endpoint (``fn(x) <= budget``).  ``increasing``
    states fn's direction: False (bandwidth_opt's barrier T — feasible at
    large T, returns the shrunken hi), True (energy_opt's λ — feasible at
    small λ, returns the grown lo)."""
    lo, hi = float(lo), float(hi)
    for _ in range(int(iters)):
        mid = 0.5 * (lo + hi)
        if fn(mid) <= budget:
            lo, hi = (mid, hi) if increasing else (lo, mid)
        else:
            lo, hi = (lo, mid) if increasing else (mid, hi)
    return lo if increasing else hi


def bandwidth_opt_widths(bits: np.ndarray, s: np.ndarray, tc: np.ndarray,
                         budget: float,
                         iters: int = BISECT_ITERS) -> np.ndarray:
    """Barrier-minimizing subchannel widths on the arXiv:1910.13067
    capacity form (the bandwidth_opt objective), vectorized over the
    cohort: W_k(T) = bits_k / (s_k · (T − t_comp,k)) with the minimal
    feasible barrier T* pinned by Σ_k W_k(T) = budget; the final
    bracket's slack is handed back pro rata.  This is the scalar
    reference the jitted fleet kernel mirrors op-for-op."""
    bits = np.asarray(bits, dtype=float)
    s = np.asarray(s, dtype=float)
    tc = np.asarray(tc, dtype=float)
    budget = float(budget)

    def need(T: float) -> float:
        gap = T - tc
        if np.any(gap <= 0.0):
            return float("inf")
        return float((bits / (s * gap)).sum())

    lo = float(tc.max())                  # infeasible: zero air time
    hi = max(2.0 * lo, lo + 1e-6)
    for _ in range(200):
        if need(hi) <= budget:
            break
        hi *= 2.0
    hi = bisect_budget(need, lo, hi, budget, iters, increasing=False)
    w = bits / (s * np.maximum(hi - tc, BISECT_EPS))
    return w * (budget / w.sum())         # hand back the bracket slack


def deadline_min_widths(bits: np.ndarray, s: np.ndarray, tc: np.ndarray,
                        deadline_s: float) -> tuple[np.ndarray, np.ndarray]:
    """(c_k, W_min,k) on the capacity form: c_k = bits_k / s_k is the
    Hz·s each upload needs, W_min,k the narrowest subchannel that still
    meets the deadline (inf where compute alone busts it, 0 where there
    is nothing to send)."""
    c = np.asarray(bits, dtype=float) / np.asarray(s, dtype=float)
    tc = np.asarray(tc, dtype=float)
    gap = float(deadline_s) - tc
    w_min = np.where(gap > 0.0, c / np.maximum(gap, 1e-300), np.inf)
    return c, np.where((c <= 0.0) & (gap > 0.0), 0.0, w_min)


def feasible_packing(w_min: np.ndarray, tc: np.ndarray,
                     budget: float) -> np.ndarray:
    """Greedy ascending-W_min packing into the budget (ties broken by
    compute time) as a vectorized prefix-sum: sorted ascending, every
    accepted client is a prefix of the finite part, so the sequential
    ``used + w_min <= budget`` test is exactly the running cumsum."""
    w_min = np.asarray(w_min, dtype=float)
    order = np.lexsort((np.asarray(tc, dtype=float), w_min))
    used = np.cumsum(w_min[order])
    feas = np.zeros(len(w_min), dtype=bool)
    feas[order] = np.isfinite(w_min[order]) & (
        used <= float(budget) * (1 + BISECT_EPS))
    return feas


def energy_opt_widths(c: np.ndarray, w_min: np.ndarray, feas: np.ndarray,
                      budget: float, iters: int = BISECT_ITERS
                      ) -> np.ndarray:
    """Energy-minimizing KKT widths W_k = max(floor_k, √c_k / λ) with λ
    pinned by the budget — the energy_opt allocate stage, vectorized.
    ``feas`` marks clients whose W_min fits (floor = W_min); the rest
    (force-keeps) floor at the equal split.  The scalar reference the
    jitted fleet kernel mirrors op-for-op."""
    c = np.asarray(c, dtype=float)
    w_min = np.asarray(w_min, dtype=float)
    budget = float(budget)
    n = len(c)
    w_floor = np.where(feas, w_min, budget / n)
    total_floor = float(w_floor.sum())
    if total_floor > budget:
        w_floor = w_floor * (budget / total_floor)
    sq = np.sqrt(np.maximum(c, 0.0))
    if sq.sum() <= 0.0:                    # nothing to upload
        w = np.maximum(w_floor, budget / n)
    else:
        def floored(lam: float) -> float:
            return float(np.maximum(w_floor, lam * sq).sum())

        lam = bisect_budget(floored, 0.0, budget / sq.sum(), budget, iters,
                            increasing=True)
        w = np.maximum(w_floor, lam * sq)
    tot = float(w.sum())
    if tot <= 0.0:
        return np.full(n, budget / n)
    return w * (budget / tot)              # hand back the bracket slack


# ---------------------------------------------------------------------------
# Estimates (moved from the retired edge/scheduler.py surface)
# ---------------------------------------------------------------------------
@dataclass
class ClientEstimate:
    """Predicted per-client round cost under current channel/fleet state."""
    clients: np.ndarray      # (n,) eligible ids
    time_s: np.ndarray       # (n,) predicted compute + uplink time
    energy_j: np.ndarray     # (n,) predicted compute + uplink energy
    battery_j: np.ndarray    # (n,) remaining budget

    def for_ids(self, ids) -> "ClientEstimate":
        pos = {int(c): i for i, c in enumerate(self.clients)}
        sel = []
        for i in ids:
            if int(i) not in pos:
                raise ValueError(
                    f"client id {int(i)} is not in this estimate's eligible "
                    f"set of {len(self.clients)} clients "
                    f"({np.sort(self.clients).tolist()})")
            sel.append(pos[int(i)])
        sel = np.asarray(sel, dtype=int)
        return ClientEstimate(self.clients[sel], self.time_s[sel],
                              self.energy_j[sel], self.battery_j[sel])


# ---------------------------------------------------------------------------
# The decision types
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Allocation:
    """One selected client's share of the round: an uplink subchannel
    width drawn from the shared budget, an optional per-client upload
    codec (None = the plan's / run's codec), and the finish deadline the
    policy holds it to — a *runtime contract*: a client whose realized
    finish (compute + uplink at this granted width) exceeds it is cut
    off at the barrier, its upload discarded and only the bytes on the
    air before the cutoff billed (inf = no deadline)."""
    bandwidth_hz: float
    codec: Any = None              # Optional[repro_torch.fed.codecs.PayloadCodec]
    deadline_s: float = float("inf")


@dataclass
class RoundState:
    """Everything a policy may consult to decide one round.

    ``est`` covers the *eligible* (alive) clients, predicted under the
    nominal equal split ``budget_hz / k`` — so a pure selection policy
    reads it exactly as the old scheduler did.  ``wire_fn(codec|None)``
    answers "what does one client's upload cost on the wire under this
    codec override?" as ``(aggregatable_bytes, nonagg_bytes)``; policies
    never recompute plan bytes themselves."""
    k: int                          # target cohort size
    est: ClientEstimate             # eligible clients, nominal-split costs
    t_comp_s: np.ndarray            # (n,) compute-only share of est.time_s
    spectral_eff: np.ndarray        # (n,) bits/s/Hz under this round's fade
    budget_hz: float                # shared round uplink bandwidth budget
    rng: np.random.Generator
    codec: Any = None               # the run's base upload codec
    summable: bool = True           # plan.summable (gates codec overrides)
    wire_fn: Optional[Callable[[Any], tuple[float, float]]] = None
    payload_mult: Optional[np.ndarray] = None  # (n,) payloads per client
                                               # (duplicate cohort slots on
                                               # one device; None = 1 each)

    def mult(self) -> np.ndarray:
        if self.payload_mult is None:
            return np.ones(len(self.est.clients))
        return np.asarray(self.payload_mult, dtype=float)

    def wire_bytes(self, codec=None) -> tuple[float, float]:
        """Per-client (aggregatable, non-aggregatable) upload wire bytes
        under ``codec`` (None = the base codec)."""
        if self.wire_fn is not None:
            return self.wire_fn(codec)
        return (0.0, 0.0)

    def up_bits(self, codec=None) -> float:
        agg, nonagg = self.wire_bytes(codec)
        return 8.0 * (agg + nonagg)


@dataclass
class RoundDecision:
    """A policy's answer: who transmits with how much of the budget (and
    in which wire format), and who was excluded, with the reason.

    ``dropped`` is filled by the RUNTIME, not the policy: per allocated
    client that busted its granted deadline at the barrier, the reason it
    was cut off (``excluded`` is the a-priori exclusion, ``dropped`` the
    a-posteriori enforcement)."""
    allocations: dict[int, Allocation] = field(default_factory=dict)
    excluded: dict[int, str] = field(default_factory=dict)
    budget_hz: float = float("inf")
    dropped: dict[int, str] = field(default_factory=dict)

    @property
    def selected(self) -> list[int]:
        return list(self.allocations)

    @property
    def survivors(self) -> list[int]:
        """Allocated clients whose uploads actually landed (selected
        minus the runtime's deadline drops)."""
        return [i for i in self.allocations if i not in self.dropped]

    # count views shared with FleetDecision, so driver code stays
    # O(1)-per-decision and type-agnostic
    @property
    def n_selected(self) -> int:
        return len(self.allocations)

    @property
    def n_excluded(self) -> int:
        return len(self.excluded)

    @property
    def n_dropped(self) -> int:
        return len(self.dropped)

    @property
    def heterogeneous_codecs(self) -> bool:
        return any(a.codec is not None for a in self.allocations.values())

    def bandwidth(self, ids=None) -> np.ndarray:
        ids = self.selected if ids is None else ids
        return np.asarray([self.allocations[int(i)].bandwidth_hz
                           for i in ids], dtype=float)

    def codec_for(self, cid: int):
        """The client's upload codec override (None = plan/run codec)."""
        return self.allocations[int(cid)].codec

    def total_bandwidth_hz(self) -> float:
        return float(sum(a.bandwidth_hz for a in self.allocations.values()))

    def validate(self) -> "RoundDecision":
        """The allocation invariants every policy must satisfy: each
        transmitting client holds a strictly positive subchannel, and the
        round never hands out more than the shared budget."""
        for cid, a in self.allocations.items():
            if not a.bandwidth_hz > 0.0:
                raise ValueError(
                    f"allocation for client {cid} has non-positive bandwidth "
                    f"{a.bandwidth_hz!r}; exclude the client instead")
        total = self.total_bandwidth_hz()
        if total > self.budget_hz * (1.0 + 1e-9):
            raise ValueError(
                f"allocated bandwidth {total:.6g} Hz exceeds the round "
                f"budget {self.budget_hz:.6g} Hz")
        return self


# ---------------------------------------------------------------------------
# Fleet (struct-of-arrays) twins of RoundState / RoundDecision
# ---------------------------------------------------------------------------
@dataclass
class FleetRoundState:
    """The struct-of-arrays twin of :class:`RoundState` for the fleet
    fast path (`repro.edge.fleet`): the same per-round facts, but kept as
    arrays over the eligible population instead of per-client dicts.

    ``backend`` picks the width solver: ``"exact"`` runs the shared
    vectorized-numpy cores above (bit-identical to the scalar dict path
    by construction), ``"jit"`` the x64 lax kernels in
    ``repro.edge.fleet.kernel`` (equal up to float-op reassociation —
    XLA reductions are not bitwise numpy)."""
    k: int                          # target cohort size
    ids: np.ndarray                 # (n,) eligible (alive) client ids
    t_comp_s: np.ndarray            # (n,) compute-only times
    spectral_eff: np.ndarray        # (n,) bits/s/Hz under this round's fade
    budget_hz: float                # shared round uplink bandwidth budget
    rng: np.random.Generator
    up_bits: float = 0.0            # 8 · (agg + nonagg) wire bytes / payload
    payload_mult: Optional[np.ndarray] = None  # (n,) payloads per client
    est: Optional[ClientEstimate] = None       # nominal-split estimates
    backend: str = "exact"          # "exact" | "jit"

    def mult(self) -> np.ndarray:
        if self.payload_mult is None:
            return np.ones(len(self.ids))
        return np.asarray(self.payload_mult, dtype=float)


class FleetDecision:
    """An array-backed :class:`RoundDecision` twin: the same contract
    (selected ids in draw order, per-client width + deadline grant, the
    runtime's a-posteriori drops) without any per-client dict on the hot
    path.  The dict views (``allocations`` / ``excluded`` / ``dropped``)
    materialize lazily with the exact prose of the scalar path, so
    fingerprints and renderers see no difference."""

    def __init__(self, ids: np.ndarray, bandwidth_hz: np.ndarray,
                 deadline_s: np.ndarray, budget_hz: float, positions=None):
        self.ids = np.asarray(ids, dtype=int)
        self.bandwidth_hz_arr = np.asarray(bandwidth_hz, dtype=float)
        self.deadline_s_arr = np.asarray(deadline_s, dtype=float)
        self.budget_hz = float(budget_hz)
        # positions of ids within the FleetRoundState's eligible arrays
        # (None = the identity: a fixed full-cohort decision)
        self._positions = (None if positions is None
                           else np.asarray(positions, dtype=int))
        self._excluded_ids = np.asarray([], dtype=int)
        self._excluded_reason_fn = None
        self.excluded_bucket: Optional[str] = None
        self._verdict = None
        self._allocations = None
        self._excluded = None
        self._dropped = None

    def set_excluded(self, ids, reason_fn=None, bucket=None):
        """A-priori exclusions: ids plus a lazy ``reason_fn(position) ->
        prose`` (materialized only if someone reads ``excluded``) and the
        single ``reason_key`` bucket they all fall into (for O(1) drop
        accounting at fleet scale)."""
        self._excluded_ids = np.asarray(ids, dtype=int)
        self._excluded_reason_fn = reason_fn
        self.excluded_bucket = bucket
        self._excluded = None
        return self

    def set_verdict(self, verdict):
        """Attach the runtime's deadline verdict (fills ``dropped``)."""
        self._verdict = verdict
        self._dropped = None
        return self

    # --- array-facing surface (the fleet hot path) ---------------------
    @property
    def positions(self) -> np.ndarray:
        if self._positions is None:
            return np.arange(len(self.ids))
        return self._positions

    @property
    def n_selected(self) -> int:
        return len(self.ids)

    @property
    def n_excluded(self) -> int:
        return len(self._excluded_ids)

    @property
    def n_dropped(self) -> int:
        return 0 if self._verdict is None else int(self._verdict.dropped.sum())

    @property
    def drop_mask(self) -> np.ndarray:
        """(n_selected,) True where the runtime cut the upload off."""
        if self._verdict is None:
            return np.zeros(len(self.ids), dtype=bool)
        return self._verdict.dropped

    # --- RoundDecision-compatible surface ------------------------------
    @property
    def selected(self) -> list[int]:
        return self.ids.tolist()

    @property
    def survivors(self) -> list[int]:
        if self._verdict is None:
            return self.ids.tolist()
        return self.ids[~self._verdict.dropped].tolist()

    @property
    def heterogeneous_codecs(self) -> bool:
        return False     # the fleet path schedules widths, never codecs

    @property
    def allocations(self) -> dict[int, Allocation]:
        if self._allocations is None:
            self._allocations = {
                int(i): Allocation(bandwidth_hz=float(w), deadline_s=float(d))
                for i, w, d in zip(self.ids, self.bandwidth_hz_arr,
                                   self.deadline_s_arr, strict=True)}
        return self._allocations

    @property
    def excluded(self) -> dict[int, str]:
        if self._excluded is None:
            fn = self._excluded_reason_fn or (lambda j: "excluded")
            self._excluded = {int(c): fn(j)
                              for j, c in enumerate(self._excluded_ids)}
        return self._excluded

    @property
    def dropped(self) -> dict[int, str]:
        if self._dropped is None:
            self._dropped = ({} if self._verdict is None
                             else self._verdict.reasons())
        return self._dropped

    def bandwidth(self, ids=None) -> np.ndarray:
        if ids is None:
            return self.bandwidth_hz_arr
        pos = {int(c): i for i, c in enumerate(self.ids)}
        return self.bandwidth_hz_arr[[pos[int(i)] for i in ids]]

    def codec_for(self, cid: int):
        return None

    def total_bandwidth_hz(self) -> float:
        return float(self.bandwidth_hz_arr.sum())

    def validate(self) -> "FleetDecision":
        if len(self.ids) and not (self.bandwidth_hz_arr > 0.0).all():
            bad = int(self.ids[np.argmin(self.bandwidth_hz_arr)])
            raise ValueError(
                f"allocation for client {bad} has non-positive bandwidth; "
                f"exclude the client instead")
        total = self.total_bandwidth_hz()
        if total > self.budget_hz * (1.0 + 1e-9):
            raise ValueError(
                f"allocated bandwidth {total:.6g} Hz exceeds the round "
                f"budget {self.budget_hz:.6g} Hz")
        return self


# ---------------------------------------------------------------------------
# The policy protocol
# ---------------------------------------------------------------------------
class AllocationPolicy:
    """decide(RoundState) -> RoundDecision.

    ``decide`` composes two overridable stages: ``select`` (who, and who
    is excluded why) and ``allocate`` (how much of the budget each
    selected client gets).  The default ``allocate`` is the uniform
    split, so a pure selection policy only implements ``select`` — the
    four ``make_scheduler``-era policies are exactly that."""

    name = "base"
    needs_summable = False   # True: the policy emits per-client sparsifying
                             # codecs, meaningful only for additive payloads
    vectorized = False       # True: decide_vectorized is a real fast path

    def decide(self, state: RoundState) -> RoundDecision:
        ids, excluded = self.select(state)
        return RoundDecision(allocations=self.allocate(ids, state),
                             excluded=excluded,
                             budget_hz=state.budget_hz).validate()

    def decide_vectorized(self, fstate: FleetRoundState
                          ) -> Optional[FleetDecision]:
        """The fleet fast path: the same decision as :meth:`decide` but
        computed with array ops over a :class:`FleetRoundState` — on the
        ``"exact"`` backend, bit-identical to the scalar path because
        both run the shared vectorized cores above.  Returns None when
        the policy has no vectorized form (``vectorized`` False); the
        runtime then falls back to the scalar dict path."""
        if not self.vectorized:
            return None
        pick = self._uniform_pick(fstate)
        n = len(pick)
        if n == 0:
            w = d = np.asarray([], dtype=float)
        else:
            w, d = self.allocate_vectorized(fstate, pick)
        return FleetDecision(fstate.ids[pick], w, d, fstate.budget_hz,
                             positions=pick)

    def allocate_vectorized(self, fstate: FleetRoundState, sel: np.ndarray
                            ) -> tuple[np.ndarray, np.ndarray]:
        """-> (widths, deadline grants) over ``fstate`` positions
        ``sel``.  Default: the uniform split, no deadline."""
        n = len(sel)
        return np.full(n, fstate.budget_hz / n), np.full(n, np.inf)

    def select(self, state: RoundState) -> tuple[list[int], dict[int, str]]:
        """-> (selected ids, {excluded id: reason})."""
        raise NotImplementedError

    def allocate(self, ids: Sequence[int],
                 state: RoundState) -> dict[int, Allocation]:
        """Split the round budget over the selected ids (default: equal)."""
        ids = [int(i) for i in ids]
        if not ids:
            return {}
        w = state.budget_hz / len(ids)
        return {i: Allocation(bandwidth_hz=w) for i in ids}

    # shared proposal: sample k uniformly (the paper's protocol)
    @staticmethod
    def _uniform_positions(state: RoundState) -> np.ndarray:
        """The uniform draw as positions into the eligible arrays (the
        same rng call as :meth:`_uniform_pick`, so the dict and fleet
        cohorts match bitwise)."""
        n = len(state.est.clients)
        return state.rng.choice(n, size=min(state.k, n), replace=False)

    @staticmethod
    def _uniform_ids(state: RoundState) -> list[int]:
        pick = AllocationPolicy._uniform_positions(state)
        return [int(state.est.clients[i]) for i in pick]

    @staticmethod
    def _uniform_pick(fstate: FleetRoundState) -> np.ndarray:
        """The same uniform draw as :meth:`_uniform_ids` (identical rng
        call, so the cohorts match bitwise), returned as positions."""
        n = len(fstate.ids)
        return fstate.rng.choice(n, size=min(fstate.k, n), replace=False)


class UniformPolicy(AllocationPolicy):
    """Uniform cohort, equal bandwidth split — the paper's protocol."""
    name = "uniform"
    vectorized = True

    def select(self, state):
        return self._uniform_ids(state), {}


class DeadlinePolicy(AllocationPolicy):
    """Uniform proposal, then exclude predicted stragglers past
    ``deadline_s``.  Keeps at least ``min_clients`` (the fastest) so a
    tight deadline can never stall training entirely.  Survivors share
    the full budget equally, so dropping stragglers also widens everyone
    else's subchannel.

    Deadline grants (what the runtime enforces): an admitted client is
    granted ``deadline_s``; since admission predicts under the *nominal*
    equal split and the granted width is at least nominal, an admitted
    client's realized finish never exceeds its prediction — under zero
    channel noise it is never dropped at the barrier.  A client kept
    only by the ``min_clients`` floor (predicted past the deadline) is
    granted *no* deadline (inf): the policy insists on its progress, so
    the runtime must not cut it off.

    Both the scalar dict path and ``decide_vectorized`` run the same
    shared cores (:func:`deadline_min_widths` for the per-client
    admission floor, :func:`feasible_packing` as the budget-feasibility
    authority), so the fleet fast path is bit-identical to the dict path
    by construction rather than by parallel reimplementation."""
    name = "deadline"
    vectorized = True

    def __init__(self, deadline_s: float, min_clients: int = 1):
        self.deadline_s = float(deadline_s)
        self.min_clients = int(min_clients)

    # --- the shared admission core (both paths, bitwise) ---------------
    def _admit(self, t_nom: np.ndarray, bits: np.ndarray, s: np.ndarray,
               tc: np.ndarray, budget: float, k: int
               ) -> tuple[np.ndarray, np.ndarray, float]:
        """-> (admitted mask, W_min, W_nom).  Admission is in *time*
        space — a client is admitted iff its predicted nominal finish
        ``t_nom`` (``est.time_s``: equal split, this round's draw) meets
        the deadline — AND its narrowest deadline-meeting subchannel
        (``deadline_min_widths``) greedily packs into the budget
        (``feasible_packing``; for the equal split Σ W_min over admitted
        clients <= k·W_nom <= budget, so the packing rule only bites at
        float borderline — it is kept as the shared feasibility
        authority so admission can never outgrow the budget)."""
        w_nom = budget / max(k, 1)
        _c, w_min = deadline_min_widths(bits, s, tc, self.deadline_s)
        return ((t_nom <= self.deadline_s)
                & feasible_packing(w_min, tc, budget)), w_min, w_nom

    def _keep(self, admit: np.ndarray, t_nom: np.ndarray) -> np.ndarray:
        """Admission plus the ``min_clients`` floor: when too few admit,
        force-keep the predicted-fastest ``min_clients`` instead."""
        if int(admit.sum()) >= self.min_clients:
            return admit
        order = np.argsort(t_nom)
        keep = np.zeros(len(admit), dtype=bool)
        keep[order[:self.min_clients]] = True
        return keep

    def _reason(self, t_nom: float) -> str:
        if t_nom <= self.deadline_s:   # packed out at float borderline
            return ("meets the deadline but the admitted floors fill "
                    "the budget")
        return (f"predicted finish {t_nom:.3g}s > deadline "
                f"{self.deadline_s:g}s")

    def _grants(self, t_nom: np.ndarray) -> np.ndarray:
        """Deadline grants over the selected set: clients predicted to
        meet ``deadline_s`` are held to it, floor force-keeps (predicted
        past it) are granted none (inf)."""
        return np.where(t_nom <= self.deadline_s, self.deadline_s, np.inf)

    # --- scalar dict path ----------------------------------------------
    def select(self, state):
        pick = self._uniform_positions(state)
        clients = state.est.clients[pick]
        t_nom = state.est.time_s[pick]
        bits = state.up_bits() * state.mult()[pick]
        admit, _w_min, _w_nom = self._admit(
            t_nom, bits, state.spectral_eff[pick], state.t_comp_s[pick],
            float(state.budget_hz), state.k)
        keep = self._keep(admit, t_nom)
        selected = [int(c) for c in clients[keep]]
        excluded = {int(c): self._reason(float(t))
                    for c, t in zip(clients[~keep], t_nom[~keep],
                                    strict=True)}
        return selected, excluded

    def allocate(self, ids, state):
        base = super().allocate(ids, state)
        if not base:
            return base
        pred = state.est.for_ids(list(base)).time_s
        grants = self._grants(pred)
        return {i: Allocation(bandwidth_hz=a.bandwidth_hz,
                              deadline_s=float(d))
                for (i, a), d in zip(base.items(), grants, strict=True)}

    # --- fleet fast path -----------------------------------------------
    def _t_nom(self, fstate, idx) -> np.ndarray:
        """The scalar path's ``est.time_s`` op-for-op
        (``Channel.set_bandwidth`` then ``uplink_time_s`` at the nominal
        equal split), so admission, the floor ordering, grants, and the
        exclusion prose match the dict path bitwise."""
        bits = fstate.up_bits * fstate.mult()[idx]
        w_nom = float(fstate.budget_hz) / max(fstate.k, 1)
        return (fstate.t_comp_s[idx]
                + bits / np.maximum(w_nom * fstate.spectral_eff[idx], 1e-6))

    def allocate_vectorized(self, fstate, sel):
        n = len(sel)
        budget = float(fstate.budget_hz)
        return (np.full(n, budget / max(n, 1)),
                self._grants(self._t_nom(fstate, sel)))

    def decide_vectorized(self, fstate):
        pick = self._uniform_pick(fstate)
        budget = float(fstate.budget_hz)
        if len(pick) == 0:
            e = np.asarray([], dtype=float)
            return FleetDecision(fstate.ids[pick], e, e.copy(), budget,
                                 positions=pick)
        bits = fstate.up_bits * fstate.mult()[pick]
        s = fstate.spectral_eff[pick]
        tc = fstate.t_comp_s[pick]
        t_nom = self._t_nom(fstate, pick)
        admit, _w_min, _w_nom = self._admit(t_nom, bits, s, tc, budget,
                                            fstate.k)
        keep = self._keep(admit, t_nom)
        sel = pick[keep]
        w, grants = self.allocate_vectorized(fstate, sel)
        dec = FleetDecision(fstate.ids[sel], w, grants, budget,
                            positions=sel)
        if bool((~keep).any()):
            t_e = t_nom[~keep]
            dec.set_excluded(
                fstate.ids[pick[~keep]],
                reason_fn=lambda j: self._reason(float(t_e[j])),
                bucket="deadline")
        return dec


class EnergyThresholdPolicy(AllocationPolicy):
    """Exclude depleted clients (battery below ``battery_floor_j``) and
    clients whose predicted round energy exceeds ``round_budget_j`` —
    arXiv:2104.05509's threshold exclusion, expressed as an allocation
    of zero."""
    name = "energy_threshold"

    def __init__(self, battery_floor_j: float = 0.0,
                 round_budget_j: float = math.inf):
        self.battery_floor_j = float(battery_floor_j)
        self.round_budget_j = float(round_budget_j)

    def select(self, state):
        est = state.est
        ok = ((est.battery_j > self.battery_floor_j)
              & (est.energy_j <= self.round_budget_j)
              & (est.energy_j <= est.battery_j))
        excluded = {}
        for c, e, b in zip(est.clients[~ok], est.energy_j[~ok],
                           est.battery_j[~ok], strict=True):
            excluded[int(c)] = (
                f"battery {b:.3g}J under floor {self.battery_floor_j:g}J"
                if b <= self.battery_floor_j else
                f"round energy {e:.3g}J over budget "
                f"{min(self.round_budget_j, b):.3g}J")
        eligible = est.clients[ok]
        if len(eligible) == 0:
            return [], excluded
        pick = state.rng.choice(len(eligible),
                                size=min(state.k, len(eligible)),
                                replace=False)
        return [int(eligible[i]) for i in pick], excluded


class CapacityProportionalPolicy(AllocationPolicy):
    """Sample the cohort with P(k) ∝ 1 / t_k (predicted capacity), the
    selection reading of arXiv:1910.13067; equal bandwidth split.

    Approximation note: ``rng.choice(..., replace=False, p=p)`` draws
    sequentially with renormalization after each pick, which is NOT the
    exact "probability-proportional-to-size without replacement" design
    (inclusion probabilities differ from k·p_k, most visibly for heavy
    p's near 1/k).  It preserves the intended ordering — faster clients
    are strictly more likely — which is all the policy relies on."""
    name = "capacity_proportional"

    def select(self, state):
        est = state.est
        n = len(est.clients)
        cap = 1.0 / np.maximum(est.time_s, 1e-9)
        cap = np.where(np.isfinite(cap), cap, 0.0)
        p = cap / cap.sum()
        assert math.isclose(float(p.sum()), 1.0, rel_tol=1e-9), \
            f"selection probabilities must renormalize to 1, got {p.sum()}"
        pick = state.rng.choice(n, size=min(state.k, n), replace=False, p=p)
        return [int(est.clients[i]) for i in pick], {}


class BandwidthOptPolicy(AllocationPolicy):
    """Minimize the sync-round barrier max_k t_k under Σ_k W_k ≤ budget.

    The arXiv:1910.13067 capacity form: client k finishing by time T
    needs W_k(T) = bits / (s_k · (T − t_comp,k)) with s_k = log2(1+γ_k)
    its spectral efficiency this round.  Each W_k(T) is decreasing in T,
    so the minimal feasible barrier T* solves Σ_k W_k(T) = budget —
    found by bisection; the slack from the final bracket is handed back
    pro rata so the full budget is always in the air.  The cohort itself
    is the paper's uniform sample, which keeps bytes (and, under a fixed
    seed, the cohort) identical to ``uniform`` — only the per-client
    subchannel widths, and therefore the barrier, change."""
    name = "bandwidth_opt"
    vectorized = True

    def __init__(self, iters: int = BISECT_ITERS):
        self.iters = int(iters)

    def select(self, state):
        return self._uniform_ids(state), {}

    def allocate(self, ids, state):
        ids = [int(i) for i in ids]
        if not ids:
            return {}
        bits = state.up_bits()
        if bits <= 0.0:          # nothing to upload: any split is optimal
            return super().allocate(ids, state)
        pos = {int(c): i for i, c in enumerate(state.est.clients)}
        sel = np.asarray([pos[i] for i in ids], dtype=int)
        s = np.maximum(state.spectral_eff[sel], 1e-9)   # bits/s/Hz
        tc = np.asarray(state.t_comp_s[sel], dtype=float)
        w = bandwidth_opt_widths(bits * state.mult()[sel], s, tc,
                                 state.budget_hz, self.iters)
        return {i: Allocation(bandwidth_hz=float(wk))
                for i, wk in zip(ids, w, strict=True)}

    def allocate_vectorized(self, fstate, sel):
        bits = fstate.up_bits
        n = len(sel)
        if bits <= 0.0:
            w = np.full(n, fstate.budget_hz / n)
        else:
            s = np.maximum(fstate.spectral_eff[sel], 1e-9)
            tc = np.asarray(fstate.t_comp_s[sel], dtype=float)
            b = bits * fstate.mult()[sel]
            if fstate.backend == "jit":
                raise NotImplementedError(JIT_NOT_PORTED)
            else:
                w = bandwidth_opt_widths(b, s, tc, fstate.budget_hz,
                                         self.iters)
        return w, np.full(n, np.inf)


class EnergyOptPolicy(AllocationPolicy):
    """Minimize the cohort's total energy Σ_k E_k subject to every
    selected client finishing within ``deadline_s`` — the dual of
    ``bandwidth_opt`` (which minimizes the barrier subject to the
    budget; here the deadline is the constraint and energy the
    objective), following the resource-allocation formulation of
    arXiv:1910.13067.

    With E_k = e_comp,k + P_tx · t_up,k and t_up,k = c_k / W_k on the
    capacity form (c_k = bits_k / s_k, s_k = log2(1+γ_k) this round's
    spectral efficiency), compute energy is width-independent, so the
    problem is  min Σ_k c_k / W_k  s.t.  Σ_k W_k ≤ budget  and
    W_k ≥ W_min,k = c_k / (deadline − t_comp,k)  (the narrowest
    subchannel that still meets the deadline).  The KKT point is
    W_k = max(W_min,k, √c_k / λ) with λ pinned by the budget — found by
    per-client bisection on λ; the final bracket's slack is scaled back
    pro rata (scaling up never violates a W_min), so the full budget is
    in the air and Σ energy is the constrained minimum — strictly below
    the uniform split whenever the c_k are heterogeneous (Cauchy–
    Schwarz).

    Feasibility-aware selection: a uniform proposal, then clients whose
    compute alone busts the deadline (no width can save them) and, in
    ascending-W_min order, clients whose minimal widths no longer fit
    the remaining budget are excluded with reasons.  If fewer than
    ``min_clients`` are feasible, the cheapest remaining clients are
    force-kept at (at least) the equal-split width; the deadline grant
    is re-derived from the widths actually handed out — a kept client
    whose width cannot guarantee the deadline is granted none (inf): the
    policy insists on its progress, so the runtime must not cut it
    off."""
    name = "energy_opt"
    vectorized = True

    def __init__(self, deadline_s: float, min_clients: int = 1,
                 iters: int = BISECT_ITERS):
        self.deadline_s = float(deadline_s)
        self.min_clients = int(min_clients)
        self.iters = int(iters)

    def _capacity(self, ids, state):
        """Per-client (c_k, t_comp,k, W_min,k) on the capacity form;
        W_min is inf where no width meets the deadline."""
        pos = {int(c): i for i, c in enumerate(state.est.clients)}
        sel = np.asarray([pos[int(i)] for i in ids], dtype=int)
        s = np.maximum(state.spectral_eff[sel], 1e-9)
        tc = np.asarray(state.t_comp_s[sel], dtype=float)
        c, w_min = deadline_min_widths(state.up_bits() * state.mult()[sel],
                                       s, tc, self.deadline_s)
        return c, tc, w_min

    def _feasible(self, w_min, tc, budget):
        """Greedy ascending-W_min packing into the budget (deterministic:
        ties broken by compute time) — the shared feasibility rule select
        and allocate both apply, so they can never disagree."""
        return feasible_packing(w_min, tc, budget)

    def _reason(self, w_min_j, tc_j, free, budget):
        if not np.isfinite(w_min_j):
            return (f"compute alone takes {tc_j:.3g}s ≥ deadline "
                    f"{self.deadline_s:g}s — infeasible at any bandwidth")
        return (f"needs ≥ {w_min_j:.3g} Hz to finish by "
                f"{self.deadline_s:g}s but only {max(free, 0.0):.3g} Hz "
                f"of the {budget:.3g} Hz budget remains")

    def _kept_positions(self, w_min, tc, feas, budget):
        """Positions kept by select: every feasible client plus, in
        ascending-(W_min, t_comp) order, enough infeasible force-keeps to
        reach ``min_clients``.  Returns (sorted kept positions, free Hz)."""
        order = np.lexsort((tc, w_min))
        kept = feas.copy()
        short = self.min_clients - int(feas.sum())
        if short > 0:
            infeasible = order[~feas[order]]
            kept[infeasible[:short]] = True
        free = float(budget) - float(w_min[feas].sum())
        return np.flatnonzero(kept), free

    def select(self, state):
        ids = self._uniform_ids(state)
        if not ids:
            return ids, {}
        c, tc, w_min = self._capacity(ids, state)
        budget = float(state.budget_hz)
        feas = self._feasible(w_min, tc, budget)
        kept_pos, free = self._kept_positions(w_min, tc, feas, budget)
        kept = set(kept_pos.tolist())
        excluded = {int(ids[j]): self._reason(w_min[j], tc[j], free, budget)
                    for j in range(len(ids)) if j not in kept}
        return [int(ids[j]) for j in sorted(kept)], excluded

    def allocate(self, ids, state):
        ids = [int(i) for i in ids]
        if not ids:
            return {}
        c, tc, w_min = self._capacity(ids, state)
        budget = float(state.budget_hz)
        feas = self._feasible(w_min, tc, budget)
        # floors: a feasible client holds its minimal deadline-meeting
        # width; a force-kept (infeasible) client holds the equal-split
        # share, like DeadlinePolicy's keeps — never a vanishing sliver
        # of bisection slack (an inf-deadline client on a ~0 Hz channel
        # would blow the barrier and Σ energy unboundedly).  If the
        # combined floors overflow the budget the guarantees are jointly
        # unsatisfiable — everyone shrinks pro rata and the deadline
        # grant below re-derives from the widths actually handed out.
        w = energy_opt_widths(c, w_min, feas, budget, self.iters)
        # grant the deadline iff the width actually handed out still
        # guarantees it (W ≥ W_min) — a force-kept client whose equal
        # share happens to meet the deadline earns the grant, one whose
        # floor was shrunk below W_min loses it (inf: runtime must not
        # cut off a client the policy could not provision)
        ok = w >= w_min * (1.0 - 1e-9)
        return {i: Allocation(
                    bandwidth_hz=float(wk),
                    deadline_s=(self.deadline_s if k else float("inf")))
                for i, wk, k in zip(ids, w, ok, strict=True)}

    def _capacity_vec(self, fstate, sel):
        s = np.maximum(fstate.spectral_eff[sel], 1e-9)
        tc = np.asarray(fstate.t_comp_s[sel], dtype=float)
        c, w_min = deadline_min_widths(fstate.up_bits * fstate.mult()[sel],
                                       s, tc, self.deadline_s)
        return c, tc, w_min

    def allocate_vectorized(self, fstate, sel):
        n = len(sel)
        c, tc, w_min = self._capacity_vec(fstate, sel)
        budget = float(fstate.budget_hz)
        feas = self._feasible(w_min, tc, budget)
        if fstate.backend == "jit":
            raise NotImplementedError(JIT_NOT_PORTED)
        else:
            w = energy_opt_widths(c, w_min, feas, budget, self.iters)
        ok = w >= w_min * (1.0 - 1e-9)
        return w, np.where(ok, self.deadline_s, np.inf)

    def decide_vectorized(self, fstate):
        pick = self._uniform_pick(fstate)
        if len(pick) == 0:
            return FleetDecision(np.asarray([], dtype=int),
                                 np.asarray([], dtype=float),
                                 np.asarray([], dtype=float),
                                 fstate.budget_hz,
                                 positions=np.asarray([], dtype=int))
        c, tc, w_min = self._capacity_vec(fstate, pick)
        budget = float(fstate.budget_hz)
        feas = self._feasible(w_min, tc, budget)
        kept_pos, free = self._kept_positions(w_min, tc, feas, budget)
        kept = np.zeros(len(pick), dtype=bool)
        kept[kept_pos] = True
        sel = pick[kept_pos]                 # sorted draw positions, as select
        w, grants = self.allocate_vectorized(fstate, sel)
        dec = FleetDecision(fstate.ids[sel], w, grants, budget,
                            positions=sel)
        excl = ~kept
        if excl.any():
            w_min_e, tc_e = w_min[excl], tc[excl]
            dec.set_excluded(
                fstate.ids[pick[excl]],
                # reasons materialize lazily (dec.excluded) — same prose as
                # the scalar path; both exclusion kinds bucket under
                # reason_key as "bandwidth_infeasible"
                reason_fn=lambda j: self._reason(w_min_e[j], tc_e[j],
                                                 free, budget),
                bucket="bandwidth_infeasible")
        return dec


class AdaptiveCodecPolicy(AllocationPolicy):
    """Uniform cohort + equal split, but each client's top-k upload ratio
    is scheduled from its sampled channel rate: a client whose allocated
    subchannel is r× the cohort median runs top-k at ``ratio`` · r
    (clipped to [ratio_floor, 1]), so slow links send sparser payloads
    and the uplink barrier flattens.  A client whose scheduled format
    would cost at least as many wire bytes as the base codec (top-k
    ships value + index, 8 B per kept element, so ratio ≥ 0.5 dominates
    a dense 4 B/element payload) keeps the base codec instead —
    sparsifying is only ever a discount.  Sparsification zeroes
    coordinates, which only additive payloads survive — the policy
    refuses non-summable plans (``needs_summable``)."""
    name = "adaptive_codec"
    needs_summable = True

    def __init__(self, ratio: float = 0.25, ratio_floor: float = 0.02):
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"adaptive_codec ratio must be in (0, 1], "
                             f"got {ratio}")
        self.ratio = float(ratio)
        self.ratio_floor = float(ratio_floor)

    def select(self, state):
        return self._uniform_ids(state), {}

    def allocate(self, ids, state):
        if not state.summable:
            raise ValueError(
                "adaptive_codec schedules per-client top-k sparsification, "
                "which is only meaningful for additive (summable) payloads; "
                "this plan uploads distinct models/components")
        from repro_torch.fed.codecs import TopKCodec  # late: avoid edge<->fed cycle

        base = super().allocate(ids, state)
        if not base:
            return base
        pos = {int(c): i for i, c in enumerate(state.est.clients)}
        sel = np.asarray([pos[int(i)] for i in ids], dtype=int)
        rate = (np.asarray([base[int(i)].bandwidth_hz for i in ids])
                * np.maximum(state.spectral_eff[sel], 1e-9))
        ref = float(np.median(rate))
        ratios = np.clip(self.ratio * rate / max(ref, 1e-12),
                         self.ratio_floor, 1.0)
        base_bytes = sum(state.wire_bytes(None))
        out = {}
        for i, r in zip(ids, ratios, strict=True):
            codec = TopKCodec(float(r))
            if sum(state.wire_bytes(codec)) >= base_bytes:
                codec = None    # dominated format: keep the base codec
            out[int(i)] = Allocation(
                bandwidth_hz=base[int(i)].bandwidth_hz, codec=codec)
        return out


# ---------------------------------------------------------------------------
# Registry (mirrors repro_torch.fed.strategies / repro_torch.fed.codecs)
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[..., AllocationPolicy]] = {}


def register(name: str,
             factory: Optional[Callable[..., AllocationPolicy]] = None):
    """Register ``factory(**knobs) -> AllocationPolicy`` under ``name``.
    Usable as a decorator on a policy class or called directly."""

    def _do(f):
        try:
            f.name = name
        except (AttributeError, TypeError):
            pass
        _REGISTRY[name] = f
        return f

    return _do if factory is None else _do(factory)


def get(name: str) -> Callable[..., AllocationPolicy]:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown allocation policy {name!r}; known: {names()}")
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def make_policy(name: str, **kw) -> AllocationPolicy:
    """Build a policy by name.  ``kw`` may be a superset of the policy's
    knobs (EdgeConfig passes every policy knob it carries); anything the
    factory does not accept is dropped."""
    factory = get(name)
    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):
        return factory(**kw)
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return factory(**kw)
    return factory(**{k: v for k, v in kw.items() if k in params})


register("uniform", UniformPolicy)
register("deadline", DeadlinePolicy)
register("energy_threshold", EnergyThresholdPolicy)
register("capacity_proportional", CapacityProportionalPolicy)
register("bandwidth_opt", BandwidthOptPolicy)
register("energy_opt", EnergyOptPolicy)
register("adaptive_codec", AdaptiveCodecPolicy)
