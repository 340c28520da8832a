"""The fleet fast path's fused device backend: float64 torch ops on the
engine's device (port of ``repro.edge.fleet.kernel``, whose x64 lax
kernels these mirror op for op).

``EdgeConfig.fleet_backend="jit"`` keeps the reference's name so configs
carry over; in the port it means this backend.  Each function mirrors
one vectorized-numpy reference in ``repro_torch.edge.allocation`` /
``EdgeRuntime.finish_round_sync``:

  * :func:`bandwidth_opt_widths_jit` — the barrier bisection of
    ``allocation.bandwidth_opt_widths`` (need(T) decreasing in T);
  * :func:`energy_opt_widths_jit` — the KKT-λ bisection of
    ``allocation.energy_opt_widths`` (floored Σ widths increasing in λ);
  * :func:`sync_round_jit` — one fused sync round past the decision:
    Shannon capacity at the granted widths → realized finish → deadline
    verdict (drop mask + on-air byte fractions) → capped barrier /
    server-drain / idle energy / battery update.  Star topology (the
    tree aggregation path stays on the numpy backend).

Nothing in a call waits for the device until its result is read back,
once, at the end.  The bisections run a fixed ``BISECT_ITERS`` trips
(the scalar reference's bracket sequence, iteration for iteration) with
``torch.where`` choosing each bracket on the device.  The reference's
data-dependent bracket doubling (at most ``_GROW_MAX`` doublings of hi
until need(hi) fits the budget) becomes one batched evaluation of all
``_GROW_MAX + 1`` candidates hi·2^j, exact as repeated doubling is, and
the first that fits (or the last) is taken on the device.

Numerics: results differ from numpy by float-op reassociation (torch
reductions are not numpy's pairwise sums), so the contract is that of
the reference's ``jit`` backend: identical discrete decisions (cohorts,
drop counts) and floats within rtol 1e-9 of the ``exact`` backend.  Every
quotient of a tensor divides by a tensor (the budget and the server rate
ride as 0-d tensors where they divide or are divided): a Python number
over a tensor, or a tensor over one, multiplies by a reciprocal, one
rounding away from numpy's quotient.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.edge.allocation import BISECT_EPS, BISECT_ITERS
from repro_torch.utils.device import resolve_device

_GROW_MAX = 200         # bracket-doubling cap, as in bandwidth_opt_widths
_GROW_ELEMS = 1 << 24   # (candidate, client) pairs a doubling batch holds
_F64 = torch.float64


def _f64(x, device) -> torch.Tensor:
    # the host->device boundary: x is host data (numpy or a number), read
    # on the host by design before it is copied to the device once
    # repro: allow[RPL003]
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def _need(T: torch.Tensor, bits, s, tc) -> torch.Tensor:
    """bandwidth_opt's Σ_k W_k(T) for each barrier of the (r,) ``T``: inf
    where some client has no air time left."""
    gap = T[:, None] - tc
    short = gap <= 0.0
    tot = torch.sum(bits / (s * torch.where(short, 1.0, gap)), dim=1)
    return torch.where(short.any(dim=1), torch.inf, tot)


def _bw_widths(bits, s, tc, budget: float, iters: int) -> torch.Tensor:
    budget_t = torch.full((), budget, dtype=_F64, device=tc.device)
    lo = torch.max(tc)                     # infeasible: zero air time
    hi = torch.maximum(2.0 * lo, lo + 1e-6)
    # the doubling: hi·2^j for j = 0.._GROW_MAX (powers of two by
    # repeated doubling, so each product is exact), the first that fits
    pow2 = torch.full((_GROW_MAX + 1,), 2.0, dtype=_F64,
                      device=tc.device).cumprod(0) / 2.0
    cands = hi * pow2
    rows = max(1, _GROW_ELEMS // max(tc.numel(), 1))
    fits = torch.cat([_need(c, bits, s, tc) <= budget
                      for c in torch.split(cands, rows)])
    fits[-1:].fill_(True)                  # the cap stops the doubling
    # select on the device: indexing by a 0-d tensor would read it on the
    # host
    first = torch.argmax(fits.to(torch.int8)).view(1)
    hi = torch.index_select(cands, 0, first)[0]
    b_lo, b_hi = lo, hi
    for _ in range(int(iters)):
        mid = 0.5 * (b_lo + b_hi)
        ok = _need(mid[None], bits, s, tc)[0] <= budget
        b_lo, b_hi = torch.where(ok, b_lo, mid), torch.where(ok, mid, b_hi)
    w = bits / (s * torch.clamp_min(b_hi - tc, BISECT_EPS))
    return w * (budget_t / torch.sum(w))   # hand back the bracket slack


def _energy_widths(c, w_min, feas, budget: float, iters: int
                   ) -> torch.Tensor:
    n = c.shape[0]
    budget_t = torch.full((), budget, dtype=_F64, device=c.device)
    w_floor = torch.where(feas, w_min, budget / n)
    total_floor = torch.sum(w_floor)
    w_floor = torch.where(total_floor > budget,
                          w_floor * (budget_t / total_floor), w_floor)
    sq = torch.sqrt(torch.clamp_min(c, 0.0))
    ssq = torch.sum(sq)
    b_lo = torch.zeros((), dtype=_F64, device=c.device)
    b_hi = budget_t / torch.clamp_min(ssq, 1e-300)
    for _ in range(int(iters)):
        mid = 0.5 * (b_lo + b_hi)
        ok = torch.sum(torch.maximum(w_floor, mid * sq)) <= budget
        b_lo, b_hi = torch.where(ok, mid, b_lo), torch.where(ok, b_hi, mid)
    w = torch.where(ssq > 0.0, torch.maximum(w_floor, b_lo * sq),
                    torch.clamp_min(w_floor, budget / n))
    tot = torch.sum(w)
    return torch.where(tot > 0.0, w * (budget_t / tot),
                       torch.full_like(w, budget / n))


def _realloc_finish(f, tc, d, w, dropped):
    """Twin of :func:`repro_torch.edge.events.reallocated_finish` in fixed
    shapes: survivors absorb the width each dropped client frees at its
    cutoff.  Non-dropped entries take a finite sentinel cut far beyond any
    real time (inf would poison the segment integrals), so the sorted
    breakpoint sweep keeps a static shape."""
    surv = ~dropped
    w_b = torch.broadcast_to(w, f.shape)
    w_surv = torch.sum(torch.where(surv, w_b, 0.0))
    ok = (torch.sum(dropped) > 0) & (w_surv > 0.0)
    w_safe = torch.where(ok, w_surv, 1.0)
    cut = torch.where(dropped, torch.minimum(f, d), 1e300)
    order = torch.argsort(cut, stable=True)
    ts = cut[order]
    c_seg = 1.0 + (torch.cumsum(torch.where(dropped, w_b, 0.0)[order], 0)
                   / w_safe)
    integ = torch.cat([ts[:1],
                       ts[0] + torch.cumsum(c_seg[:-1] * torch.diff(ts), 0)])
    last = ts.shape[0] - 1

    def cum(x):
        k = torch.searchsorted(ts, x, right=True) - 1
        kk = torch.clamp(k, 0, last)
        return torch.where(k >= 0, integ[kk] + c_seg[kk] * (x - ts[kk]), x)

    target = cum(tc) + (f - tc)
    j = torch.searchsorted(integ, target, right=True) - 1
    jj = torch.clamp(j, 0, last)
    fin = torch.where(j >= 0, ts[jj] + (target - integ[jj]) / c_seg[jj],
                      target)
    fin = torch.minimum(fin, f)      # never-later pin, as in numpy
    return torch.where(ok & surv, fin, f)


def _sync_round(w, snr, t_comp, up_bytes, e_comp, deadline, tol: float,
                tx_power: float, srv_rate, idle_power: float, battery,
                bill_bytes, reallocate: bool):
    # capacity at the granted widths (Channel.set_bandwidth), clamped as
    # in uplink_time_s
    rate = torch.clamp_min(w * torch.log2(1.0 + snr), 1e-6)
    t_up = 8.0 * up_bytes / rate
    time_s = t_comp + t_up
    e_tx = tx_power * t_up
    energy = e_comp + e_tx
    # deadline verdict (enforce_deadlines): the drop mask and the byte
    # fraction on the air before each cutoff
    dropped = time_s > deadline + tol
    air = torch.clamp_min(deadline - t_comp, 0.0)
    frac = torch.where(
        dropped,
        torch.where(t_up > 0.0,
                    torch.clamp_max(air / torch.clamp_min(t_up, 1e-300), 1.0),
                    0.0),
        1.0)
    # mid-round re-allocation (EdgeConfig.reallocate): each dropped
    # straggler's freed width re-lands on the surviving uploads from its
    # cutoff on, pulling survivor finishes — and the barrier — earlier.
    # Drops, fractions and billing above are already fixed at the granted
    # widths, so the ledger/verdict is untouched.
    e_tx_plan = e_tx
    n_realloc = torch.zeros((), dtype=torch.int64, device=w.device)
    rate_eff = rate
    if reallocate:
        new_t = _realloc_finish(time_s, t_comp, deadline, w, dropped)
        improved = (~dropped) & (new_t < time_s)
        n_realloc = torch.sum(improved)
        # survivors absorbed the freed width mid-round: the realized
        # effective rate (same bits, less air time) is what the
        # server-drain air-time floor below must see — mirrors the rate
        # rescale in EdgeRuntime._maybe_reallocate
        air_old = time_s - t_comp
        air_new = new_t - t_comp
        scale = torch.where(improved & (air_new > 0.0),
                            air_old / torch.clamp_min(air_new, 1e-300), 1.0)
        rate_eff = rate * scale
        e_tx = torch.where(dropped, e_tx, e_tx - tx_power * (time_s - new_t))
        time_s = new_t
    # star-topology finish (finish_round_sync): enforced barrier, then the
    # shared server slice drains the on-air bytes
    active = torch.minimum(time_s, deadline)
    barrier = torch.max(active)
    billed = bill_bytes * frac
    per = 8.0 * billed / torch.clamp_min(rate_eff, 1e-6)
    t_round = torch.maximum(
        barrier, torch.maximum(torch.max(per),
                               8.0 * torch.sum(billed) / srv_rate))
    # capped battery drain (DeadlineVerdict.capped_spend_j) + idle drain
    # until the round closes
    idle = torch.clamp_min(t_round - active, 0.0)
    e_comp_v = torch.clamp_min(energy - e_tx_plan, 0.0)
    comp_frac = torch.clamp_max(deadline / torch.clamp_min(t_comp, 1e-300),
                                1.0)
    spend = e_comp_v * comp_frac + e_tx * frac + idle_power * idle
    battery_new = torch.clamp_min(battery - spend, 0.0)
    return (barrier, t_round, torch.sum(spend), torch.sum(dropped),
            battery_new, frac, n_realloc)


def bandwidth_opt_widths_jit(bits, s, tc, budget: float,
                             iters: int = BISECT_ITERS,
                             device=None) -> np.ndarray:
    """Device twin of :func:`repro_torch.edge.allocation.bandwidth_opt_widths`
    on ``device`` (None: the card)."""
    dev = resolve_device("cuda" if device is None else device)
    w = _bw_widths(_f64(bits, dev), _f64(s, dev), _f64(tc, dev),
                   float(budget), int(iters))
    return w.cpu().numpy()


def energy_opt_widths_jit(c, w_min, feas, budget: float,
                          iters: int = BISECT_ITERS,
                          device=None) -> np.ndarray:
    """Device twin of :func:`repro_torch.edge.allocation.energy_opt_widths`
    on ``device`` (None: the card)."""
    dev = resolve_device("cuda" if device is None else device)
    w = _energy_widths(_f64(c, dev), _f64(w_min, dev),
                       torch.as_tensor(np.asarray(feas, dtype=bool),
                                       device=dev),
                       float(budget), int(iters))
    return w.cpu().numpy()


def sync_round_jit(w, snr, t_comp, up_bytes, e_comp, deadline,
                   tol: float, tx_power: float, srv_rate: float,
                   idle_power: float, battery, bill_bytes=None,
                   reallocate: bool = False, device=None) -> dict:
    """One fused star-topology sync round past the decision, on ``device``
    (None: the card).

    All per-client arrays align with the selected cohort; ``up_bytes``
    may be per-client (scenario workload shedding).  ``bill_bytes``
    (default ``up_bytes``) are the bytes the ledger meters — under
    shedding the plan is billed in full while the air time runs on the
    shed payload, exactly as ``finish_round_sync`` does.  ``reallocate``
    re-lands freed straggler width on survivors mid-round.  Returns a
    dict of host values (read back in one transfer): ``barrier_s``,
    ``t_round_s`` (barrier + server drain, pre-downlink), ``spend_j``
    (cohort total incl. idle drain), ``n_dropped``, ``battery_j``
    (updated per-client), ``tx_frac``, ``n_realloc`` (survivors whose
    finish moved earlier).
    """
    dev = resolve_device("cuda" if device is None else device)
    if bill_bytes is None:
        bill_bytes = up_bytes
    w = _f64(w, dev)
    barrier, t_round, spend, n_dropped, battery_new, frac, n_realloc = (
        _sync_round(w, _f64(snr, dev), _f64(t_comp, dev),
                    _f64(up_bytes, dev), _f64(e_comp, dev),
                    _f64(deadline, dev), float(tol), float(tx_power),
                    _f64(srv_rate, dev), float(idle_power), _f64(battery, dev),
                    _f64(bill_bytes, dev), bool(reallocate)))
    n = w.shape[0]
    host = torch.cat([
        torch.stack([barrier, t_round, spend, n_dropped.to(_F64),
                     n_realloc.to(_F64)]),
        torch.broadcast_to(battery_new, (n,)),
        torch.broadcast_to(frac, (n,))]).cpu().numpy()
    return {"barrier_s": float(host[0]), "t_round_s": float(host[1]),
            "spend_j": float(host[2]), "n_dropped": int(host[3]),
            "battery_j": host[5:5 + n].copy(),
            "tx_frac": host[5 + n:].copy(),
            "n_realloc": int(host[4])}
