"""repro_torch.edge.fleet — struct-of-arrays mega-scale fleet engine
(port of ``repro.edge.fleet``).

The dict-per-client hot path in :class:`repro_torch.edge.runtime.EdgeRuntime`
is interpreter-bound past ~10⁴ clients.  This subsystem keeps the same
round semantics over arrays:

  * :class:`FleetState` — the population as struct-of-arrays (static SNR
    shadowing, per-round fades, compute rates, batteries, busy/alive
    masks), drawn by the SAME constructors and rng streams as the dict
    path (`edge.channel.draw_snr_lin`, `edge.device.draw_flops_per_s`).
  * :mod:`kernel` — the fused device backend, float64 torch ops on the
    engine's device: the fixed-trip bisections mirroring the shared
    scalar cores in ``edge.allocation`` (``bandwidth_opt_widths`` /
    ``energy_opt_widths``) plus one fused sync-round function (capacity
    → realized finish → deadline verdict → capped barrier/energy/battery
    update).
  * :class:`FleetEngine` — a standalone sync-round driver over a
    population: ``backend="exact"`` delegates to an ``EdgeRuntime`` with
    the fleet fast path on (bit-identical to the dict path by
    construction), ``backend="jit"`` runs the fused device backend (equal
    up to float-op reassociation; identical rng streams, so cohorts and
    typically drop sets match the exact backend).

`EdgeRuntime` itself engages the array fast path automatically
(``EdgeConfig.fleet``) — the engine here is for driving rounds at
10⁵–10⁶ clients without a federated training loop attached, as
``chip_smoke.py``'s fleet phase does.  The ``EventClock`` stays reserved for
the async tail; sync fleet rounds advance a plain accumulator.
"""
from repro_torch.edge.fleet.engine import FleetEngine
from repro_torch.edge.fleet.state import FleetState

__all__ = ["FleetEngine", "FleetState"]
