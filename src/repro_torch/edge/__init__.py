"""repro_torch.edge — resource-constrained wireless edge runtime (port of
``repro.edge``; numpy only apart from ``fleet/kernel.py``, the fused
float64 torch backend, so the modules are the reference's own code with
imports rerooted).

The paper's premise is *resource-constrained* FEEL: hundreds of remote
devices behind expensive uplinks.  This subsystem simulates that layer
under the federated loop, converting the byte counts the ``CommLedger``
already tracks into wall-clock time and energy:

  * channel.py    — Shannon-capacity uplink/downlink (per-client
                    bandwidth, per-round SNR draws, optional Rayleigh
                    fading), star and tree topologies (the two readings
                    of Theorem 3);
  * device.py     — heterogeneous compute fleet (FLOPs/s, J/FLOP, battery)
                    and the client FLOP estimators the round plans use;
  * allocation.py — per-client resource allocation: an AllocationPolicy
                    registry whose decide(RoundState) -> RoundDecision
                    apportions a shared round bandwidth budget (and,
                    optionally, per-client upload codecs) over the
                    selected cohort — uniform (the paper's), deadline
                    straggler dropping, energy-threshold exclusion
                    (arXiv:2104.05509), capacity-proportional selection,
                    the bandwidth_opt barrier-minimizing convex
                    allocation and its dual energy_opt (minimize Σ E_k
                    under a deadline, arXiv:1910.13067), channel-adaptive
                    top-k codecs;
  * scheduler.py  — back-compat shim for the Scheduler-era names;
  * async_agg.py  — buffered asynchronous aggregation with
                    staleness-discounted weights (FedBuff-style);
  * events.py     — event-driven simulation clock + the deadline verdict
                    (enforce_deadlines: the runtime contract behind
                    Allocation.deadline_s — late clients are cut off at
                    the barrier, partial uploads billed but discarded);
  * runtime.py    — EdgeConfig + EdgeRuntime gluing the above under
                    ``FederatedRun``, with the struct-of-arrays fleet fast
                    path (the exact numpy backend, or ``fleet_backend=
                    "jit"``: the fused float64 torch backend on the
                    run's device);
  * fleet/        — struct-of-arrays mega-scale engine: the same sync
                    round semantics over 10⁵–10⁶ clients (FleetState,
                    FleetEngine) on either backend;
  * scenario/     — availability churn + fault injection: seeded
                    diurnal/markov/trace availability processes,
                    blackout/SNR-burst/straggler/battery-gate/
                    data-exclusion injectors, and the spec-string grammar
                    behind EdgeConfig.scenario.

Bandwidth allocation never changes WHAT is transmitted (the ledger is
ground truth); per-client codecs change bytes only through their
``wire_bytes``, and the ledger still equals the plan per client.
"""
from repro_torch.edge.allocation import (AdaptiveCodecPolicy, Allocation,
                                         AllocationPolicy, BandwidthOptPolicy,
                                         CapacityProportionalPolicy,
                                         ClientEstimate, DeadlinePolicy,
                                         EnergyOptPolicy,
                                         EnergyThresholdPolicy, FleetDecision,
                                         FleetRoundState, RoundDecision,
                                         RoundState, UniformPolicy,
                                         make_policy)
from repro_torch.edge.async_agg import AsyncAggregator, staleness_weights
from repro_torch.edge.channel import Channel, ChannelConfig
from repro_torch.edge.device import (DeviceConfig, DeviceFleet,
                                     flops_grad_fim, flops_local_sgd)
from repro_torch.edge.events import (DeadlineVerdict, Event, EventClock,
                                     enforce_deadlines, reallocated_finish)
from repro_torch.edge.fleet import FleetEngine, FleetState
from repro_torch.edge.runtime import EdgeConfig, EdgeRuntime
from repro_torch.edge.scenario import (RoundEffects, Scenario, fault_names,
                                       make_scenario, process_names,
                                       register_fault, register_process)
from repro_torch.edge.scheduler import (CapacityProportionalScheduler,
                                        DeadlineScheduler,
                                        EnergyThresholdScheduler,
                                        UniformScheduler, make_scheduler)

__all__ = [
    "Allocation", "AllocationPolicy", "RoundState", "RoundDecision",
    "UniformPolicy", "DeadlinePolicy", "EnergyOptPolicy",
    "EnergyThresholdPolicy",
    "CapacityProportionalPolicy", "BandwidthOptPolicy", "AdaptiveCodecPolicy",
    "make_policy",
    "AsyncAggregator", "staleness_weights",
    "Channel", "ChannelConfig",
    "DeviceConfig", "DeviceFleet", "flops_grad_fim", "flops_local_sgd",
    "DeadlineVerdict", "Event", "EventClock", "enforce_deadlines",
    "reallocated_finish",
    "EdgeConfig", "EdgeRuntime",
    "RoundEffects", "Scenario", "make_scenario", "register_process",
    "register_fault", "process_names", "fault_names",
    "FleetRoundState", "FleetDecision", "ClientEstimate",
    "FleetEngine", "FleetState",
    # legacy aliases (see edge/scheduler.py)
    "UniformScheduler", "DeadlineScheduler", "EnergyThresholdScheduler",
    "CapacityProportionalScheduler", "make_scheduler",
]
