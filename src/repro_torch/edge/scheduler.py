"""Back-compat shim: the client-selection ``Scheduler`` surface became
the per-client resource-allocation API in :mod:`repro_torch.edge.allocation`.

The old ``Scheduler.select(k, est, rng) -> (ids, dropped)`` could only
say *who* transmits; the paper's formulation allocates *how much* of the
wireless budget each client gets.  ``AllocationPolicy.decide(RoundState)
-> RoundDecision`` returns, per selected client, an ``Allocation``
(bandwidth from a shared round budget, optional per-client codec,
deadline) plus the excluded ids with reasons.  The four legacy policies
live on as uniform-split allocation policies under their
``make_scheduler``-era names (``uniform`` / ``deadline`` /
``energy_threshold`` / ``capacity_proportional``), constructible through
the same ``EdgeConfig`` knobs.
"""
from repro_torch.edge.allocation import (  # noqa: F401
    Allocation, AllocationPolicy, CapacityProportionalPolicy, ClientEstimate,
    DeadlinePolicy, EnergyThresholdPolicy, RoundDecision, RoundState,
    UniformPolicy, make_policy,
)

# legacy aliases (the Scheduler-era names); new code should import from edge.allocation
Scheduler = AllocationPolicy
UniformScheduler = UniformPolicy
DeadlineScheduler = DeadlinePolicy
EnergyThresholdScheduler = EnergyThresholdPolicy
CapacityProportionalScheduler = CapacityProportionalPolicy
make_scheduler = make_policy
