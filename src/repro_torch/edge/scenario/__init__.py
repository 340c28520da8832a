"""repro_torch.edge.scenario — availability churn, fault injection, and the
spec-string registry (the fourth registry subsystem; see base.py for
the grammar and the two effect phases)."""
from repro_torch.edge.scenario.availability import (AlwaysOn, Diurnal,
                                                    Markov, Trace)
from repro_torch.edge.scenario.base import (AvailabilityProcess,
                                            FaultInjector, RoundEffects,
                                            Scenario, fault_names,
                                            make_scenario, parse_spec,
                                            process_names, register_fault,
                                            register_process)
from repro_torch.edge.scenario.faults import (BatteryGate, Blackout,
                                              DataExclusion, SnrBurst,
                                              Straggler)

__all__ = [
    "AvailabilityProcess", "FaultInjector", "RoundEffects", "Scenario",
    "register_process", "register_fault", "process_names", "fault_names",
    "parse_spec", "make_scenario",
    "AlwaysOn", "Diurnal", "Markov", "Trace",
    "Blackout", "SnrBurst", "Straggler", "BatteryGate", "DataExclusion",
]
