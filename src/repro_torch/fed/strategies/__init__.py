"""Pluggable federated strategies (port of ``repro.fed.strategies``).
Importing this package registers the ported strategies: ``fim_lbfgs``."""
from repro_torch.fed.strategies.base import (  # noqa: F401
    FedStrategy,
    PhasePlan,
    RoundPlan,
    get,
    names,
    register,
)
from repro_torch.fed.strategies import fim_lbfgs  # noqa: F401  (registers)
