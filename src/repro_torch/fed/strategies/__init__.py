"""Pluggable federated strategies (port of ``repro.fed.strategies``).
Importing this package registers all seven: ``fim_lbfgs``,
``fedavg_sgd``, ``fedavg_adam``, ``fedprox``, ``feddane``, ``fedova`` and
``fedova_lbfgs``."""
from repro_torch.fed.strategies.base import (  # noqa: F401
    FedStrategy,
    PhasePlan,
    RoundPlan,
    get,
    names,
    register,
)
from repro_torch.fed.strategies import (  # noqa: F401  (register)
    fedavg,
    feddane,
    fedova,
    fedprox,
    fim_lbfgs,
)
