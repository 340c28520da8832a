"""FedProx [Li et al., MLSys 2020] (port of
``repro.fed.strategies.fedprox``).

Clients minimize F_k(w) + (μ/2)‖w − w_t‖²; everything else (delta
payloads, FedAvg byte accounting, the sparsifying codecs with error
feedback) comes from the FedAvg scaffolding.
"""
from __future__ import annotations

from repro_torch.fed import client as fed_client
from repro_torch.fed.strategies.base import register
from repro_torch.fed.strategies.fedavg import LocalSolveStrategy


@register("fedprox")
class FedProxStrategy(LocalSolveStrategy):
    def _build_solver(self) -> None:
        self._prox = fed_client.make_fedprox_fn(self._loss)

    def _local_solve(self, params, batches):
        return self._prox(params, batches,
                          lr=float(self.fcfg.learning_rate),
                          mu=float(self.fcfg.prox_mu))
