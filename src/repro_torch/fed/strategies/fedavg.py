"""FedAvg-family strategies: local solves, model-delta payloads (port of
``repro.fed.strategies.fedavg``).

Clients run E local epochs and upload their model *delta* w_k − w_t, so
w_t + Σ (n_k/n)(w_k − w_t) is FedAvg's weighted model mean and the plan
is ``summable`` (top-k/rand-k with error feedback apply).  The server
still learns k distinct iterates, so in Theorem 3's accounting the
uploads are NOT in-network tree-aggregatable (O(k·d) at the root).
"""
from __future__ import annotations

from repro_torch.edge import device as edge_device
from repro_torch.fed import client as fed_client
from repro_torch.fed.strategies.base import (FedStrategy, PhasePlan,
                                             RoundPlan, register)
from repro_torch.models import cnn
from repro_torch.utils.pytree import tree_map


class LocalSolveStrategy(FedStrategy):
    """Shared scaffolding: softmax model, delta payloads, FedAvg plan.
    Subclasses provide ``_build_solver`` and ``_local_solve``."""

    def _build(self, generator) -> None:
        self.params = tree_map(lambda p: p.to(self.device),
                               cnn.init(self.mcfg, generator))

        def _loss(p, b):
            return cnn.softmax_loss(p, self.mcfg, b)

        self._loss = _loss
        self._build_solver()

    def _build_solver(self) -> None:
        raise NotImplementedError

    def _local_solve(self, params, batches):
        raise NotImplementedError

    def _eval(self, params, x, y):
        return cnn.accuracy(params, self.mcfg, x, y)

    def _make_plan(self) -> RoundPlan:
        d = self.n_params()
        e = self.fcfg.local_epochs
        return RoundPlan(
            # k distinct local models reach the server: O(k·d), no
            # in-network aggregation gain (Thm 3)
            phases=(PhasePlan("local_model", down_floats=d, up_floats=d,
                              codec=self.codec, aggregatable=False),),
            flops=lambda n: edge_device.flops_local_sgd(self.n_params(), n, e),
            summable=True,  # delta payloads sum: sparsifiers apply
        )

    def client_step(self, data, rng, context=None):
        xs, ys = data
        batches = fed_client.stack_batches(
            xs, ys, self.fcfg.batch_size, self.fcfg.local_epochs, rng)
        p, loss = self._local_solve(self.params, batches)
        return tree_map(lambda a, b: a - b, p, self.params), loss

    def server_step(self, aggregate) -> None:
        self.params = tree_map(lambda p, dl: p + dl, self.params, aggregate)


@register("fedavg_sgd")
class FedAvgSgdStrategy(LocalSolveStrategy):
    """FedAvg with local SGD [McMahan et al.]."""

    def _build_solver(self) -> None:
        self._sgd = fed_client.make_local_sgd_fn(self._loss)

    def _local_solve(self, params, batches):
        return self._sgd(params, batches, lr=float(self.fcfg.learning_rate))


@register("fedavg_adam")
class FedAvgAdamStrategy(LocalSolveStrategy):
    """Table II's "FedAvg-based Adam": clients run local Adam, the server
    averages (Adam's lr is a tenth of the SGD lr)."""

    def _build_solver(self) -> None:
        self._adam = fed_client.make_local_adam_fn(self._loss)

    def _local_solve(self, params, batches):
        return self._adam(params, batches,
                          lr=float(self.fcfg.learning_rate) * 0.1)
