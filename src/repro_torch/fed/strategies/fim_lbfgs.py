"""Algorithm 1 (FIM-driven distributed L-BFGS) as a FedStrategy (port of
``repro.fed.strategies.fim_lbfgs``).

Clients upload (∇F_k, Γ_k) — summable, so the plan is fully
tree-aggregatable; the server runs the FIM-L-BFGS step on the aggregated
pair, exchanging only the (2m+1)² Gram scalars on top.
"""
from __future__ import annotations

import torch

from repro_torch.core import aggregation, fim_lbfgs
from repro_torch.edge import device as edge_device
from repro_torch.fed import client as fed_client
from repro_torch.fed.strategies.base import (FedStrategy, PhasePlan,
                                             RoundPlan, register)
from repro_torch.models import cnn
from repro_torch.utils.pytree import tree_map


@register("fim_lbfgs")
class FimLbfgsStrategy(FedStrategy):
    def _build(self, generator) -> None:
        self.params = tree_map(lambda p: p.to(self.device),
                               cnn.init(self.mcfg, generator))

        def _loss(p, b):
            return cnn.softmax_loss(p, self.mcfg, b)

        kernels = self.fcfg.kernels
        self._grad_fim = fed_client.make_grad_fim_fn(
            _loss, cnn.per_example_loss_fn(self.mcfg), self.fcfg.fim_mode,
            kernels=kernels)
        self._cohort_grad_fim = fed_client.make_cohort_grad_fim_fn(
            _loss, cnn.per_example_loss_fn(self.mcfg), self.fcfg.fim_mode,
            kernels=kernels)
        self.ocfg = fim_lbfgs.FimLbfgsConfig(
            learning_rate=self.fcfg.second_order_lr, m=self.fcfg.lbfgs_m,
            damping=self.fcfg.fim_damping, fim_ema=self.fcfg.fim_ema,
            max_step_norm=self.fcfg.max_step_norm, kernels=kernels)
        self.opt_state = fim_lbfgs.init(self.params, self.ocfg)

    def _eval(self, params, x, y):
        return cnn.accuracy(params, self.mcfg, x, y)

    def _make_plan(self) -> RoundPlan:
        d = self.n_params()
        return RoundPlan(
            phases=(PhasePlan("grad_fim", down_floats=d, up_floats=2.0 * d,
                              codec=self.codec, aggregatable=True),),
            flops=lambda n: edge_device.flops_grad_fim(self.n_params(), n),
            summable=True,
            round_scalars=(2 * self.fcfg.lbfgs_m + 1) ** 2,  # Gram exchange
        )

    def client_step(self, data, rng, context=None):
        xs, ys = data
        # full local gradient/Fisher (the ERM F_k over D_k)
        g, f, loss = self._grad_fim(self.params, {"x": xs, "y": ys})
        return (g, f), loss

    @staticmethod
    def _received(payload):
        # the Fisher diagonal must stay nonnegative through the roundtrip
        g, f = payload
        return g, tree_map(torch.abs, f)

    def compress_payload(self, payload, generator, residual=None, codec=None):
        out, residual = (codec or self.codec).roundtrip(payload, generator,
                                                        residual)
        return self._received(out), residual

    def compress_slots(self, payloads, generator):
        """A cohort's payloads through the run codec with no error
        feedback (the cohort path, fed/simulator.py): what
        ``compress_payload`` gives slot by slot, in one codec call (int8:
        every slot's leaves in one leaf table)."""
        return [self._received(out)
                for out in self.codec.roundtrip_slots(payloads, generator)]

    def aggregate(self, payloads, weights):
        w = weights.float()
        grad = aggregation.weighted_mean(
            tree_map(lambda *t: torch.stack(t), *[p[0] for p in payloads]), w)
        fimd = aggregation.weighted_mean(
            tree_map(lambda *t: torch.stack(t), *[p[1] for p in payloads]), w)
        return grad, fimd

    def server_step(self, aggregate) -> None:
        grad, fimd = aggregate
        self.params, self.opt_state, _ = fim_lbfgs.update(
            self.opt_state, self.params, grad, fimd, self.ocfg)

    # -- vmapped cohort path (fed/simulator.py) --------------------------
    @property
    def cohort_client_fn(self):
        """(params, stacked cohort batch) -> (grads, Γs, losses), each with
        a leading cohort dim (``fed.client.make_cohort_grad_fim_fn``)."""
        return self._cohort_grad_fim

    def cohort_server_update(self, opt_state, params, grad, fim_diag):
        """Pure server update for the cohort round_step."""
        return fim_lbfgs.update(opt_state, params, grad, fim_diag, self.ocfg)
