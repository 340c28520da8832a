"""FedDANE [Li et al., Asilomar 2019] as a two-phase FedStrategy (port of
``repro.fed.strategies.feddane``).

Phase 1 (``round_context``): broadcast w_t, every client uploads its full
local gradient; the aggregate ∇f(w_t) is summable (tree-aggregatable).
Phase 2: broadcast the global gradient, clients run inner SGD on the
DANE-corrected objective and upload their local models — k distinct
iterates, not aggregatable, so the plan is not ``summable``.
"""
from __future__ import annotations

import torch

from repro_torch.core import aggregation
from repro_torch.edge import device as edge_device
from repro_torch.fed import client as fed_client
from repro_torch.fed.strategies.base import (FedStrategy, PhasePlan,
                                             RoundPlan, register)
from repro_torch.models import cnn
from repro_torch.utils.pytree import tree_map


@register("feddane")
class FedDaneStrategy(FedStrategy):
    def _build(self, generator) -> None:
        self.params = tree_map(lambda p: p.to(self.device),
                               cnn.init(self.mcfg, generator))

        def _loss(p, b):
            return cnn.softmax_loss(p, self.mcfg, b)

        self._grad_fim = fed_client.make_grad_fim_fn(
            _loss, cnn.per_example_loss_fn(self.mcfg), self.fcfg.fim_mode,
            kernels=self.fcfg.kernels)
        self._dane = fed_client.make_feddane_fn(_loss)
        # the context phase's gradient uploads go through the codec too, on
        # a stream of their own and without error feedback (the
        # reference's PRNGKey(seed + 29))
        self.context_generator = torch.Generator(
            device=self.device).manual_seed(self.fcfg.seed + 29)

    def _eval(self, params, x, y):
        return cnn.accuracy(params, self.mcfg, x, y)

    def _make_plan(self) -> RoundPlan:
        d = self.n_params()
        e = self.fcfg.local_epochs
        return RoundPlan(
            phases=(
                PhasePlan("gradient", down_floats=d, up_floats=d,
                          codec=self.codec, aggregatable=True),
                PhasePlan("inner_solve", down_floats=d, up_floats=d,
                          codec=self.codec, aggregatable=False),
            ),
            flops=lambda n: (edge_device.flops_grad_fim(self.n_params(), n)
                             + edge_device.flops_local_sgd(self.n_params(), n, e)),
            summable=False,
        )

    def round_context(self, datas, rng):
        """Phase 1: full local gradients -> the cohort's global gradient;
        each client's context is (global_grad, its own ∇F_k(w_t))."""
        if not datas:
            return []
        local_grads, sent_grads, weights = [], [], []
        for xs, ys in datas:
            g, _, _ = self._grad_fim(self.params, {"x": xs, "y": ys})
            local_grads.append(g)  # the client keeps its exact gradient
            if not self.codec.identity:
                g, _ = self.codec.roundtrip(g, self.context_generator)
            sent_grads.append(g)   # the server only sees the wire version
            weights.append(len(xs))
        w = torch.tensor(weights, dtype=torch.float32, device=self.device)
        global_grad = aggregation.weighted_mean(
            tree_map(lambda *t: torch.stack(t), *sent_grads), w)
        return [(global_grad, g0) for g0 in local_grads]

    def client_step(self, data, rng, context=None):
        xs, ys = data
        global_grad, g0 = context
        batches = fed_client.stack_batches(
            xs, ys, self.fcfg.batch_size, self.fcfg.local_epochs, rng)
        return self._dane(self.params, batches, global_grad, g0,
                          lr=float(self.fcfg.learning_rate), mu=0.1)

    def server_step(self, aggregate) -> None:
        self.params = aggregate
