"""FedOVA (paper Sec. IV-B, Algorithm 2) as a FedStrategy, optionally
with the FIM-L-BFGS step training each component ("fedova_lbfgs"); port
of ``repro.fed.strategies.fedova``.

Each client trains only the binary components of the classes in its data
(visited in ascending class order, which fixes the host sampling stream)
and uploads (component stack, class-presence mask).  The grouped mean
(Eq. 11) is per-class, so the uploads are tree-aggregatable, but not
summable: the mean needs each client's mask, so the sparsifying codecs
are refused.

The components, and under ``fedova_lbfgs`` the optimizer state, are
stacked on a leading class axis as the reference stacks them, so
``state_dict()`` (``params`` = the component stack, ``opt_state``)
carries the reference's state across unchanged.  ``fedova_lbfgs``
updates a component's slice of the stacked optimizer state in place.
"""
from __future__ import annotations

import torch

from repro_torch.core import fedova, fim_lbfgs
from repro_torch.edge import device as edge_device
from repro_torch.fed import client as fed_client
from repro_torch.fed import comm
from repro_torch.fed.strategies.base import (FedStrategy, PhasePlan,
                                             RoundPlan, register)
from repro_torch.models import cnn
from repro_torch.utils.pytree import tree_leaves, tree_map


class FedOvaStrategy(FedStrategy):
    server_opt = "sgd"  # "sgd" (Alg. 2 as written) | "fim_lbfgs"

    def _build(self, generator) -> None:
        bcfg = self.mcfg.binary()
        self.bcfg = bcfg
        comps = [cnn.init(bcfg, generator) for _ in range(self.n_classes)]
        self.model = fedova.OvaModel(
            components=tree_map(lambda *t: torch.stack(t).to(self.device),
                                *comps),
            n_classes=self.n_classes)

        def _binary_loss(p, b):
            return cnn.binary_loss(p, bcfg, b)

        self._local_sgd = fed_client.make_local_sgd_fn(_binary_loss)
        if self.server_opt == "fim_lbfgs":
            kernels = self.fcfg.kernels
            self.ocfg = fim_lbfgs.FimLbfgsConfig(
                learning_rate=self.fcfg.second_order_lr, m=self.fcfg.lbfgs_m,
                damping=self.fcfg.fim_damping, fim_ema=self.fcfg.fim_ema,
                max_step_norm=self.fcfg.max_step_norm, kernels=kernels)
            one = fim_lbfgs.init(fedova.component(self.model, 0), self.ocfg)
            self.opt_state = tree_map(
                lambda s: torch.stack([s] * self.n_classes), one)
            self._grad_fim = fed_client.make_grad_fim_fn(
                _binary_loss, cnn.per_example_loss_fn(bcfg, binary=True),
                self.fcfg.fim_mode, kernels=kernels)

    @property
    def params(self):
        """The server state broadcast each round: the component stack."""
        return self.model.components

    @params.setter
    def params(self, components) -> None:
        self.model = fedova.OvaModel(components, self.n_classes)

    def n_params(self) -> int:
        """One binary component (the broadcast/upload unit)."""
        if self._n_params_cache is None:
            self._n_params_cache = comm.tree_n_floats(
                fedova.component(self.model, 0))
        return self._n_params_cache

    def _classes_per_client(self) -> int:
        return min(self.fcfg.noniid_l or self.n_classes, self.n_classes)

    def _make_plan(self) -> RoundPlan:
        d = self.n_params()
        n = self.n_classes
        e = self.fcfg.local_epochs
        return RoundPlan(
            # the server broadcasts the whole stack; each client uploads
            # the components it trained (exact under non-IID-l
            # partitions, an upper bound for small IID shards)
            phases=(PhasePlan("ova_components", down_floats=float(d * n),
                              up_floats=float(d * self._classes_per_client()),
                              codec=self.codec, aggregatable=True),),
            flops=lambda nk: edge_device.flops_local_sgd(
                self.n_params(), nk, e) * self._classes_per_client(),
            summable=False,  # the grouped mean needs per-client masks
            scalars_per_client=n,  # class-presence masks
        )

    def client_step(self, data, rng, context=None):
        xs, ys = data
        mask = torch.zeros(self.n_classes, dtype=torch.float32)
        client_comp = tree_map(torch.clone, self.model.components)
        losses = []
        # the class set decides the loop, and so the host stream: the one
        # host sync of a FedOVA client
        for c in torch.unique(ys).tolist():
            mask[c] = 1.0
            batches = fed_client.stack_batches(
                xs, (ys == c).long(), self.fcfg.batch_size,
                self.fcfg.local_epochs, rng)
            comp_new, loss = self._train_component(
                c, fedova.component(self.model, c), batches)
            for full, new in zip(tree_leaves(client_comp),
                                 tree_leaves(comp_new), strict=True):
                full[c] = new
            losses.append(loss)
        loss = torch.mean(torch.stack(losses).double())
        return (client_comp, mask.to(self.device)), loss

    def _train_component(self, c: int, comp_c, batches):
        if self.server_opt == "fim_lbfgs":
            big = {"x": batches["x"].reshape((-1,) + batches["x"].shape[2:]),
                   "y": batches["y"].reshape(-1)}
            g, f, loss = self._grad_fim(comp_c, big)
            ost = tree_map(lambda s: s[c], self.opt_state)
            comp_new, ost, _ = fim_lbfgs.update(ost, comp_c, g, f, self.ocfg)
            for full, new in zip(tree_leaves(self.opt_state),
                                 tree_leaves(ost), strict=True):
                full[c] = new
            return comp_new, loss
        return self._local_sgd(comp_c, batches,
                               lr=float(self.fcfg.learning_rate))

    def compress_payload(self, payload, generator, residual=None, codec=None):
        # only the component stack goes through the codec: the
        # class-presence mask is metered as scalars and stays exact
        comp, mask = payload
        comp, residual = (codec or self.codec).roundtrip(comp, generator,
                                                         residual)
        return (comp, mask), residual

    def aggregate(self, payloads, weights):
        stacked = tree_map(lambda *t: torch.stack(t), *[p[0] for p in payloads])
        return stacked, torch.stack([p[1] for p in payloads])

    def server_step(self, aggregate) -> None:
        stacked, masks = aggregate
        self.model = fedova.aggregate(self.model, stacked, masks)

    def evaluate(self, x, y) -> float:
        def apply(p, xb):
            return cnn.apply(p, self.bcfg, xb)

        return float(fedova.accuracy(apply, self.model, x, y))


register("fedova", FedOvaStrategy)


@register("fedova_lbfgs")
class FedOvaLbfgsStrategy(FedOvaStrategy):
    server_opt = "fim_lbfgs"
