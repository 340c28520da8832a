"""Server-side federated orchestration (port of ``repro.fed.server``).

``FederatedRun`` is a generic round driver over the strategy registry: it
samples the cohort, meters CommLedger from the strategy's plan (the
ledger's actuals equal the plan's prediction by construction), round-trips
uploads through the run codec (keeping each client's error-feedback
residual for the sparsifying codecs, keyed by client id), aggregates and
applies the server step.

Not ported yet: the edge runtime (``FedConfig.edge`` raises), the tracer
and checkpoint/resume.

The run lives on one device.  The training set is moved there once; the
client sampling draws the reference's numpy stream call for call, so a
seed selects the same cohorts as ``repro.fed.server.FederatedRun``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import CNNConfig
from repro_torch.data.partition import noniid_partition
from repro_torch.data.synthetic import Dataset
from repro_torch.fed import comm, strategies
from repro_torch.utils.device import resolve_device


def render_round(rec: dict) -> str:
    """The console form of one per-round record (the reference's
    ``obs.trace.render_round``)."""
    return (f"round {rec.get('round', 0):4d} "
            f"loss {rec.get('loss', float('nan')):.4f} "
            f"acc {rec.get('accuracy', float('nan')):.4f}")


class FederatedRun:
    """Generic federated round driver: ``algorithm`` resolves through the
    strategy registry; everything per-algorithm lives in the strategy."""

    def __init__(self, model_cfg: CNNConfig, fed_cfg: FedConfig,
                 train: Dataset, test: Dataset, algorithm: str,
                 device="cuda"):
        self.device = resolve_device(device)
        self.mcfg = model_cfg
        self.fcfg = fed_cfg
        self.train, self.test = train, test
        self.algorithm = algorithm
        self.rng = np.random.default_rng(fed_cfg.seed)
        self.ledger = comm.CommLedger()
        # per-client error-feedback residuals of the sparsifying codecs
        self._ef_residual: dict[int, object] = {}
        # the codec's random stream (the reference's PRNGKey(seed + 17)
        # chain); a CUDA generator for CUDA payloads
        self.codec_generator = torch.Generator(
            device=self.device).manual_seed(fed_cfg.seed + 17)
        self.partition = noniid_partition(
            train.y, fed_cfg.num_clients, fed_cfg.noniid_l, train.n_classes,
            seed=fed_cfg.seed,
        )
        self.strategy = strategies.get(algorithm)(
            model_cfg, fed_cfg, train.n_classes, device=self.device)
        self.plan = self.strategy.round_plan()
        self.codec = self.strategy.codec
        self._eligible: Optional[list[int]] = None
        self._train_x = torch.from_numpy(train.x).to(self.device)
        self._train_y = torch.from_numpy(train.y).to(self.device)
        self._client_idx: dict[int, torch.Tensor] = {}

    @property
    def params(self):
        return getattr(self.strategy, "params", None)

    def sample_clients(self) -> list[int]:
        k = max(1, int(self.fcfg.participation * self.fcfg.num_clients))
        if self._eligible is None:
            self._eligible = [i for i in range(self.fcfg.num_clients)
                              if len(self.partition[i]) > 0]
        eligible = self._eligible
        return list(self.rng.choice(eligible, size=min(k, len(eligible)),
                                    replace=False))

    def _meter_round(self, selected: list[int]) -> None:
        """CommLedger metering from the plan: every selected client gets
        the broadcast and uploads at its phase codec's wire size; the
        Gram scalars are billed once per round.  An empty cohort still
        counts as a round but bills nothing."""
        n_selected = len(selected)
        if n_selected == 0:
            self.ledger.end_round()
            return
        for ph in self.plan.phases:
            if ph.down_floats:
                self.ledger.broadcast(ph.down_floats, n_selected)
            if ph.up_floats:
                self.ledger.upload(ph.up_floats, n_selected,
                                   aggregatable=ph.aggregatable,
                                   wire_bytes=ph.wire_up_bytes())
        n_scalars = (self.plan.round_scalars
                     + self.plan.scalars_per_client * n_selected)
        if n_scalars:
            self.ledger.scalars(n_scalars)
        self.ledger.end_round()

    def _client_data(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        idx = self._client_idx.get(k)
        if idx is None:
            idx = torch.from_numpy(self.partition[k]).to(self.device)
            self._client_idx[k] = idx
        return self._train_x[idx], self._train_y[idx]

    def round(self) -> dict:
        """One round: meter from the plan, collect client payloads
        (round-tripped through the run codec with per-client error
        feedback), aggregate, server step."""
        selected = self.sample_clients()
        self._meter_round(selected)
        datas = [self._client_data(i) for i in selected]
        context = self.strategy.round_context(datas, self.rng)
        payloads, weights, losses = [], [], []
        for j, data in enumerate(datas):
            payload, loss = self.strategy.client_step(
                data, self.rng, None if context is None else context[j])
            if not self.codec.identity:
                cid = int(selected[j])
                payload, res = self.strategy.compress_payload(
                    payload, self.codec_generator,
                    self._ef_residual.get(cid))
                if res is not None:
                    self._ef_residual[cid] = res
            payloads.append(payload)
            weights.append(len(data[0]))
            losses.append(loss)
        info = {"cohort": len(selected)}
        if losses:
            # the round's one host sync: the per-client losses
            host = torch.stack(losses).double().cpu().numpy()
            info["loss"] = float(np.mean(host))
        if payloads:
            agg = self.strategy.aggregate(
                payloads, torch.tensor(weights, dtype=torch.float32,
                                       device=self.device))
            self.strategy.server_step(agg)
        return info

    def evaluate(self, max_examples: int = 2000) -> float:
        x = torch.from_numpy(self.test.x[:max_examples]).to(self.device)
        y = torch.from_numpy(self.test.y[:max_examples]).to(self.device)
        return self.strategy.evaluate(x, y)

    def run(self, rounds: Optional[int] = None, eval_every: int = 5,
            target_accuracy: Optional[float] = None, verbose: bool = False):
        """Drive ``rounds`` federated rounds, evaluating every
        ``eval_every``; ``verbose`` prints the reference's per-round
        line on evaluation rounds."""
        rounds = rounds or self.fcfg.rounds
        history = []
        for t in range(rounds):
            info = self.round()
            info["round"] = t + 1
            is_eval = (t + 1) % eval_every == 0 or t == rounds - 1
            if is_eval:
                info["accuracy"] = self.evaluate()
            if verbose and is_eval:
                print(render_round(info))
            history.append(info)
            if (is_eval and target_accuracy
                    and info["accuracy"] >= target_accuracy):
                return history
        return history
