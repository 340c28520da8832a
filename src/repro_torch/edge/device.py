"""Heterogeneous edge-device compute profiles.

A ``DeviceFleet`` draws per-client effective throughput (FLOPs/s,
lognormal across the fleet — the straggler distribution) and an energy
cost per FLOP; each client also carries a battery budget that local work
and uplink transmission drain (the depletion model behind the
energy-threshold exclusion policy of arXiv:2104.05509).

FLOP estimators cost out the client work the federated loop actually
runs: a fused gradient+FIM pass (Algorithm 1's ClientUpdate) or E epochs
of local SGD (FedAvg/FedDANE/FedOVA).  The usual dense-network
accounting applies: forward ≈ 2·P FLOPs per example, backward ≈ 2×
forward, and the per-example Fisher diagonal an extra squared-gradient
pass.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DeviceConfig:
    flops_per_s_mean: float = 5e9    # fleet-mean effective throughput
    flops_per_s_sigma: float = 0.5   # lognormal sigma (0 = homogeneous)
    joules_per_flop: float = 2e-10   # compute energy (~0.2 nJ/FLOP, mobile SoC)
    battery_j: float = float("inf")  # per-client energy budget
    idle_power_w: float = 0.0        # drain while waiting at the sync-round
                                     # barrier for stragglers (0 = ignore)


def flops_grad_fim(n_params: int, n_examples: int) -> float:
    """One full-batch gradient + Fisher-diagonal pass (Alg. 1 line 3-4):
    forward 2P + backward 4P + per-example squared-grad pass 2P."""
    return 8.0 * float(n_params) * float(n_examples)


def flops_local_sgd(n_params: int, n_examples: int, epochs: int) -> float:
    """E epochs of minibatch SGD: 6P per example per epoch."""
    return 6.0 * float(n_params) * float(n_examples) * float(max(epochs, 1))


def draw_flops_per_s(cfg: DeviceConfig, num_clients: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Per-client effective throughput (lognormal straggler spread) —
    the array-state constructor shared by :class:`DeviceFleet` and the
    fleet engine's ``FleetState`` (``repro_torch.edge.fleet``) (identical
    rng call, so both paths draw identical populations from the same
    seed)."""
    mu = np.log(cfg.flops_per_s_mean)
    if cfg.flops_per_s_sigma > 0:
        return rng.lognormal(mu, cfg.flops_per_s_sigma, num_clients)
    return np.full(num_clients, cfg.flops_per_s_mean)


class DeviceFleet:
    """Per-client compute rates, energy rates, and mutable batteries."""

    def __init__(self, cfg: DeviceConfig, num_clients: int, seed: int = 0):
        self.cfg = cfg
        self.num_clients = num_clients
        rng = np.random.default_rng(seed)
        self.flops_per_s = draw_flops_per_s(cfg, num_clients, rng)
        self.battery_j = np.full(num_clients, float(cfg.battery_j))

    # ------------------------------------------------------------------
    def compute_time_s(self, flops: float, clients) -> np.ndarray:
        c = np.asarray(clients, dtype=int)
        return float(flops) / np.maximum(self.flops_per_s[c], 1.0)

    def compute_energy_j(self, flops: float, clients) -> np.ndarray:
        c = np.asarray(clients, dtype=int)
        return np.full(c.shape, float(flops) * self.cfg.joules_per_flop)

    def spend(self, clients, joules) -> None:
        """Drain batteries (elementwise); floors at 0."""
        c = np.asarray(clients, dtype=int)
        self.battery_j[c] = np.maximum(
            self.battery_j[c] - np.asarray(joules, dtype=float), 0.0)

    def alive(self, clients=None) -> np.ndarray:
        """Clients with battery remaining (bool mask or filtered ids)."""
        if clients is None:
            return self.battery_j > 0.0
        c = np.asarray(clients, dtype=int)
        return c[self.battery_j[c] > 0.0]
