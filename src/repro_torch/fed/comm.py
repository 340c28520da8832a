"""Communication accounting for the federated runtime (port of
``repro.fed.comm``).

The ledger counts the bytes each scheme exchanges, under the two
topologies Theorem 3 distinguishes: star (every selected client uploads to
the server) and tree (in-network aggregation, so any node forwards at most
ceil(log2 k) payloads).  Codecs (``repro_torch.fed.codecs``) declare wire
sizes; the ledger meters what they declare via
``upload(..., wire_bytes=...)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.utils.pytree import tree_leaves

BYTES_F32 = 4
BYTES_INT8 = 1


def tree_n_floats(tree) -> int:
    return sum(int(leaf.numel()) for leaf in tree_leaves(tree))


@dataclass
class CommLedger:
    """Per-round communication in bytes, split by direction/topology."""
    down_bytes: float = 0.0          # server -> clients (broadcasts)
    up_star_bytes: float = 0.0       # server link, star topology
    up_tree_bytes: float = 0.0       # max per-node traffic, tree aggregation
    scalar_bytes: float = 0.0        # Gram-matrix / m² scalar exchanges
    rounds: int = 0

    def broadcast(self, n_floats: int, n_clients: int) -> float:
        added = n_floats * BYTES_F32 * n_clients
        self.down_bytes += added
        return added

    def upload(self, n_floats: float, n_clients: int,
               bytes_per_el: int = BYTES_F32, aggregatable: bool = True,
               wire_bytes: float | None = None) -> tuple[float, float]:
        """A per-client upload of ``n_floats`` elements, billed at the
        codec's ``wire_bytes`` when given.  Aggregatable payloads sum
        in-network (tree bytes = payload x depth); others reach the root
        one by one.  Returns the ``(star, tree)`` bytes added."""
        if n_clients <= 0:
            return 0.0, 0.0
        payload = (float(wire_bytes) if wire_bytes is not None
                   else n_floats * bytes_per_el)
        d_star = payload * n_clients
        if aggregatable:
            depth = max(1, math.ceil(math.log2(max(n_clients, 2))))
            d_tree = payload * depth
        else:
            d_tree = payload * n_clients
        self.up_star_bytes += d_star
        self.up_tree_bytes += d_tree
        return d_star, d_tree

    def upload_per_client(self, wire_bytes,
                          aggregatable: bool = True) -> tuple[float, float]:
        """Per-client uploads whose wire sizes differ; star bills the sum,
        an aggregatable tree depth x max.  Returns the ``(star, tree)``
        bytes added."""
        sizes = np.asarray(wire_bytes, dtype=float)
        k = sizes.size
        if k == 0:
            return 0.0, 0.0
        d_star = float(sizes.sum())
        if aggregatable:
            depth = max(1, math.ceil(math.log2(max(k, 2))))
            d_tree = depth * float(sizes.max())
        else:
            d_tree = d_star
        self.up_star_bytes += d_star
        self.up_tree_bytes += d_tree
        return d_star, d_tree

    def scalars(self, n: int) -> float:
        added = n * BYTES_F32
        self.scalar_bytes += added
        return added

    def end_round(self) -> None:
        self.rounds += 1

    def summary(self) -> dict:
        r = max(self.rounds, 1)
        return {
            "rounds": self.rounds,
            "down_MB_per_round": self.down_bytes / r / 1e6,
            "up_star_MB_per_round": self.up_star_bytes / r / 1e6,
            "up_tree_MB_per_round": self.up_tree_bytes / r / 1e6,
            "scalar_KB_per_round": self.scalar_bytes / r / 1e3,
        }
