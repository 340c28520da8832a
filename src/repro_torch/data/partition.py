"""Non-IID data partitioner (paper Sec. VI-A Remark).

A numpy copy of ``repro.data.partition``: "non-IID-l" gives each client
exactly l distinct labels.  For the same seed the partition is
bit-identical to the reference's.
"""
from __future__ import annotations

import numpy as np


def noniid_partition(labels: np.ndarray, num_clients: int, ell: int, n_classes: int,
                     seed: int = 0) -> list[np.ndarray]:
    """Returns a list of index arrays, one per client."""
    rng = np.random.default_rng(seed)
    if ell <= 0 or ell >= n_classes:
        idx = rng.permutation(len(labels))
        return [np.sort(part) for part in np.array_split(idx, num_clients)]

    # partitions per label group: (l*K)/n
    per_label = max(1, (ell * num_clients) // n_classes)
    shards: list[tuple[int, np.ndarray]] = []
    for c in range(n_classes):
        idx_c = np.where(labels == c)[0]
        rng.shuffle(idx_c)
        for part in np.array_split(idx_c, per_label):
            if len(part):
                shards.append((c, part))

    # deal shards so every client receives ell shards with distinct labels
    rng.shuffle(shards)
    clients: list[list[np.ndarray]] = [[] for _ in range(num_clients)]
    client_labels: list[set] = [set() for _ in range(num_clients)]
    order = list(range(num_clients))
    for c, part in shards:
        rng.shuffle(order)
        placed = False
        for k in order:  # prefer clients lacking this label and under quota
            if len(clients[k]) < ell and c not in client_labels[k]:
                clients[k].append(part)
                client_labels[k].add(c)
                placed = True
                break
        if not placed:  # fallback: least-loaded client
            k = min(order, key=lambda q: len(clients[q]))
            clients[k].append(part)
            client_labels[k].add(c)
    return [
        np.sort(np.concatenate(parts)) if parts else np.array([], np.int64)
        for parts in clients
    ]


def labels_per_client(labels: np.ndarray, partition: list[np.ndarray]) -> list[set]:
    """The set of labels each client's indices hold."""
    return [set(np.unique(labels[idx]).tolist()) for idx in partition]
