"""Non-IID federated data partitioning (paper §IV-A).

Dirichlet label-skew partition Dir(α), following FedPETuning / FedABC: for
each class, the class's samples are split across the m clients with
proportions drawn from Dir(α·1_m).  Smaller α ⇒ more heterogeneous clients
(α = 0.5 is the paper's default; Fig. 7 visualizes α ∈ {0.1,0.5,1,10}).

A copy of ``repro.data.partition`` (numpy only, the same splits).
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(seed: int, labels: np.ndarray, n_clients: int,
                        alpha: float, min_per_client: int = 2) -> list[np.ndarray]:
    """Returns a list of m index arrays into `labels`."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    while True:
        shards: list[list[int]] = [[] for _ in range(n_clients)]
        for k in range(n_classes):
            idx = np.nonzero(labels == k)[0]
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * idx.size).astype(int)[:-1]
            for ci, part in enumerate(np.split(idx, cuts)):
                shards[ci].extend(part.tolist())
        if min(len(s) for s in shards) >= min_per_client:
            break
    return [np.asarray(sorted(s), np.int64) for s in shards]


def label_histogram(labels: np.ndarray, shards: list[np.ndarray],
                    n_classes: int | None = None) -> np.ndarray:
    """(m, K) per-client label counts — paper Fig. 7's visualization."""
    k = n_classes or int(labels.max()) + 1
    return np.stack([np.bincount(labels[s], minlength=k) for s in shards])
