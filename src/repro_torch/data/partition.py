"""Dirichlet non-IID partitioning (paper §3.1.2): the port's own copy of
``repro/data/partition.py`` (numpy only, bit-identical splits).

For each class k, sample p_k ~ Dir(alpha) over clients and allocate a
p_k^i fraction of class-k examples to client i. Small alpha => highly
skewed (some clients see few / no examples of a class).
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2,
                        max_tries: int = 100):
    """Rejection-sample draws until every client holds >= ``min_size``
    examples. Fine at paper scale (m <= 20 succeeds within a try or
    two), but the all-clients-fed event becomes infeasibly improbable
    at m=1000 with small alpha — the old unbounded loop simply never
    terminated there. After ``max_tries`` rejections the LAST draw is
    deterministically repaired instead: each starving client takes
    examples from the back of the currently-largest client's list until
    it reaches the floor, preserving the draw's skew shape up to the
    minimum-size floor. Feasible regimes break out of the loop exactly
    as before (same rng consumption), so existing seeded partitions are
    unchanged."""
    if n_clients * min_size > len(labels):
        raise ValueError(
            f"cannot give {n_clients} clients >= {min_size} examples "
            f"each from {len(labels)} total")
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(max_tries):
        idx_per_client = [[] for _ in range(n_clients)]
        for k in range(n_classes):
            idx_k = np.where(labels == k)[0]
            rng.shuffle(idx_k)
            p = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(p) * len(idx_k)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_k, cuts)):
                idx_per_client[i].extend(part.tolist())
        if min(len(ix) for ix in idx_per_client) >= min_size:
            break
    else:
        for i in range(n_clients):
            while len(idx_per_client[i]) < min_size:
                donor = max(range(n_clients),
                            key=lambda j: len(idx_per_client[j]))
                idx_per_client[i].append(idx_per_client[donor].pop())
    out = []
    for ix in idx_per_client:
        ix = np.asarray(ix)
        rng.shuffle(ix)
        out.append(ix)
    return out


def class_counts(labels: np.ndarray, idx: np.ndarray, n_classes: int):
    return np.bincount(labels[idx], minlength=n_classes)
