"""Seeded minibatch iterator: the port's own copy of
``repro/data/pipeline.py:batches`` (numpy only, the same index stream)."""
from __future__ import annotations

import numpy as np


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, *, seed: int,
            epochs: int = 1, drop_last: bool = False):
    rng = np.random.default_rng(seed)
    n = len(y)
    for _ in range(epochs):
        perm = rng.permutation(n)
        end = n - (n % batch_size) if drop_last else n
        for i in range(0, end, batch_size):
            sel = perm[i:i + batch_size]
            yield x[sel], y[sel]
