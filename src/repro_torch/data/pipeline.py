"""Seeded minibatch iterators: the port's own copies of
``repro/data/pipeline.py``'s ``batches`` and ``lm_batches`` (numpy only,
the same index streams)."""
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


def lm_batches(tokens: np.ndarray, batch: int, seq: int, *, seed: int,
               steps: int):
    """``steps`` (x, y) pairs of (batch, seq) windows at random starts, y
    the next tokens of x."""
    rng = np.random.default_rng(seed)
    max_start = len(tokens) - seq - 1
    for _ in range(steps):
        starts = rng.integers(0, max_start, batch)
        x = np.stack([tokens[s:s + seq] for s in starts])
        y = np.stack([tokens[s + 1:s + seq + 1] for s in starts])
        yield x, y
