"""Seeded minibatch iterators and batch plans: the port's own copies of
``repro/data/pipeline.py``'s ``batches``, ``lm_batches``, ``BatchPlan``,
``build_batch_plan``, ``bucket_members``, ``plan_step_waste`` and
``pad_shards`` (numpy only, the same index streams, plans and buckets,
bit for bit).

``build_batch_plan`` lays out a whole group's seeded minibatch streams
as one padded (m, steps, batch) index array with a validity mask, which
the grouped engine (``fl/client.local_update_grouped``) gathers from on
the device, step by step, for all m clients at once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

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


@dataclass(frozen=True)
class BatchPlan:
    """The minibatch schedule of m clients training in lockstep
    (``repro/data/pipeline.py:34-56``).

    idx[k, s]  — sample indices into client k's (padded) shard at step s.
    mask[k, s] — True where the slot holds a real sample. A ragged last
                 batch is padded with index 0 and mask False; a client
                 with fewer batches an epoch than the group's most gets
                 fully masked steps, on which its parameters and
                 optimizer state pass through unchanged
                 (``fl/client.local_update_grouped``).
    """
    idx: np.ndarray            # (m, steps, batch) int32
    mask: np.ndarray           # (m, steps, batch) bool
    steps_per_epoch: int       # the group's most batches an epoch
    epochs: int
    batch_size: int

    @property
    def steps(self) -> int:
        return self.idx.shape[1]


def build_batch_plan(shard_sizes: Sequence[int], batch_size: int, *,
                     epochs: int, seeds: Sequence[int],
                     steps_per_epoch: int | None = None) -> BatchPlan:
    """Every epoch's seeded permutation of every client, padded to the
    group's most batches an epoch (or to ``steps_per_epoch``, at least
    that). Client k's valid slots, in order, are exactly the index stream
    of ``batches(..., seed=seeds[k], epochs=epochs)``."""
    assert len(shard_sizes) == len(seeds)
    m = len(shard_sizes)
    nb = [-(-int(n) // batch_size) for n in shard_sizes]   # ceil
    nb_max = max(nb) if nb else 0
    if steps_per_epoch is not None:
        if steps_per_epoch < nb_max:
            raise ValueError(f"steps_per_epoch={steps_per_epoch} < group "
                             f"max batches/epoch {nb_max}")
        nb_max = int(steps_per_epoch)
    steps = epochs * nb_max
    idx = np.zeros((m, steps, batch_size), np.int32)
    mask = np.zeros((m, steps, batch_size), bool)
    for k, (n, seed) in enumerate(zip(shard_sizes, seeds)):
        rng = np.random.default_rng(seed)
        for e in range(epochs):
            perm = rng.permutation(int(n))
            for j in range(nb[k]):
                sel = perm[j * batch_size:(j + 1) * batch_size]
                s = e * nb_max + j
                idx[k, s, :len(sel)] = sel
                mask[k, s, :len(sel)] = True
    return BatchPlan(idx=idx, mask=mask, steps_per_epoch=nb_max,
                     epochs=epochs, batch_size=batch_size)


def bucket_members(shard_sizes: Sequence[int], batch_size: int,
                   mode: str = "off") -> list[tuple[int, ...]]:
    """Bin clients by batches an epoch before padding (DESIGN.md §13;
    ``repro/data/pipeline.py:96-140``).

    Returns a partition of ``range(m)`` as member-index tuples, ordered
    by ascending bucket step count; members keep their order within a
    bucket. ``off``: one bucket. ``pow2``: the next power of two of
    ceil(n_k / batch), so no client wastes 2x padded steps in its
    bucket. ``quantile``: 4 quantile bins of the batches-an-epoch
    distribution. No mode changes a client's seeded minibatch stream,
    only the fully masked padding steps appended to it."""
    nb = [-(-int(n) // batch_size) for n in shard_sizes]
    m = len(nb)
    if mode == "off" or m <= 1:
        return [tuple(range(m))] if m else []
    if mode == "pow2":
        def key(b):
            p = 1
            while p < max(b, 1):
                p *= 2
            return p
        keys = [key(b) for b in nb]
    elif mode == "quantile":
        qs = np.quantile(np.asarray(nb, np.float64), [0.25, 0.5, 0.75])
        keys = list(np.searchsorted(qs, np.asarray(nb, np.float64),
                                    side="left"))
    else:
        raise ValueError(f"unknown plan_bucketing mode {mode!r}")
    buckets: dict = {}
    for i, k in enumerate(keys):
        buckets.setdefault(k, []).append(i)
    # buckets by their most batches an epoch, ascending
    return [tuple(buckets[k]) for k in
            sorted(buckets, key=lambda k: max(nb[i] for i in buckets[k]))]


def plan_step_waste(shard_sizes: Sequence[int], batch_size: int,
                    mode: str = "off") -> float:
    """The share of scheduled optimizer steps that are fully masked
    padding under ``mode`` bucketing (the epoch count cancels)."""
    nb = [-(-int(n) // batch_size) for n in shard_sizes]
    total = real = 0
    for members in bucket_members(shard_sizes, batch_size, mode):
        bmax = max(nb[i] for i in members)
        total += bmax * len(members)
        real += sum(nb[i] for i in members)
    return 1.0 - real / total if total else 0.0


def pad_shards(shards: Sequence[tuple], *,
               pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Ragged shards [(x_k, y_k), ...] as rectangular (m, max_n, ...)
    arrays, zero past each client's n_k (or to ``pad_to`` rows, at least
    the largest shard). A BatchPlan never gathers a padding row."""
    m = len(shards)
    max_n = max(len(y) for _, y in shards)
    if pad_to is not None:
        if pad_to < max_n:
            raise ValueError(f"pad_to={pad_to} < largest shard {max_n}")
        max_n = int(pad_to)
    x0, y0 = shards[0]
    xs = np.zeros((m, max_n, *x0.shape[1:]), x0.dtype)
    ys = np.zeros((m, max_n), y0.dtype)
    for k, (x, y) in enumerate(shards):
        xs[k, :len(y)] = x
        ys[k, :len(y)] = y
    return xs, ys
