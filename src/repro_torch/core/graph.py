"""One server epoch captured as a CUDA graph and replayed: the card's
counterpart of the reference's fused epoch driver, a ``jax.lax.scan``
over a chunk of epochs with donated carries
(``repro/core/dense.py:219-239``).

``CapturedEpoch(fn)`` captures ``fn()`` (the epoch's steps on static
input buffers) with ``torch.cuda.graph``: capture records the kernels
and launches none, so it changes no tensor. ``replay()`` launches the
recorded kernels on the tensors captured, which must stay at their
addresses: callers update parameters, optimizer state and inputs in
place, never by rebinding. A failed capture or replay raises; nothing
runs the epoch eagerly in its place.

The kernels' launch counters (``kernels.counters()``) are bumped on the
host when a wrapper runs. Capture runs every wrapper once and launches
nothing, and a replay launches without running any, so the counts are
kept to what the card executes: capture's increments are recorded and
taken back out, and each replay adds them once.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch import kernels


class CapturedEpoch:
    """``fn`` captured once; ``replay()`` runs it on the card and returns
    its output tensors (static: each replay overwrites them)."""

    def __init__(self, fn: Callable):
        counts = kernels.counters()
        before = [dict(c) for c in counts]
        self.graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()        # time the capture alone
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            self.out = fn()
        torch.cuda.synchronize()
        self.capture_seconds = time.perf_counter() - t0
        self.recorded = [{k: c[k] - b[k] for k in c if c[k] != b[k]}
                         for c, b in zip(counts, before)]
        for c, b in zip(counts, before):
            c.update(b)                 # capture launched nothing
        self.replays = 0

    def replay(self):
        self.graph.replay()
        for c, rec in zip(kernels.counters(), self.recorded):
            for k, n in rec.items():
                c[k] += n
        self.replays += 1
        return self.out
