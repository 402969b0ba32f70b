"""SGD with heavy-ball momentum, Adam and global-norm clipping, as
``repro/optim/optimizers.py`` computes them.

Each optimizer holds a list of tensors and updates them in place from a
list of gradients of the same length (``step(grads)``), so callers take
gradients with ``torch.autograd.grad`` for exactly the tensors they
train. State is float32, as in the reference.

``lr`` is a float or a schedule, a callable of an int step
(``optim/schedules.py``): ``sgd`` evaluates it at the ``step`` its
caller passes (0 by default), ``adam`` at its own count t, from 1 on, as
the reference does. ``weight_decay`` adds wd·p to the gradient before
momentum (L2 regularization, not decoupled decay).
"""
from __future__ import annotations

from typing import Iterable, Sequence

import torch


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float):
    """Scale every tensor by min(1, max_norm / ‖tensors‖) in float32 and
    cast back. Returns (clipped list, the global norm)."""
    n = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return [(t.float() * scale).to(t.dtype) for t in tensors], n


def _lr(lr, step) -> float:
    return lr(step) if callable(lr) else lr


def _decayed(grads, params, wd: float):
    if not wd:
        return grads
    return [g + wd * p.to(g.dtype) for g, p in zip(grads, params,
                                                   strict=True)]


class sgd:
    """m = μ·m + g;  p = p − lr·m  (torch.optim.SGD's momentum rule; the
    paper's client optimizer with lr=0.01, μ=0.9)."""

    def __init__(self, params: Sequence[torch.Tensor], lr,
                 momentum: float = 0.0, weight_decay: float = 0.0):
        self.params = list(params)
        self.lr, self.momentum, self.wd = lr, momentum, weight_decay
        self.bufs = [torch.zeros_like(p, dtype=torch.float32)
                     for p in self.params] if momentum else None

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], step: int = 0) -> None:
        lr = _lr(self.lr, step)
        grads = _decayed(grads, self.params, self.wd)
        if self.bufs is None:
            for p, g in zip(self.params, grads, strict=True):
                p.copy_(p.float() - lr * g.float())
            return
        for p, m, g in zip(self.params, self.bufs, grads, strict=True):
            m.mul_(self.momentum).add_(g.float())
            p.copy_(p.float() - lr * m)


class adam:
    """Adam with bias correction counted from t = 1 (the paper's generator
    optimizer, lr=1e-3)."""

    def __init__(self, params: Sequence[torch.Tensor], lr,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd = weight_decay
        self.m = [torch.zeros_like(p, dtype=torch.float32)
                  for p in self.params]
        self.v = [torch.zeros_like(p, dtype=torch.float32)
                  for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        lr = _lr(self.lr, self.t)
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for p, m, v, g in zip(self.params, self.m, self.v,
                              _decayed(grads, self.params, self.wd),
                              strict=True):
            g = g.float()
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * (g * g))
            p.copy_(p.float() - lr * (m / bc1)
                    / (torch.sqrt(v / bc2) + self.eps))
