"""SGD with heavy-ball momentum, Adam and global-norm clipping, as
``repro/optim/optimizers.py`` computes them.

Each optimizer holds a list of tensors and updates them in place from a
list of gradients of the same length (``step(grads)``), so callers take
gradients with ``torch.autograd.grad`` for exactly the tensors they
train. State is float32, as in the reference. A tensor may be a view:
the partitioned train step (``launch/steps.Partitioned``, ZeRO-1) gives
Adam each rank's ``data`` slice of a parameter, which it updates in
place, with moments of the slice's shape.

``lr`` is a float or a schedule, a callable of an int step
(``optim/schedules.py``): ``sgd`` evaluates it at the ``step`` its
caller passes (0 by default), ``adam`` at its own count t, from 1 on, as
the reference does. ``weight_decay`` adds wd·p to the gradient before
momentum (L2 regularization, not decoupled decay).

``step_if(grads, ok)`` is the guarded step of DENSE's
``nan_policy="skip"`` (the reference's ``where(ok, new, old)`` over
params and optimizer state, ``repro/core/dense.py:149-155``): ``ok`` is
a 0-d bool on the device, every tensor takes its new value where it is
True and keeps its old one where it is False, with no host read. Where
``ok`` is True the new values are the ones ``step`` computes, bit for
bit: SGD runs ``step`` itself and puts the old values back where ``ok``
is False.

Adam's step count lives on the host until ``count_on_device()`` (or the
first ``step_if``) moves it to the device; from then on every step reads
and advances it there, with no host read, so that a captured CUDA graph
of the step (the fused epoch driver, ``core/dense.py``) takes new bias
corrections on each replay, and a skipped step does not advance it. The
device-count step and the host-count step are one formula, bit for bit
(``_div_by``). ``count()`` and ``set_count()`` read and restore the
count wherever it lives.
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


def _const_lr(lr) -> float:
    if callable(lr):
        raise ValueError("step_if takes a constant learning rate: a "
                         "schedule needs the step count on the host")
    return lr


def _div_by(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """x / d for a 0-d float64 ``d`` on x's device, rounded as ``x / d``
    rounds for a Python float d: on a CUDA tensor PyTorch multiplies by
    the reciprocal of the host scalar, taken in float64 and rounded to
    x's type; on the CPU it divides by d rounded to x's type. This must
    track how PyTorch rounds division by a scalar, or ``adam.step_if``
    drifts from ``step``: ``tests/test_torch_cuda.py``'s guarded-step
    test holds the two bit for bit on the card."""
    if x.is_cuda:
        return x * (1.0 / d).to(x.dtype)
    return x / d.to(x.dtype)


@torch.no_grad()
def _select(ok: torch.Tensor | None, dst: torch.Tensor,
            new: torch.Tensor) -> None:
    """dst = new where ``ok`` (everywhere when ``ok`` is None), in place."""
    dst.copy_(new if ok is None else torch.where(ok, new.to(dst.dtype), dst))


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

    @torch.no_grad()
    def step_if(self, grads: Sequence[torch.Tensor], ok: torch.Tensor,
                step: int = 0) -> None:
        """``step(grads, step)`` where ``ok``, nothing where not (module
        doc): the step runs, then the old values go back where not."""
        state = self.params + (self.bufs or [])
        old = [t.clone() for t in state]
        self.step(grads, step)
        for t, o in zip(state, old, strict=True):
            t.copy_(torch.where(ok, t, o))


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
        self.t_dev = None           # the count, once it lives on the device

    def count(self) -> int:
        """The steps taken (one host read once the count is on the
        device)."""
        return self.t if self.t_dev is None else int(self.t_dev)

    def set_count(self, t: int) -> None:
        """Restore the count, in place where it lives on the device."""
        self.t = int(t)
        if self.t_dev is not None:
            self.t_dev.fill_(float(t))

    def count_on_device(self) -> torch.Tensor:
        """Move the count to the device (a 0-d float64 on the params'
        device) for every later step; returns it."""
        if self.t_dev is None:
            _const_lr(self.lr)
            self.t_dev = torch.tensor(float(self.t), dtype=torch.float64,
                                      device=self.params[0].device)
        return self.t_dev

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        if self.t_dev is not None:
            self._device_step(grads, None)
            return
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

    @torch.no_grad()
    def step_if(self, grads: Sequence[torch.Tensor], ok: torch.Tensor) -> None:
        """``step(grads)`` where ``ok``, nothing where not, the count
        included (module doc)."""
        self.count_on_device()
        self._device_step(grads, ok)

    @torch.no_grad()
    def _device_step(self, grads, ok) -> None:
        """The step on the device count: the bias corrections are taken
        in float64 on the device, as ``step`` takes them on the host, and
        divide as a host float divides (``_div_by``). ``ok`` None: every
        tensor takes its new value."""
        lr = _const_lr(self.lr)
        t = self.t_dev + 1
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        for p, m, v, g in zip(self.params, self.m, self.v,
                              _decayed(grads, self.params, self.wd),
                              strict=True):
            g = g.float()
            m_new = (m * self.b1).add_((1 - self.b1) * g)
            v_new = (v * self.b2).add_((1 - self.b2) * (g * g))
            new = p.float() - lr * _div_by(m_new, bc1) \
                / (torch.sqrt(_div_by(v_new, bc2)) + self.eps)
            _select(ok, p, new)
            _select(ok, m, m_new)
            _select(ok, v, v_new)
        _select(ok, self.t_dev, t)
