"""Learning-rate schedules as callables of the (int) step
(``repro/optim/schedules.py``). Each returns a Python float; the
optimizers evaluate them on the host, once a step."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: lr


def cosine(lr: float, total_steps: int, final_frac: float = 0.0):
    def f(step):
        t = min(step, total_steps) / max(total_steps, 1)
        c = 0.5 * (1 + math.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * c)
    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.0):
    """Linear warm-up from 0 over ``warmup`` steps, then ``cosine`` over
    the remaining ``total_steps - warmup``."""
    cos = cosine(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        if step < warmup:
            return lr * min(step / max(warmup, 1), 1.0)
        return cos(step - warmup)
    return f
