"""Plain PyTorch oracles for the kernels (``repro/kernels/ref.py:140-160``).

Each uses the most direct formulation (materialized log-softmax, torch
autograd), so a test compares two different derivations, not two copies
of one.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def distill_kl(teacher_logits: torch.Tensor,
               student_logits: torch.Tensor) -> torch.Tensor:
    """Per-row KL(softmax(t) ‖ softmax(s)) with materialized softmaxes.
    (R, V) -> (R,) in float32."""
    logp = torch.log_softmax(teacher_logits.float(), dim=-1)
    logq = torch.log_softmax(student_logits.float(), dim=-1)
    return torch.sum(torch.exp(logp) * (logp - logq), dim=-1)


def distill_kl_grads(teacher_logits, student_logits, g):
    """Autograd of ``distill_kl`` under the per-row cotangent ``g``:
    returns (dL/dt, dL/ds)."""
    t = teacher_logits.detach().requires_grad_(True)
    s = student_logits.detach().requires_grad_(True)
    with torch.enable_grad():
        kl = distill_kl(t, s)
        return torch.autograd.grad(kl, (t, s), g.float())
