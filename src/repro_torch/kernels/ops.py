"""Public kernel entry points (``repro/kernels/ops.py:253-293``).

``distill_kl`` always goes through the K1 pair (``DistillKL``); the
choice between it and the materialized formula lives one level up, in
``core.losses.softmax_kl``. Where K1 runs follows the tensors: on the
CPU its wrappers take their plain versions, on a CUDA device they launch
the Triton kernels or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.distill_kl import DistillKL


def distill_kl(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
               with_teacher_grad: bool = True) -> torch.Tensor:
    """Per-row KL(softmax(t) ‖ softmax(s)) of (R, V) logits, (R,) float32,
    differentiable through the K1 backward."""
    return DistillKL.apply(teacher_logits.contiguous(),
                           student_logits.contiguous(), with_teacher_grad)
