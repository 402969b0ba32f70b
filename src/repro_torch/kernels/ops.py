"""Public kernel entry points (``repro/kernels/ops.py:220-293``).

``distill_kl`` always goes through the K1 pair (``DistillKL``); the
choice between it and the materialized formula lives one level up, in
``core.losses.softmax_kl``. Where K1 runs follows the tensors: on the
CPU its wrappers take their plain versions, on a CUDA device they launch
the Triton kernels or raise.

``paged_attention`` is routed by ``policy.kernel_vjp``, as in the
reference: ``"ref"`` runs the gather-then-softmax plain version
(``kernels/ref.py``), anything else K4 (``kernels/paged_attention.py``,
CUDA C++ on the card).
"""
from __future__ import annotations

import torch

from repro_torch.configs.backend import resolve_exec_policy
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.distill_kl import DistillKL


def distill_kl(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
               with_teacher_grad: bool = True) -> torch.Tensor:
    """Per-row KL(softmax(t) ‖ softmax(s)) of (R, V) logits, (R,) float32,
    differentiable through the K1 backward."""
    return DistillKL.apply(teacher_logits.contiguous(),
                           student_logits.contiguous(), with_teacher_grad)


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, *,
                    scale=None, policy=None) -> torch.Tensor:
    """Decode attention through a block-pool cache. q: (R, Hq, D);
    k/v_pool: (P, page, Hkv, D); block_tables: (R, M) int32; seq_lens:
    (R,) int32. ``policy`` (an ``ExecPolicy``; None resolves q's device
    profile) picks the plain version or K4."""
    pol = resolve_exec_policy(policy, device=q.device)
    fn = _ref.paged_attention if pol.kernel_vjp == "ref" \
        else _pa.paged_attention
    return fn(q, k_pool, v_pool, block_tables, seq_lens, scale=scale)
