"""Public kernel entry points (``repro/kernels/ops.py:154-293``).

``distill_kl`` always goes through the K1 pair (``DistillKL``); the
choice between it and the materialized formula lives one level up, in
``core.losses.softmax_kl``. Where K1 runs follows the tensors: on the
CPU its wrappers take their plain versions, on a CUDA device they launch
the Triton kernels or raise.

``flash_attention``, ``ssd_scan`` and ``paged_attention`` are routed by
``policy.kernel_vjp``, as in the reference:

  * ``"ref"`` runs the materialized plain version (``kernels/ref.py``),
    differentiated by torch autograd;
  * ``"fused"`` runs the kernels: K2 behind ``FlashAttention`` and K3
    behind ``SSDScan``, each with its own backward
    (``kernels/flash_attention.py``, ``kernels/ssd_scan.py``), and K4
    (``kernels/paged_attention.py``);
  * ``"autodiff"`` runs the bare forward kernel. As in the reference it
    cannot be differentiated, so ``flash_attention`` and ``ssd_scan``
    raise when an input requires a gradient.

Each re-validates the mode it is given, so a hand-built ``ExecPolicy``
with an unknown mode raises instead of falling through to a kernel.
"""
from __future__ import annotations

import torch

from repro_torch.configs.backend import (check_kernel_vjp_mode,
                                         resolve_exec_policy)
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.distill_kl import DistillKL


def _mode(policy, device) -> str:
    """The policy's ``kernel_vjp``, validated."""
    mode = resolve_exec_policy(policy, device=device).kernel_vjp
    check_kernel_vjp_mode(mode)
    return mode


def distill_kl(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
               with_teacher_grad: bool = True) -> torch.Tensor:
    """Per-row KL(softmax(t) ‖ softmax(s)) of (R, V) logits, (R,) float32,
    differentiable through the K1 backward."""
    return DistillKL.apply(teacher_logits.contiguous(),
                           student_logits.contiguous(), with_teacher_grad)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    policy=None) -> torch.Tensor:
    """Attention over q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), the q
    tokens the last Sq of the keys; (B, Hq, Sq, D) in q's dtype.
    ``policy`` (an ``ExecPolicy``; None resolves q's device profile)
    picks the plain version, K2 with its backward, or K2's bare
    forward."""
    mode = _mode(policy, q.device)
    if mode == "ref":
        return _ref.attention(q, k, v, causal=causal, window=window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if mode == "fused":
        return _fa.FlashAttention.apply(q, k, v, causal, window, None)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(
            "kernel_vjp='autodiff' runs K2's forward alone, which cannot be "
            "differentiated (as in the reference): use 'fused' or 'ref'")
    o_f32, _ = _fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    return o_f32.reshape(q.shape).to(q.dtype)


def ssd_scan(x, dt, a, b, c, initial_state=None, *, chunk: int,
             policy=None):
    """The SSD scan over x (B, S, H, P), dt (B, S, H), a (H,), b and c
    (B, S, G, N), seeded by ``initial_state`` (B, H, P, N) (zeros when
    None): (y (B, S, H, P) in x's dtype, final_state (B, H, P, N)
    float32). ``chunk`` is clamped into S (``repro/configs/backend.py:
    501-503``); any S is accepted. ``policy`` (an ``ExecPolicy``; None
    resolves x's device profile) picks the sequential recurrence
    (``ref.ssd``), K3 with its backward, or K3f alone."""
    mode = _mode(policy, x.device)
    if mode == "ref":
        return _ref.ssd(x, dt, a, b, c, initial_state=initial_state)
    cl = min(int(chunk), int(x.shape[1]))
    if mode == "fused":
        return _ssd.SSDScan.apply(x, dt, a, b, c, initial_state, cl)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, initial_state)):
        raise ValueError(
            "kernel_vjp='autodiff' runs K3's forward alone, which cannot be "
            "differentiated (as in the reference): use 'fused' or 'ref'")
    return _ssd.ssd_scan_fwd(x, dt, a, b, c, initial_state, chunk=cl)


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, *,
                    scale=None, policy=None) -> torch.Tensor:
    """Decode attention through a block-pool cache. q: (R, Hq, D);
    k/v_pool: (P, page, Hkv, D); block_tables: (R, M) int32; seq_lens:
    (R,) int32. ``policy`` (an ``ExecPolicy``; None resolves q's device
    profile) picks the plain version or K4."""
    fn = _ref.paged_attention if _mode(policy, q.device) == "ref" \
        else _pa.paged_attention
    return fn(q, k_pool, v_pool, block_tables, seq_lens, scale=scale)
