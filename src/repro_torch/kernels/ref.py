"""Plain PyTorch oracles for the kernels (``repro/kernels/ref.py:62-92,
140-160``).

Each uses the most direct formulation (materialized log-softmax, torch
autograd), so a test compares two different derivations, not two copies
of one.
"""
from __future__ import annotations

import math

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


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, *,
                    scale=None):
    """Gather-then-materialize paged decode attention: the plain version
    of K4 (kernels/paged_attention.py) and the CPU profile's route.

    q: (R, Hq, D); k/v_pool: (P, page, Hkv, D); block_tables: (R, M)
    int32; seq_lens: (R,) live cached tokens per request. Gathers each
    request's whole (M·page) context, then a masked softmax in float32;
    rows with ``seq_lens == 0`` give exact zeros. (R, Hq, D) in q's
    dtype."""
    R, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    m_slots = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    idx = block_tables.long()
    k = k_pool[idx].reshape(R, m_slots * page, hkv, d).float()
    v = v_pool[idx].reshape(R, m_slots * page, hkv, d).float()
    qg = q.reshape(R, hkv, hq // hkv, d).float()
    scores = torch.einsum("rkgd,rtkd->rkgt", qg, k) * scale
    live = (torch.arange(m_slots * page, device=q.device)[None, :]
            < seq_lens[:, None])[:, None, None]
    p = torch.softmax(torch.where(live, scores, NEG_INF), dim=-1)
    p = torch.where(live, p, 0.0)
    out = torch.einsum("rkgt,rtkd->rkgd", p, v)
    return out.reshape(R, hq, d).to(q.dtype)
