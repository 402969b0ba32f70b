"""Plain PyTorch oracles for the kernels (``repro/kernels/ref.py:17-59,
62-137, 140-160``).

Each uses the most direct formulation (materialized log-softmax, torch
autograd), so a test compares two different derivations, not two copies
of one.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale=None):
    """Materialized-softmax attention, the O(S²)-memory oracle of K2 and
    the ``"ref"`` route of ``ops.flash_attention``.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), Hq a multiple of Hkv; the q
    tokens are the last Sq of the Sk keys. ``window`` w > 0 keeps keys
    with q_pos − k_pos < w. Scores and probabilities in float32, the
    output in q's dtype. A row with no live key averages v uniformly, as
    the reference's softmax over an all-NEG_INF row does."""
    B, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(B, hkv, hq // hkv, sq, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    live = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        live &= k_pos <= q_pos
    if window:
        live &= q_pos - k_pos < window
    probs = torch.softmax(torch.where(live, scores, NEG_INF), dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    return out.reshape(B, hq, sq, d).to(q.dtype)


def attention_grads(q, k, v, g, *, causal: bool = True, window: int = 0,
                    scale=None):
    """Autograd of ``attention`` under the output cotangent ``g``:
    (dq, dk, dv), the ground truth for the K2 backward."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        out = attention(*leaves, causal=causal, window=window, scale=scale)
        return torch.autograd.grad(out, leaves, g)


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


def ssd(x, dt, a, b, c, *, initial_state=None):
    """Step-by-step SSM recurrence, the O(S) sequential oracle of K3
    (``kernels/ssd_scan.py``).

    x: (B, S, H, P), dt: (B, S, H), a: (H,), b/c: (B, S, G, N); head h
    reads group h·G // H.
    s_t = exp(dt_t a) s_{t-1} + dt_t (x_t ⊗ b_t);  y_t = s_t · c_t.
    Returns (y (B, S, H, P) in x's dtype, final_state (B, H, P, N)
    float32)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    bb = b.repeat_interleave(rep, dim=2).float()
    cc = c.repeat_interleave(rep, dim=2).float()
    xf, dtf, af = x.float(), dt.float(), a.float()
    s = torch.zeros((B, H, P, N), device=x.device) if initial_state is None \
        else initial_state.float()
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t] * af[None, :])                  # (B, H)
        s = s * da[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t], bb[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", s, cc[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((B, 0, H, P))
    return y.to(x.dtype), s


def ssd_grads(x, dt, a, b, c, initial_state, g_y, g_state):
    """Autograd of ``ssd`` under the cotangents (g_y, g_state): (dx, ddt,
    da, db, dc, dinitial_state), the ground truth for the K3 backward."""
    leaves = [t.detach().requires_grad_(True)
              for t in (x, dt, a, b, c, initial_state)]
    with torch.enable_grad():
        y, final = ssd(*leaves[:5], initial_state=leaves[5])
        return torch.autograd.grad((y, final), leaves,
                                   (g_y.to(y.dtype), g_state.float()))
