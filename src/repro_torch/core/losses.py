"""The DENSE losses (paper §2.2–2.3; ``repro/core/losses.py:34-117``).

  L_CE  (Eq. 2)  CE(D(x̂), y) on the ensemble-average logits
  L_BN  (Eq. 3)  client BN batch statistics against their running ones
  L_div (Eq. 4)  −KL(D ‖ f_S), only where the two argmaxes differ
  L_gen (Eq. 5)  = L_CE + λ1·L_BN + λ2·L_div
  L_dis (Eq. 6)  KL(D(x̂) ‖ f_S(x̂))

Every KL-based loss takes ``mode``: ``"ref"`` (materialized log-softmax,
torch autograd) or ``"fused"`` (the K1 pair, kernels/distill_kl.py).
``with_teacher_grad=False`` lets the student step, whose teacher is
constant, skip the kernel's dL/dt stream.

On logits that are this rank's vocabulary columns (``tp``, a
vocabulary-parallel ``launch/shardings.Layout``: the partitioned pod
step) the plain KL takes each row's log-sum-exp over ``model`` (an
all-reduce max and sum) and sums the row's terms over ``model``; K1
takes the logits all-gathered over ``model`` first, as the reference's
compiler does with a custom call that has no partitioning rule.
"""
from __future__ import annotations

import torch

from repro_torch.configs.backend import check_kl_mode
from repro_torch.kernels import ops


def _vocab_log_softmax(t: torch.Tensor, tp) -> torch.Tensor:
    """log softmax over the vocabulary of which ``t`` holds this rank's
    columns: the log-sum-exp over ``model``, entering this rank's
    columns through ``tp.enter`` (its gradient sums every rank's
    share)."""
    from repro_torch.launch.mesh import max_over

    mx = max_over(t.amax(dim=-1, keepdim=True), tp.mesh, "model")
    lse = mx + torch.log(tp.sum(torch.exp(t - mx).sum(dim=-1,
                                                      keepdim=True)))
    return t - tp.enter(lse)


def softmax_kl(p_logits: torch.Tensor, q_logits: torch.Tensor,
               temperature: float = 1.0, *, mode: str = "ref",
               with_teacher_grad: bool = True, tp=None) -> torch.Tensor:
    """Per-sample KL(softmax(p/T) ‖ softmax(q/T)) over the last axis.

    The temperature is applied outside the kernel, so the 1/T chain rule
    is the same in both modes. Any leading shape is accepted; the kernel
    sees the flattened (rows, V) view. ``tp``: the logits are this
    rank's vocabulary columns (module doc)."""
    check_kl_mode(mode)
    pt = p_logits.float() / temperature
    qt = q_logits.float() / temperature
    if tp is not None and tp.vocab:
        if mode == "fused":
            from repro_torch.launch.mesh import gather_over

            def whole(t):
                return gather_over(t.movedim(-1, 0).contiguous(), tp.mesh,
                                   "model").movedim(0, -1)
            pt, qt = whole(pt), whole(qt)
        else:
            logp = _vocab_log_softmax(pt, tp)
            logq = _vocab_log_softmax(qt, tp)
            return tp.sum(torch.sum(torch.exp(logp) * (logp - logq),
                                    dim=-1))
    if mode == "fused":
        lead, v = pt.shape[:-1], pt.shape[-1]
        kl = ops.distill_kl(pt.reshape(-1, v), qt.reshape(-1, v),
                            with_teacher_grad=with_teacher_grad)
        return kl.reshape(lead)
    logp = torch.log_softmax(pt, dim=-1)
    logq = torch.log_softmax(qt, dim=-1)
    return torch.sum(torch.exp(logp) * (logp - logq), dim=-1)


def ce_loss(avg_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Eq. (2)."""
    logp = torch.log_softmax(avg_logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def bn_loss(per_client_stats) -> torch.Tensor:
    """Eq. (3): (1/m) Σ_k Σ_l ‖μ_l(x̂) − μ_{k,l}‖ + ‖σ²_l(x̂) − σ²_{k,l}‖,
    with unsquared L2 norms. A grouped teacher's stats
    (``ensemble.GroupedStats``) are summed a stacked group (or chunk)
    at a time: its clients' terms for all layers at once, then their
    sum; the same value to float32 summation order, with a few kernels
    a group instead of a few a client. A part sharded over a mesh's
    clients axis holds this rank's clients: their terms are summed here,
    then over the axis (``fl.sharding.sum_over_clients``: its gradient
    stays this rank's share, which the teacher's ``replicated_input``
    sums)."""
    from repro_torch.fl.sharding import sum_over_clients

    parts = getattr(per_client_stats, "parts", None)
    if parts is None:
        parts = [(1, stats, False, None) for stats in per_client_stats]
    total = None
    for _, stats, stacked, mesh in parts:
        if stacked:
            term = None
            for s in stats:
                t = torch.linalg.vector_norm(s["mean"] - s["running_mean"],
                                             dim=-1) \
                    + torch.linalg.vector_norm(s["var"] - s["running_var"],
                                               dim=-1)
                term = t if term is None else term + t
            if term is not None:
                term = term.sum()
                if mesh is not None:
                    term = sum_over_clients(term, mesh)
                total = term if total is None else total + term
            continue
        for s in stats:                       # one dict per BN layer
            term = torch.linalg.vector_norm(s["mean"] - s["running_mean"]) \
                + torch.linalg.vector_norm(s["var"] - s["running_var"])
            total = term if total is None else total + term
    if total is None:
        return torch.zeros(())
    return total / max(len(per_client_stats), 1)


def div_loss(avg_logits: torch.Tensor, student_logits: torch.Tensor,
             temperature: float = 1.0, *, mode: str = "ref") -> torch.Tensor:
    """Eq. (4): −mean(ω·KL(D ‖ f_S)), ω = 1[argmax D ≠ argmax f_S].

    Already negated (the loss to minimize); gradients reach the
    generator through both logit tensors, so the fused mode keeps the
    teacher-side gradient on."""
    omega = (avg_logits.argmax(-1) != student_logits.argmax(-1)).float()
    kl = softmax_kl(avg_logits, student_logits, temperature, mode=mode)
    return -torch.mean(omega * kl)


def gen_loss(avg_logits, labels, per_client_stats, student_logits, *,
             lambda_bn: float, lambda_div: float, mode: str = "ref"):
    """Eq. (5). Returns (total, dict of parts)."""
    l_ce = ce_loss(avg_logits, labels)
    l_bn = bn_loss(per_client_stats)
    l_div = div_loss(avg_logits, student_logits, mode=mode)
    total = l_ce + lambda_bn * l_bn + lambda_div * l_div
    return total, {"ce": l_ce, "bn": l_bn, "div": l_div}


def distill_loss(avg_logits: torch.Tensor, student_logits: torch.Tensor,
                 temperature: float = 1.0, *, mode: str = "ref",
                 with_teacher_grad: bool = True) -> torch.Tensor:
    """Eq. (6): mean_b KL(D(x̂) ‖ f_S(x̂))."""
    return torch.mean(softmax_kl(avg_logits, student_logits, temperature,
                                 mode=mode,
                                 with_teacher_grad=with_teacher_grad))
