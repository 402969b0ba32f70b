"""DENSE at LLM scale (``repro/core/dense_llm.py:38-190``): the paper's
technique with decoder LMs as clients.

  * clients  = decoder LMs sharing a vocabulary (the label space): every
    family but the vlm (``check_llm_dense_arch``), gemma3's windows and
    the moe family's MLA and routed experts included;
  * generator = the token generator (``core/generator.TokGenerator``)
    emitting soft embeddings, taken through ``forward(..., embeds=)``;
  * D(x̂)    = the clients' next-token logits averaged over the clients;
  * L_BN     = matching the generator's embedding statistics to each
    client's embedding table (the LMs have no BatchNorm);
  * L_dis / L_div = token-level KL over the vocabulary, the K1 pair on
    the card.

The generator step trains on L_CE + λ_bn·L_BN + λ_div·L_div with
gradients flowing through every trunk (the clients' and the student's,
K2's backward on the card) into the embeddings; the student step distils
on L_dis with the generator and the ensemble under ``torch.no_grad()``.

The ensemble loops over the members of each group of identical configs
and sums their logits in the reference's order (groups in order of first
appearance, then the group sums). It does not stack them, as the
reference's vmap does: two stacked full-size clients would double their
memory. The pod-sharded ``make_pod_distill_step`` and ``chunked_kl``
need a mesh and are not ported (ROADMAP.md).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import optim
from repro_torch.configs.backend import (check_kernel_vjp_mode, check_kl_mode,
                                         resolve_exec_policy)
from repro_torch.core import losses as LS
from repro_torch.core.generator import tok_generator
from repro_torch.models import transformer as T


def group_lm_clients(client_cfgs):
    """Clients grouped by config, in order of first appearance:
    [(cfg, (indices...)), ...]."""
    groups: dict = {}
    for i, cfg in enumerate(client_cfgs):
        groups.setdefault(cfg, []).append(i)
    return [(cfg, tuple(idx)) for cfg, idx in groups.items()]


def ensemble_lm_logits(client_cfgs, client_params, embeds: torch.Tensor):
    """D(x̂): the clients' logits over ``embeds`` (B, S, D), float32,
    averaged; (B, S, V)."""
    acc = None
    for cfg, idx in group_lm_clients(client_cfgs):
        group_sum = None
        for i in idx:
            lg, _ = T.forward(client_params[i], cfg, embeds=embeds,
                              remat=False)
            lg = lg.float()
            group_sum = lg if group_sum is None else group_sum + lg
        acc = group_sum if acc is None else acc + group_sum
    return acc / len(client_cfgs)


def embed_stats_loss(client_cfgs, client_params, embeds: torch.Tensor):
    """L_BN's analogue: ‖μ_g − μ_k‖ + ‖σ²_g − σ²_k‖ averaged over the
    clients, the generator's embedding statistics over (batch, sequence)
    against each client's embedding table's over its rows (biased
    variances). Computable from the uploads alone: data-free."""
    e = embeds.float()
    var_g, mu_g = torch.var_mean(e, dim=(0, 1), correction=0)
    total = torch.zeros((), device=e.device)
    for params in client_params:
        var_k, mu_k = torch.var_mean(params["embed"]["table"].float(), dim=0,
                                     correction=0)
        total = total + torch.linalg.vector_norm(mu_g - mu_k) \
            + torch.linalg.vector_norm(var_g - var_k)
    return total / len(client_cfgs)


def check_llm_dense_arch(cfg) -> None:
    """Raise for a vlm: the server feeds every trunk the generator's soft
    embeddings alone, and a vlm's cross blocks attend over patch
    embeddings that the reference's LLM DENSE never passes (its
    ``forward`` asserts them, ``repro/models/transformer.py:425``, and
    ``ensemble_lm_logits`` gives none)."""
    if cfg.family == "vlm":
        raise ValueError(
            f"LLM DENSE cannot take {cfg.name!r} (family 'vlm'): its cross "
            "blocks need patch embeddings, and DENSE's server passes the "
            "trunks the generator's soft embeddings alone, as the "
            "reference's does")


def _reject_autodiff_mode(kernel_vjp_mode: str) -> None:
    """Both steps differentiate through the trunk; the bare forward
    kernel cannot be differentiated, so "autodiff" cannot train."""
    if kernel_vjp_mode == "autodiff":
        raise ValueError(
            "kernel_vjp_mode='autodiff' cannot train: the bare forward "
            "kernels have no backward; use 'ref' or 'fused'")


def _frozen(tree: dict) -> dict:
    """The same tensors, detached (views): weights that get no gradient
    in a step keep autograd from saving what only their gradient needs."""
    return {k: _frozen(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


def make_llm_dense_steps(student_cfg, client_cfgs: Sequence, *,
                         g_lr: float = 1e-3, s_lr: float = 1e-4,
                         lambda_bn: float = 1.0, lambda_div: float = 0.5,
                         distill_kl_mode: str | None = None,
                         kernel_vjp_mode: str | None = None,
                         device="cuda"):
    """The two server steps of a heterogeneous LM federation.

    Returns (gen_step, student_step, g_opt, s_opt):

      * ``g_opt(gen)`` / ``s_opt(student_params)`` build the Adam
        optimizers (lr ``g_lr`` over the generator's parameters, ``s_lr``
        over the student's tensors, which must require grad);
      * ``gen_step(gen, g_opt, student_params, client_params, z, y) ->
        (loss, {"ce", "bn", "div"})`` takes one generator step; z (B, nz),
        y (B, S) labels of which the generator reads ``y[:, 0]``;
      * ``student_step(student_params, s_opt, gen, client_params, z, y)
        -> loss`` takes one student step.

    Both update in place and return 0-d tensors (no host sync). Modes
    default to ``device``'s profile (cuda: K1 for the KLs, K2 in every
    trunk; cpu: the plain versions); explicit arguments pin them, and
    "autodiff" is refused, and so is a vlm (``check_llm_dense_arch``).
    The tensors given to the steps must lie on ``device``. A moe trunk
    runs without its load-balance term: the server losses carry none, as
    the reference's do."""
    pol = resolve_exec_policy(None, device=device)
    kl_mode = pol.distill_kl if distill_kl_mode is None else distill_kl_mode
    vjp_mode = pol.kernel_vjp if kernel_vjp_mode is None else kernel_vjp_mode
    check_kl_mode(kl_mode)
    check_kernel_vjp_mode(vjp_mode)
    _reject_autodiff_mode(vjp_mode)
    for cfg in (student_cfg, *client_cfgs):
        check_llm_dense_arch(cfg)
    student_cfg = student_cfg.replace(kernel_vjp_mode=vjp_mode)
    client_cfgs = [c.replace(kernel_vjp_mode=vjp_mode) for c in client_cfgs]
    V = student_cfg.vocab_size

    def gen_step(gen, g_opt, student_params, client_params, z, y):
        cparams = [_frozen(p) for p in client_params]
        embeds = tok_generator(gen, z, y[:, 0])
        avg = ensemble_lm_logits(client_cfgs, cparams, embeds)
        stu, _ = T.forward(_frozen(student_params), student_cfg,
                           embeds=embeds, remat=False)
        af = avg.reshape(-1, V)
        sf = stu.float().reshape(-1, V)
        l_ce = LS.ce_loss(af, y.reshape(-1))
        l_bn = embed_stats_loss(client_cfgs, cparams, embeds)
        l_div = LS.div_loss(af, sf, mode=kl_mode)
        total = l_ce + lambda_bn * l_bn + lambda_div * l_div
        g_opt.step(torch.autograd.grad(total, g_opt.params))
        return total.detach(), {"ce": l_ce.detach(), "bn": l_bn.detach(),
                                "div": l_div.detach()}

    def student_step(student_params, s_opt, gen, client_params, z, y):
        with torch.no_grad():
            embeds = tok_generator(gen, z, y[:, 0])
            avg = ensemble_lm_logits(client_cfgs, client_params, embeds)
        stu, _ = T.forward(student_params, student_cfg, embeds=embeds,
                           remat=False)
        # the teacher is constant here: skip the kernel's dL/dt stream
        loss = LS.distill_loss(avg.reshape(-1, V), stu.float().reshape(-1, V),
                               mode=kl_mode, with_teacher_grad=False)
        s_opt.step(torch.autograd.grad(loss, s_opt.params))
        return loss.detach()

    def make_g_opt(gen):
        return optim.adam(list(gen.parameters()), g_lr)

    def make_s_opt(student_params):
        return optim.adam(T.leaves(student_params), s_lr)

    return gen_step, student_step, make_g_opt, make_s_opt
