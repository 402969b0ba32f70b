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
memory.

The paper-scale distillation cell (``make_pod_distill_step``,
``repro/core/dense_llm.py:189-303``) is DENSE's stage 2 against a
homogeneous client stack: one config, the clients' tensors stacked on a
leading ensemble dim (``pod_stack_specs`` names its sharding). The
teacher's mean runs as a loop over that dim in client order, under no
gradient (the hand-written kernels do not pass ``torch.func.vmap``); on
a mesh with a ``pod`` axis each rank holds its pod's clients and the
mean is a local sum, one all-reduce over ``pod`` and a divide. Two loss
routes: the materialized (B·S, V) logits through ``LS.softmax_kl``, the
mean over the rows (the K1 pair on the card, dL/dt off), or ``chunked_kl``: hidden states
and a readout fused with the plain KL over ``kl_chunk``-token chunks,
each chunk recomputed in the backward, so no (B·S, V) tensor is ever
held. The student trunk runs with the policy's ``kernel_vjp`` (K2 on
the card) and remat. Given ``specs`` (the student state's, the stack's
``pod_stack_specs`` and the embeddings', as the reference's dry run jits
the cell) every trunk runs partitioned on this rank's shards
(``launch/steps``' module doc), the KL vocabulary-parallel (K1 on
logits all-gathered over ``model``) and its mean over the rows of every
``data`` shard.

Both step factories take the reference's ``mesh`` and pass it into every
client, teacher and student forward (``make_llm_dense_steps`` with its
``dp_axes``, the pod step with ("data",) where the mesh has it), where
the MoE layers run expert-parallel over ``model``: the clients' and the
student's experts are then this rank's rows
(``launch/shardings.local_params``), and Adam steps the student's where
they are.
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


def ensemble_lm_logits(client_cfgs, client_params, embeds: torch.Tensor, *,
                       mesh=None, dp_axes: tuple = ()):
    """D(x̂): the clients' logits over ``embeds`` (B, S, D), float32,
    averaged; (B, S, V). ``mesh`` and ``dp_axes`` reach every client's
    MoE layers (``transformer.forward``)."""
    acc = None
    for cfg, idx in group_lm_clients(client_cfgs):
        group_sum = None
        for i in idx:
            lg, _ = T.forward(client_params[i], cfg, embeds=embeds,
                              mesh=mesh, dp_axes=dp_axes, remat=False)
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
                         mesh=None, dp_axes: tuple = (),
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
    the reference's do. ``mesh`` and ``dp_axes`` reach every forward (on
    a mesh with a ``model`` axis the clients and the student hold this
    rank's expert rows)."""
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
        avg = ensemble_lm_logits(client_cfgs, cparams, embeds, mesh=mesh,
                                 dp_axes=dp_axes)
        stu, _ = T.forward(_frozen(student_params), student_cfg,
                           embeds=embeds, mesh=mesh, dp_axes=dp_axes,
                           remat=False)
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
            avg = ensemble_lm_logits(client_cfgs, client_params, embeds,
                                     mesh=mesh, dp_axes=dp_axes)
        stu, _ = T.forward(student_params, student_cfg, embeds=embeds,
                           mesh=mesh, dp_axes=dp_axes, remat=False)
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


# ------------------------------------------------- the pod distillation cell

def pod_stack_specs(param_specs_tree, mesh):
    """The stacked client params' specs: the per-client Megatron specs
    (``launch/shardings.param_specs``) with the leading client dim over
    ``pod`` on a multi-pod mesh, replicated on one pod
    (``fl.sharding.stack_specs``; the CNN path names the same axis
    "clients")."""
    from repro_torch.fl.sharding import stack_specs
    from repro_torch.launch.mesh import axis_names

    axis = "pod" if mesh is not None and "pod" in axis_names(mesh) else None
    return stack_specs(param_specs_tree, axis)


def make_pod_distill_step(cfg, mesh=None, *, n_clients: int,
                          s_lr: float = 1e-4, chunked_kl: bool = False,
                          kl_chunk: int = 64,
                          distill_kl_mode: str | None = None,
                          kernel_vjp_mode: str | None = None,
                          policy=None, device=None, specs=None):
    """DENSE stage-2 distillation against a homogeneous client stack
    (module doc). Returns ``distill_step(stu_state, stacked, embeds) ->
    (stu_state, {"dis_loss"})``: ``stu_state`` is {"params", "opt",
    "step"} (``distill_step.make_state(params)`` makes one with Adam at
    ``s_lr``, as the reference's step owns its optimizer), ``stacked``
    the clients' params tree with a leading dim of this rank's clients
    (all ``n_clients`` on one pod), ``embeds`` (B, S, D). It takes one
    Adam step of the student in place and returns the loss before it.

    ``mesh``: None or a mesh; with a ``pod`` axis of size > 1 the
    teacher's mean is all-reduced over it, and every forward takes the
    mesh with ("data",) where it has that axis (the MoE layers
    expert-parallel over ``model``, as in ``make_llm_dense_steps``).
    ``distill_kl_mode`` routes the materialized route's KL and
    ``kernel_vjp_mode`` the trunk (defaults: the policy's, on ``device``
    or the mesh's device type); "autodiff" cannot train and is
    refused. ``specs``: (the student state's spec tree, the stack's
    ``pod_stack_specs``, the embeddings' spec), the reference's
    ``in_shardings``; ``make_state`` then cuts the student and the step
    takes this rank's shards of the stack and rows of ``embeds`` (module
    doc)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.launch.mesh import axis_names, axis_size, sum_over

    if device is None:
        device = getattr(mesh, "device_type", "cuda")
    pol = resolve_exec_policy(policy, device=device)
    kl_mode = pol.distill_kl if distill_kl_mode is None else distill_kl_mode
    vjp_mode = pol.kernel_vjp if kernel_vjp_mode is None else kernel_vjp_mode
    check_kl_mode(kl_mode)
    check_kernel_vjp_mode(vjp_mode)
    _reject_autodiff_mode(vjp_mode)
    check_llm_dense_arch(cfg)
    cfg = cfg.replace(kernel_vjp_mode=vjp_mode)
    pods = axis_size(mesh, "pod") if mesh is not None else 1
    dp = tuple(a for a in ("data",) if mesh is not None
               and a in axis_names(mesh))
    lay = part = None
    rows_over = 1
    if specs is not None:
        from repro_torch.launch import shardings as SH
        from repro_torch.launch import steps as ST

        pspecs, zspecs = ST.split_state_specs(specs[0])
        bat = ST.batch_axes_of(specs[2])
        lay = SH.Layout(cfg, mesh, pspecs)
        part = ST.Partitioned(cfg, mesh, pspecs, zspecs, bat)
        for a in part.batch_axes:
            rows_over *= axis_size(mesh, a)

    def global_mean(total, rows: int):
        """The mean over every data shard's rows of a sum over this
        rank's."""
        if part is None:
            return total / rows
        return sum_over(total, mesh, part.batch_axes) / (rows * rows_over)

    def pod_mean(total):
        """Σ over this rank's clients → the mean over all of them."""
        if pods > 1:
            import torch.distributed as dist
            dist.all_reduce(total, group=mesh.get_group("pod"))
        return total / n_clients

    def client_outputs(stacked, embeds, hidden: bool):
        """Each local client's logits (float32) or hidden states, in
        client order, without autograd."""
        n = next(iter(T.leaves(stacked))).shape[0]
        with torch.no_grad():
            for i in range(n):
                out, _ = T.forward(T.layer(stacked, i), cfg, embeds=embeds,
                                   mesh=mesh, dp_axes=dp, remat=False,
                                   return_hidden=hidden, tp=lay)
                yield out if hidden else out.float()

    def loss_materialized(sp, stacked, embeds):
        total = None
        for lg in client_outputs(stacked, embeds, hidden=False):
            total = lg if total is None else total + lg
        avg = pod_mean(total)
        stu, _ = T.forward(sp, cfg, embeds=embeds, mesh=mesh, dp_axes=dp,
                           remat=True, tp=lay)
        v = avg.shape[-1]
        # the teacher is constant: skip the kernel's dL/dt stream
        kl = LS.softmax_kl(avg.reshape(-1, v), stu.float().reshape(-1, v),
                           mode=kl_mode, with_teacher_grad=False, tp=lay)
        return global_mean(kl.sum(), kl.shape[0])

    def chunk_kl(sh_c, s_tbl, t_tbl, *th_c):
        """Σ over a chunk's tokens of KL(teacher mean ‖ student), the
        readouts through the embedding tables: the teachers' in float32,
        the student's in its dtype, as the reference computes them."""
        with torch.no_grad():
            t_lg = None
            for i, h in enumerate(th_c):
                lg = h.float() @ t_tbl[i].float().T
                t_lg = lg if t_lg is None else t_lg + lg
            t_lg = pod_mean(t_lg)
        if lay is not None and lay.vocab:
            sh_c = lay.enter(sh_c)
        s_lg = sh_c @ s_tbl.to(sh_c.dtype).T
        v = s_lg.shape[-1]
        return torch.sum(LS.softmax_kl(t_lg.reshape(-1, v),
                                       s_lg.float().reshape(-1, v), tp=lay))

    def loss_chunked(sp, stacked, embeds):
        th = list(client_outputs(stacked, embeds, hidden=True))
        sh, _ = T.forward(sp, cfg, embeds=embeds, mesh=mesh, dp_axes=dp,
                          remat=True, return_hidden=True, tp=lay)
        B, S, _ = sh.shape
        if S % kl_chunk:
            raise ValueError(f"chunked_kl needs kl_chunk ({kl_chunk}) to "
                             f"divide the sequence ({S})")
        t_tbl = stacked["embed"]["table"]
        s_tbl = sp["embed"]["table"]
        tot = None
        for c0 in range(0, S, kl_chunk):
            sl = slice(c0, c0 + kl_chunk)
            kl = checkpoint(chunk_kl, sh[:, sl], s_tbl, t_tbl,
                            *(h[:, sl] for h in th), use_reentrant=False,
                            preserve_rng_state=False)
            tot = kl if tot is None else tot + kl
        return global_mean(tot, B * S)

    loss_impl = loss_chunked if chunked_kl else loss_materialized

    def distill_step(stu_state, stacked, embeds):
        opt, params = stu_state["opt"], stu_state["params"]
        if part is not None:
            part.check(params)
        tensors = T.leaves(params)
        loss = loss_impl(params, _frozen(stacked), embeds)
        grads = torch.autograd.grad(loss, tensors)
        opt.step(grads if part is None else part.reduce(grads))
        if part is not None:
            part.gather(tensors, opt.params)
        stu_state["step"] += 1
        return stu_state, {"dis_loss": loss.detach()}

    def make_state(params: dict) -> dict:
        if part is not None:
            params = SH.local_params(params, cfg, mesh, part.pspecs)
        tensors = T.leaves(params)
        for t in tensors:
            t.requires_grad_(True)
        targets = tensors if part is None else part.targets(tensors)
        return {"params": params, "opt": optim.adam(targets, s_lr),
                "step": 0}

    distill_step.make_state = make_state
    return distill_step
