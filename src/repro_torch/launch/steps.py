"""Step functions shared by the entry points (``repro/launch/steps.py``): the
LM train state and step (``:17-49``), used by ``launch/train.py`` and
the LLM DENSE clients, the pod distillation step (``:52-66``), and the
prefill and decode steps against a dense cache (``:69,84``), the serving
engine's dense mode and the sequential oracle its paged mode is held
to.

Each step takes the reference's ``mesh`` (``launch/mesh.make_host_mesh``)
and passes it, with its data-parallel axes (``dp_axes_of``), to the
trunk, where the MoE layers alone read it (expert parallelism over
``model``). On such a mesh the train state holds this rank's expert rows
(``launch/shardings.local_params``), Adam steps them where they are, and
the global-norm clip sums the expert rows' squares over ``model`` and
counts each replicated parameter once, the norm of the full tree, as the
reference's clip sees it.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import axis_size, dp_axes_of, sum_over
from repro_torch.models import transformer as T


def _dp(mesh) -> tuple:
    return dp_axes_of(mesh) if mesh is not None else ()


def make_train_state(cfg, *, lr: float = 3e-4, seed: int = 0,
                     params: dict | None = None, device="cuda",
                     mesh=None) -> dict:
    """{"params", "opt", "step"}: ``params`` (default: ``init_model`` from
    ``seed`` on ``device``), on a mesh cut to this rank's expert rows
    (``shardings.local_params``), made trainable in place, and Adam at
    ``lr`` over them (float32 moments, as the reference keeps them).
    Every family trains, as in the reference."""
    if params is None:
        params = T.init_model(cfg, seed=seed, device=device)
    params = SH.local_params(params, cfg, mesh)
    tensors = T.leaves(params)
    for t in tensors:
        t.requires_grad_(True)
    return {"params": params, "opt": optim.adam(tensors, lr), "step": 0}


def _clip(grads, experts: list, mesh, clip: float):
    """``optim.clip_by_global_norm`` over the full tree: the expert rows'
    squares summed over ``model``, each replicated gradient once. With
    one model rank, or no expert rows, the plain clip itself."""
    if mesh is None or axis_size(mesh, SH.MP) == 1 or not any(experts):
        return optim.clip_by_global_norm(grads, clip)

    def squares(ts):
        return sum(torch.sum(t.float() ** 2) for t in ts)

    with torch.no_grad():
        local = squares(g for g, e in zip(grads, experts) if e)
        n = torch.sqrt(squares(g for g, e in zip(grads, experts) if not e)
                       + sum_over(local, mesh, SH.MP))
    scale = torch.clamp(clip / torch.clamp(n, min=1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], n


def make_train_step(cfg, mesh=None, *, clip: float = 1.0):
    """``train_step(state, batch) -> (state, metrics)``: the gradient of
    ``loss_fn`` over ``batch`` ({"tokens", "labels"} (B, S), optional
    "mask"), clipped to global norm ``clip``, one Adam step of the
    state's optimizer (its learning rate is the state's), in place.
    Metrics are 0-d tensors: loss, ce, moe_aux and grad_norm (before
    clipping). A vlm's batch carries "vision" (B, n_patches,
    vision_dim). On ``mesh`` the state holds this rank's expert rows
    (``make_train_state(..., mesh=)``)."""
    dp = _dp(mesh)

    def train_step(state, batch):
        opt = state["opt"]
        loss, parts = T.loss_fn(state["params"], cfg, batch, mesh=mesh,
                                dp_axes=dp)
        grads, gnorm = _clip(torch.autograd.grad(loss, opt.params),
                             SH.expert_mask(state["params"]), mesh, clip)
        opt.step(grads)
        state["step"] += 1
        return state, {"loss": loss.detach(), "ce": parts["ce"].detach(),
                       "moe_aux": parts["moe_aux"].detach(),
                       "grad_norm": gnorm}

    return train_step


def make_distill_step(cfg, mesh=None, *, n_clients: int, **kw):
    """The LLM student step against a homogeneous client stack: DENSE's
    stage 2 at paper scale, ``core/dense_llm.make_pod_distill_step``,
    routed through this module as the reference routes every step.
    Keywords (``s_lr``, ``chunked_kl``, ``kl_chunk``,
    ``distill_kl_mode``, ``kernel_vjp_mode``, ``policy``, ``device``)
    are passed on as they are; unpinned modes take the policy's."""
    from repro_torch.core import dense_llm as DL
    return DL.make_pod_distill_step(cfg, mesh, n_clients=n_clients, **kw)


def make_prefill_step(cfg, mesh=None):
    dp = _dp(mesh)

    def prefill_step(params, cache, tokens, vision=None):
        """tokens: (B, S) from position 0 into ``cache`` (a vlm attends
        over ``vision``); returns the last position's logits (B, 1, V)
        and the filled cache."""
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        logits, cache = T.forward(params, cfg, tokens=tokens,
                                  positions=positions, cache=cache,
                                  cache_pos=0, vision=vision, mesh=mesh,
                                  dp_axes=dp)
        return logits[:, -1:], cache

    return prefill_step


def make_serve_step(cfg, mesh=None):
    """One decode step: a single new token against a pre-filled cache
    (the mamba blocks' one-token step, ``decode=True``)."""
    dp = _dp(mesh)

    def serve_step(params, cache, tokens, pos: int, vision=None):
        positions = torch.tensor([pos], dtype=torch.int32,
                                 device=tokens.device)
        return T.forward(params, cfg, tokens=tokens, positions=positions,
                         cache=cache, cache_pos=pos, vision=vision,
                         mesh=mesh, dp_axes=dp, decode=True)

    return serve_step
