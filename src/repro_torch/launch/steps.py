"""Step functions shared by the entry points (``repro/launch/steps.py``): the
LM train state and step (``:17-49``), used by ``launch/train.py`` and
the LLM DENSE clients, the pod distillation step (``:52-66``), and the
prefill and decode steps against a dense cache (``:69,84``), the serving
engine's dense mode and the sequential oracle its paged mode is held
to.

Each step takes the reference's ``mesh`` (``launch/mesh.make_host_mesh``)
and, two ways:

  * without ``specs`` (the run-time drivers, as the reference's): the
    trunk gets the mesh and its data-parallel axes (``dp_axes_of``),
    which the MoE layers alone read (expert parallelism over ``model``).
    The train state holds this rank's expert rows
    (``launch/shardings.local_params``), Adam steps them where they are,
    and the global-norm clip sums the expert rows' squares over
    ``model`` and counts each replicated parameter once;
  * with ``specs``, the spec trees the reference's dry run jits the step
    with (``in_shardings``; ``launch/dryrun.py`` builds them): every tree
    is this rank's shards (``shardings.local_tree``), the trunk runs
    partitioned (``shardings.Layout``, ``models/*``' ``tp``), the batch is
    this rank's rows of the one ``batch_specs`` cuts and the loss is the
    mean over the whole batch. Each gradient is summed over the axes the
    batch is cut over, except a ZeRO-1 leaf's (``zero1_specs`` names
    ``data`` on one of its dims): it is reduce-scattered over ``data``,
    Adam steps that slice of the parameter and its moments, and the
    slice is all-gathered back. The clip counts each leaf's squares once
    over the axes its gradient is cut on. A params tree whose shapes are
    not its shards raises.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import (axis_size, dp_axes_of, gather_dim,
                                     reduce_scatter_over, sum_over)
from repro_torch.models import transformer as T


def _dp(mesh) -> tuple:
    return dp_axes_of(mesh) if mesh is not None else ()


class Partitioned:
    """A partitioned state's data-parallel bookkeeping: per parameter
    leaf (``transformer.leaves`` order) its spec, its ZeRO-1 dim (the dim
    ``zero1_specs`` adds ``data`` on, or None) and the axes the batch is
    cut over (``batch_axes``)."""

    def __init__(self, cfg, mesh, pspecs, zspecs, batch_axes: tuple):
        from repro_torch.launch.specs import abstract_params

        self.mesh, self.pspecs = mesh, pspecs
        self.full = abstract_params(cfg)
        self.batch_axes = tuple(a for a in batch_axes
                                if axis_size(mesh, a) > 1)
        self.specs, self.zdims = [], []
        for (_, p), (_, z) in zip(SH.leaf_paths(pspecs),
                                  SH.leaf_paths(zspecs), strict=True):
            self.specs.append(p)
            zd = [d for d, (a, b) in enumerate(zip(
                SH.dim_axes(p, len(z)), SH.dim_axes(z, len(z)))) if a != b]
            self.zdims.append(zd[0] if zd and axis_size(mesh, "data") > 1
                              else None)

    def check(self, params) -> None:
        SH.check_tree(params, self.pspecs, self.mesh, self.full,
                      what="params")

    def _slice(self, t, zd: int):
        """This rank's ``data`` slice of ``t``'s dim ``zd`` (a view)."""
        rows = t.shape[zd] // axis_size(self.mesh, "data")
        return t.narrow(zd, self.mesh.get_local_rank("data") * rows, rows)

    def targets(self, tensors) -> list:
        """What Adam steps: each leaf, or for a ZeRO-1 leaf this rank's
        ``data`` slice of it (a view that shares its storage)."""
        return [t.detach() if zd is None else self._slice(t.detach(), zd)
                for t, zd in zip(tensors, self.zdims, strict=True)]

    @torch.no_grad()
    def reduce(self, grads) -> list:
        """Each gradient summed over the batch axes; a ZeRO-1 one's over
        those but ``data``, then reduce-scattered over ``data`` (or cut to
        this rank's slice where the batch is not cut over ``data``)."""
        out = []
        for g, zd in zip(grads, self.zdims, strict=True):
            if zd is None:
                out.append(sum_over(g, self.mesh, self.batch_axes)
                           if self.batch_axes else g)
                continue
            rest = tuple(a for a in self.batch_axes if a != "data")
            if rest:
                g = sum_over(g, self.mesh, rest)
            out.append(reduce_scatter_over(g, self.mesh, "data", zd)
                       if "data" in self.batch_axes else self._slice(g, zd))
        return out

    def cut_axes(self) -> list:
        """Per leaf the axes its reduced gradient is cut over."""
        return [SH.spec_axes(p) + (("data",) if zd is not None else ())
                for p, zd in zip(self.specs, self.zdims)]

    @torch.no_grad()
    def gather(self, tensors, targets) -> None:
        """Each ZeRO-1 leaf's stepped slice all-gathered over ``data``
        back into the whole parameter."""
        for t, v, zd in zip(tensors, targets, self.zdims, strict=True):
            if zd is not None:
                t.detach().copy_(gather_dim(v, self.mesh, "data", zd))


def split_state_specs(specs):
    """(params, ZeRO-1 moments) specs of a train state's spec tree."""
    return specs["params"], specs["opt"]["m"]


def batch_axes_of(spec) -> tuple:
    """The axes a batch spec's leading dim is cut over."""
    return SH.dim_axes(spec, max(len(spec), 1))[0]


def make_train_state(cfg, *, lr: float = 3e-4, seed: int = 0,
                     params: dict | None = None, device="cuda",
                     mesh=None, specs=None) -> dict:
    """{"params", "opt", "step"}: ``params`` (default: ``init_model`` from
    ``seed`` on ``device``), on a mesh cut to this rank's expert rows
    (``shardings.local_params``) or, with ``specs`` (the state's spec
    tree, ``{"params", "opt": {"m", "v", "t"}, "step"}`` as the
    reference's dry run builds it), to this rank's shards of every leaf
    (leaves already cut stay as they are), made trainable in place, and
    Adam at ``lr`` over them (float32 moments, as the reference keeps
    them; a ZeRO-1 leaf's moments and update this rank's ``data``
    slice). Every family trains, as in the reference."""
    if params is None:
        params = T.init_model(cfg, seed=seed, device=device)
    if specs is None:
        params = SH.local_params(params, cfg, mesh)
        targets = T.leaves(params)
    else:
        pspecs, zspecs = split_state_specs(specs)
        params = SH.local_params(params, cfg, mesh, pspecs)
        part = Partitioned(cfg, mesh, pspecs, zspecs, ())
        targets = part.targets(T.leaves(params))
    for t in T.leaves(params):
        t.requires_grad_(True)
    return {"params": params, "opt": optim.adam(targets, lr), "step": 0}


def _clip(grads, cut_axes: list, mesh, clip: float):
    """``optim.clip_by_global_norm`` over the full tree: each leaf's
    squares summed over the axes it is cut on (``cut_axes``, a tuple a
    leaf), so every entry of the whole tree counts once. With nothing
    cut, the plain clip itself."""
    groups: dict = {}
    for g, axes in zip(grads, cut_axes, strict=True):
        axes = tuple(a for a in axes
                     if mesh is not None and axis_size(mesh, a) > 1)
        groups.setdefault(axes, []).append(g)
    if list(groups) in ([], [()]):
        return optim.clip_by_global_norm(grads, clip)

    def squares(ts):
        return sum(torch.sum(t.float() ** 2) for t in ts)

    with torch.no_grad():
        n = torch.sqrt(sum(sum_over(squares(gs), mesh, axes) if axes
                           else squares(gs) for axes, gs in groups.items()))
    scale = torch.clamp(clip / torch.clamp(n, min=1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], n


def make_train_step(cfg, mesh=None, *, clip: float = 1.0, specs=None):
    """``train_step(state, batch) -> (state, metrics)``: the gradient of
    ``loss_fn`` over ``batch`` ({"tokens", "labels"} (B, S), optional
    "mask"), clipped to global norm ``clip``, one Adam step of the
    state's optimizer (its learning rate is the state's), in place.
    Metrics are 0-d tensors: loss, ce, moe_aux and grad_norm (before
    clipping). A vlm's batch carries "vision" (B, n_patches,
    vision_dim). On ``mesh`` the state holds this rank's expert rows
    (``make_train_state(..., mesh=)``). ``specs``: (the state's spec
    tree, the batch's), the reference's ``in_shardings``; the state from
    ``make_train_state(..., specs=)`` and the batch this rank's rows of
    it (module doc)."""
    if specs is None:
        dp = _dp(mesh)

        def train_step(state, batch):
            opt = state["opt"]
            loss, parts = T.loss_fn(state["params"], cfg, batch, mesh=mesh,
                                    dp_axes=dp)
            grads, gnorm = _clip(
                torch.autograd.grad(loss, opt.params),
                [(SH.MP,) if e else () for e in
                 SH.expert_mask(state["params"])], mesh, clip)
            opt.step(grads)
            state["step"] += 1
            return state, {"loss": loss.detach(),
                           "ce": parts["ce"].detach(),
                           "moe_aux": parts["moe_aux"].detach(),
                           "grad_norm": gnorm}

        return train_step

    state_specs, bspecs = specs
    pspecs, zspecs = split_state_specs(state_specs)
    bat = batch_axes_of(bspecs["tokens"])
    part = Partitioned(cfg, mesh, pspecs, zspecs, bat)
    lay = SH.Layout(cfg, mesh, pspecs)
    cut = part.cut_axes()

    def partitioned_step(state, batch):
        part.check(state["params"])
        opt, tensors = state["opt"], T.leaves(state["params"])
        loss, parts = T.loss_fn(state["params"], cfg, batch, tp=lay,
                                batch_axes=bat)
        grads = part.reduce(torch.autograd.grad(loss, tensors))
        grads, gnorm = _clip(grads, cut, mesh, clip)
        opt.step(grads)
        part.gather(tensors, opt.params)
        state["step"] += 1
        return state, {"loss": loss.detach(), "ce": parts["ce"].detach(),
                       "moe_aux": parts["moe_aux"].detach(),
                       "grad_norm": gnorm}

    return partitioned_step


def make_distill_step(cfg, mesh=None, *, n_clients: int, **kw):
    """The LLM student step against a homogeneous client stack: DENSE's
    stage 2 at paper scale, ``core/dense_llm.make_pod_distill_step``,
    routed through this module as the reference routes every step.
    Keywords (``s_lr``, ``chunked_kl``, ``kl_chunk``,
    ``distill_kl_mode``, ``kernel_vjp_mode``, ``policy``, ``device``)
    are passed on as they are; unpinned modes take the policy's."""
    from repro_torch.core import dense_llm as DL
    return DL.make_pod_distill_step(cfg, mesh, n_clients=n_clients, **kw)


def _serve_layout(cfg, mesh, specs):
    """(Layout, the params check) of a prefill or decode step's specs
    (params, cache, tokens, ...), or (None, None) without."""
    if specs is None:
        return None, None
    from repro_torch.launch.specs import abstract_params

    pspecs, cspecs = specs[0], specs[1]
    full = abstract_params(cfg)

    def check(params):
        SH.check_tree(params, pspecs, mesh, full, what="params")

    return SH.Layout(cfg, mesh, pspecs, cspecs), check


def _full_vocab(logits, lay, mesh):
    """Logits gathered over ``model`` where they are this rank's
    vocabulary columns."""
    if lay is None or not lay.vocab:
        return logits
    return gather_dim(logits, mesh, SH.MP, logits.dim() - 1)


def make_prefill_step(cfg, mesh=None, *, specs=None):
    """``prefill_step(params, cache, tokens, vision=None)``. ``specs``:
    (params, cache, tokens[, vision]) spec trees, the reference's
    ``in_shardings``: every argument this rank's shards of it, the trunk
    partitioned (module doc)."""
    dp = _dp(mesh)
    lay, check = _serve_layout(cfg, mesh, specs)

    def prefill_step(params, cache, tokens, vision=None):
        """tokens: (B, S) from position 0 into ``cache`` (a vlm attends
        over ``vision``); returns the last position's logits (B, 1, V)
        and the filled cache."""
        if check is not None:
            check(params)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        logits, cache = T.forward(params, cfg, tokens=tokens,
                                  positions=positions, cache=cache,
                                  cache_pos=0, vision=vision, mesh=mesh,
                                  dp_axes=dp, tp=lay)
        return _full_vocab(logits[:, -1:], lay, mesh), cache

    return prefill_step


def make_serve_step(cfg, mesh=None, *, specs=None):
    """One decode step: a single new token against a pre-filled cache
    (the mamba blocks' one-token step, ``decode=True``). ``specs``:
    (params, cache, tokens, pos[, vision]), as ``make_prefill_step``
    takes them; ``pos`` is a Python int."""
    dp = _dp(mesh)
    lay, check = _serve_layout(cfg, mesh, specs)

    def serve_step(params, cache, tokens, pos: int, vision=None):
        if check is not None:
            check(params)
        positions = torch.tensor([pos], dtype=torch.int32,
                                 device=tokens.device)
        logits, cache = T.forward(params, cfg, tokens=tokens,
                                  positions=positions, cache=cache,
                                  cache_pos=pos, vision=vision, mesh=mesh,
                                  dp_axes=dp, decode=True, tp=lay)
        return _full_vocab(logits, lay, mesh), cache

    return serve_step
