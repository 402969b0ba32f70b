"""The mixture-of-experts layer of the moe family (DeepSeek-V2: shared
experts beside routed top-k ones; ``repro/models/moe.py:27-141``).

``moe_apply`` routes the flat (T, D) token block through every expert
with the reference's capacity-bounded, sort-free dispatch
(``_moe_local``):

  * a float32 router (kept float32 whatever the parameter dtype) gives
    softmax probabilities; each token takes its top-k experts, ties to
    the lower expert index as ``jax.lax.top_k`` breaks them (a stable
    descending sort), and their gates renormalized to sum to 1;
  * the T·k assignments, token-major, take positions in their expert by
    a running count; those at or past the capacity ``_capacity(T)`` are
    dropped, exactly the ones the reference drops;
  * each expert's slots gather their tokens (unfilled slots read a zero
    pad row), run the SwiGLU expert as batched products (``torch.bmm``:
    the reference's einsums run in XLA, outside any Pallas kernel), are
    scaled by their gates and added back to their tokens
    (``index_add_``, whose order of addition is not fixed on the card, so
    card results are held to a tolerance there, never bit for bit);
  * the shared experts, one SwiGLU of width ``n_shared_experts·d_ff_expert``,
    add to every token.

It also returns the switch-style load-balance auxiliary ``E·Σ_e f_e·p_e``
over the full router distribution.

Expert parallelism (``mesh=`` with an ``ep_axis``, ``moe.py:104-141``):
rank (d, m) of a mesh whose ``ep_axis`` has n ranks holds experts
[m·E/n, (m+1)·E/n) (the ``gate``, ``up`` and ``down`` rows that
``launch/shardings.local_params`` cuts) and routes its data coordinate
d's slice of the flat (B·S, D) block over ``dp_axes`` to them, with the
capacity of that slice; assignments to other ranks' experts fall into
the drop bucket. y is summed over ``ep_axis`` and gathered over
``dp_axes``; the auxiliary is each shard's, averaged over
(``*dp_axes``, ``ep_axis``), as the reference's ``pmean``. The
gradients are those of that function (``launch/mesh``'s collectives):
the expert rows' summed over ``dp_axes``, the router's over every axis,
x's over ``ep_axis`` and gathered over ``dp_axes``.

Partitioned (``tp``, a ``launch/shardings.Layout``; the batch already
cut over the data axes by the step): this rank's E/m routed experts as
above, with the capacity of this rank's tokens, and the shared experts'
``gate``/``up`` column- and ``down`` row-sharded; the two partial
outputs are summed over ``model`` together, in one all-reduce, and the
auxiliary is averaged over ``model`` (the step averages it over the
data axes).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as M
from repro_torch.launch.mesh import axis_names, axis_size
from repro_torch.models import layers as L


def moe_init(cfg, *, generator, dtype, lead: tuple = ()) -> dict:
    """Experts stacked (E, d, f) / (E, f, d): gate and up N(0, 1/d),
    down N(0, 1/f), the router (d, E) N(0, 1/d) in float32."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    std = 1.0 / math.sqrt(d)
    p = {"router": {"w": L._normal((*lead, d, e), std, generator,
                                   torch.float32)},
         "gate": L._normal((*lead, e, d, f), std, generator, dtype),
         "up": L._normal((*lead, e, d, f), std, generator, dtype),
         "down": L._normal((*lead, e, f, d), 1.0 / math.sqrt(f), generator,
                           dtype)}
    if cfg.n_shared_experts:
        p["shared"] = L.swiglu_init(d, cfg.n_shared_experts * f,
                                    generator=generator, dtype=dtype,
                                    lead=lead)
    return p


def _capacity(n_tokens: int, cfg) -> int:
    """Slots an expert holds: T·k·capacity_factor / E, rounded up to a
    multiple of 8, at least 8."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def _moe_local(xf, router_w, w_gate, w_up, w_down, *, cfg, capacity: int,
               offset: int = 0):
    """Route xf: (T, D) through the experts [offset, offset + e_local)
    whose weights are ``w_*`` (e_local, ...); assignments to the others
    are dropped. Returns (y (T, D), the partial sum over these experts,
    and the load-balance auxiliary over the full router distribution,
    float32)."""
    T, D = xf.shape
    k, E = cfg.top_k, cfg.n_experts
    e_local = w_gate.shape[0]
    probs = torch.softmax(xf.float() @ router_w.float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / gate.sum(dim=-1, keepdim=True)

    f_e = F.one_hot(idx, E).float().mean(dim=(0, 1))
    aux = E * torch.sum(f_e * probs.mean(dim=0))

    local_e = idx.reshape(-1) - offset                      # (T·k,)
    mine = (local_e >= 0) & (local_e < e_local)
    e_cl = torch.where(mine, local_e, e_local)              # drop bucket
    token_ids = torch.arange(T * k, device=xf.device) // k
    onehot = F.one_hot(e_cl, e_local + 1)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, e_cl[:, None])[:, 0]
    keep = mine & (pos < capacity)
    # slot -> token; unfilled slots point at the zero pad row T. Dropped
    # assignments write a spare slot past the last (no data-dependent
    # shapes: the dry run traces this on fake tensors)
    n_slots = e_local * capacity
    flat = torch.where(keep, e_cl * capacity + pos, n_slots)
    slot_tok = torch.full((n_slots + 1,), T, dtype=torch.long,
                          device=xf.device).index_put_((flat,), token_ids)
    slot_tok = slot_tok[:n_slots].view(e_local, capacity)
    slot_gate = torch.zeros((n_slots + 1,), dtype=xf.dtype,
                            device=xf.device).index_put_(
        (flat,), gate.reshape(-1).to(xf.dtype))
    slot_gate = slot_gate[:n_slots].view(e_local, capacity)

    x_pad = torch.cat([xf, xf.new_zeros((1, D))])
    xd = x_pad[slot_tok]                                    # (e, C, D)
    h = F.silu(torch.bmm(xd, w_gate.to(xf.dtype))) \
        * torch.bmm(xd, w_up.to(xf.dtype))
    out = torch.bmm(h, w_down.to(xf.dtype)) * slot_gate[..., None]
    y = xf.new_zeros((T + 1, D)).index_add_(0, slot_tok.reshape(-1),
                                            out.reshape(-1, D))
    return y[:T], aux


def _moe_sharded(p, xf, cfg, mesh, ep_axis, dp_axes):
    """This rank's shard of the expert-parallel MoE (module doc)."""
    n, E = axis_size(mesh, ep_axis), cfg.n_experts
    if E % n:
        raise ValueError(f"{E} experts do not split over {n} ranks of "
                         f"{ep_axis!r}")
    e_local = E // n
    if p["gate"].shape[0] != e_local:
        raise ValueError(
            f"the expert-parallel MoE takes this rank's {e_local} expert "
            f"rows, got {p['gate'].shape[0]}: cut the parameters with "
            "launch.shardings.local_params")
    dp = 1
    for a in dp_axes:
        dp *= axis_size(mesh, a)
    cap = _capacity(xf.shape[0] // dp, cfg)
    xb = M.replicated_over(M.take_rows(xf, mesh, dp_axes), mesh, ep_axis)
    rw = M.replicated_over(p["router"]["w"], mesh, (*dp_axes, ep_axis))
    w = [M.replicated_over(p[k], mesh, dp_axes) for k in ("gate", "up",
                                                          "down")]
    off = (mesh.get_local_rank(ep_axis) if n > 1 else 0) * e_local
    y, aux = _moe_local(xb, rw, *w, cfg=cfg, capacity=cap, offset=off)
    y = M.gather_over(M.sum_over(y, mesh, ep_axis), mesh, dp_axes)
    aux = M.sum_over(aux, mesh, (*dp_axes, ep_axis)) / (dp * n)
    return y, aux


def _moe_partitioned(p, x, cfg, tp):
    """This rank's share of the routed and shared experts over its
    tokens, summed over ``model`` (module doc)."""
    B, S, D = x.shape
    e_local = tp.local(cfg.n_experts, "n_experts")
    if p["gate"].shape[0] != e_local:
        raise ValueError(f"the partitioned MoE takes this rank's {e_local} "
                         f"expert rows, got {p['gate'].shape[0]}")
    xr = tp.enter(x)
    y, aux = _moe_local(xr.reshape(B * S, D), tp.enter(p["router"]["w"]),
                        p["gate"], p["up"], p["down"], cfg=cfg,
                        capacity=_capacity(B * S, cfg),
                        offset=tp.rank * e_local)
    y = y.reshape(B, S, D)
    if "shared" in p:
        y = y + L.swiglu_partial(p["shared"], xr)
    return tp.sum(y), tp.sum(aux) / tp.m


def moe_apply(p: dict, x: torch.Tensor, cfg, *, mesh=None,
              ep_axis: str = "model", dp_axes: tuple = (), tp=None):
    """x: (B, S, D) -> (y, aux): the routed experts over the B·S tokens
    plus the shared experts. Expert-parallel iff ``mesh`` has
    ``ep_axis`` (module doc); then ``p``'s experts are this rank's
    rows. ``tp``: partitioned (module doc)."""
    if tp is not None:
        return _moe_partitioned(p, x, cfg, tp)
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    if mesh is None or ep_axis not in axis_names(mesh):
        y, aux = _moe_local(xf, p["router"]["w"], p["gate"], p["up"],
                            p["down"], cfg=cfg,
                            capacity=_capacity(xf.shape[0], cfg))
    else:
        y, aux = _moe_sharded(p, xf, cfg, mesh, ep_axis, tuple(dp_axes))
    y = y.reshape(B, S, D)
    if "shared" in p:
        y = y + L.swiglu(p["shared"], x)
    return y, aux
