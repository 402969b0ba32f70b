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
over the full router distribution. The expert-parallel ``mesh=`` path
(``shard_map`` with a ``psum``) is not ported (ROADMAP.md, Queue 1
item 16).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _moe_local(xf, router_w, w_gate, w_up, w_down, *, cfg, capacity: int):
    """Route xf: (T, D) through all E experts. Returns (y (T, D), the
    load-balance auxiliary, float32)."""
    T, D = xf.shape
    k, E = cfg.top_k, cfg.n_experts
    probs = torch.softmax(xf.float() @ router_w.float(), dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / gate.sum(dim=-1, keepdim=True)

    f_e = F.one_hot(idx, E).float().mean(dim=(0, 1))
    aux = E * torch.sum(f_e * probs.mean(dim=0))

    flat_e = idx.reshape(-1)                                # (T·k,)
    token_ids = torch.arange(T * k, device=xf.device) // k
    onehot = F.one_hot(flat_e, E)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = pos < capacity
    # slot -> token; unfilled slots point at the zero pad row T
    slot_tok = torch.full((E, capacity), T, dtype=torch.long,
                          device=xf.device)
    slot_tok[flat_e[keep], pos[keep]] = token_ids[keep]
    slot_gate = torch.zeros((E, capacity), dtype=xf.dtype, device=xf.device)
    slot_gate[flat_e[keep], pos[keep]] = gate.reshape(-1)[keep].to(xf.dtype)

    x_pad = torch.cat([xf, xf.new_zeros((1, D))])
    xd = x_pad[slot_tok]                                    # (E, C, D)
    h = F.silu(torch.bmm(xd, w_gate.to(xf.dtype))) \
        * torch.bmm(xd, w_up.to(xf.dtype))
    out = torch.bmm(h, w_down.to(xf.dtype)) * slot_gate[..., None]
    y = xf.new_zeros((T + 1, D)).index_add_(0, slot_tok.reshape(-1),
                                            out.reshape(-1, D))
    return y[:T], aux


def moe_apply(p: dict, x: torch.Tensor, cfg, *, mesh=None):
    """x: (B, S, D) -> (y, aux): the routed experts over the B·S tokens
    plus the shared experts."""
    if mesh is not None:
        raise NotImplementedError(
            "the expert-parallel (mesh-sharded) MoE is not ported yet "
            "(ROADMAP.md, Queue 1 item 16)")
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    y, aux = _moe_local(xf, p["router"]["w"], p["gate"], p["up"], p["down"],
                        cfg=cfg, capacity=_capacity(xf.shape[0], cfg))
    y = y.reshape(B, S, D)
    if "shared" in p:
        y = y + L.swiglu(p["shared"], x)
    return y, aux
