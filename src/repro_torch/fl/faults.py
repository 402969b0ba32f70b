"""Seeded upload faults: the injection half of the fault-tolerant one-shot
round (``repro/fl/faults.py``; DESIGN.md §10).

DENSE's single upload cannot be retried, so a client whose upload never
arrives, arrives corrupted (NaN/Inf) or arrives adversarially perturbed
(scaled noise, sign flip) must not take the round down with it. This
module applies a per-client fault plan at the upload boundary;
``fl.protocol.admit_uploads`` is the defense (screens, quarantine,
quorum).

Fault kinds (``FAULT_KINDS``): ``drop`` (the upload never arrives),
``delay`` (it arrives one round late: multi-round only; in a one-shot
round it is a drop), ``nan``/``inf`` (a seeded fraction of every tensor
overwritten), ``noise`` (+ scale·σ·N(0, 1) per tensor, caught by the
norm screen) and ``signflip`` (every tensor negated: norm-preserving,
caught by the opt-in cosine screen).

An upload is a client's ``CNN``: every tensor of its ``state_dict``,
BatchNorm running statistics included, as the reference's parameter
tree holds them. The plan is a pure function of ``(scfg.fault_plan,
scfg.dropout_frac, scfg.fault_seed, round)`` drawn with numpy, so it is
the reference's plan bit for bit. The corruption draws from a
``torch.Generator`` on the upload's device, seeded from the round's
fault seed and the client index (the reference folds the client index
into a ``jax.random`` key): the same kinds and rates, other bits. The
tests inject the reference's corrupted uploads through ``corrupt``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.models.cnn import CNN, cnn_view, stack_models

FAULT_KINDS = ("drop", "delay", "nan", "inf", "noise", "signflip")

# fraction of each tensor's elements overwritten by nan/inf corruption
# (at least one element a tensor, so a one-element tensor is still hit)
_CORRUPT_FRAC = 0.01


@dataclass(frozen=True)
class Fault:
    """One planned upload fault: ``client``'s round-``round`` upload."""
    client: int
    kind: str
    scale: float = 10.0            # noise multiplier (kind="noise" only)
    round: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {FAULT_KINDS})")


def normalize_plan(plan) -> tuple[Fault, ...]:
    """``Fault`` instances or (client, kind[, scale[, round]]) tuples, the
    form a frozen config can hold."""
    return tuple(f if isinstance(f, Fault) else Fault(*f)
                 for f in plan or ())


def build_fault_plan(scfg, *, round: int = 0,
                     n_clients: int | None = None) -> dict[int, Fault]:
    """One round's plan: the explicit ``scfg.fault_plan`` entries of that
    round plus ``round(dropout_frac · m)`` seeded drops, drawn with
    ``np.random.default_rng(fault_seed + round)`` among the clients the
    explicit plan leaves free."""
    m = n_clients if n_clients is not None else scfg.n_clients
    plan = {f.client: f
            for f in normalize_plan(getattr(scfg, "fault_plan", ()))
            if f.round == round}
    for i in plan:
        if not 0 <= i < m:
            raise ValueError(f"fault_plan client {i} out of range for "
                             f"m={m}")
    frac = float(getattr(scfg, "dropout_frac", 0.0))
    if frac:
        if not 0.0 <= frac < 1.0:
            raise ValueError(f"dropout_frac must be in [0, 1), got {frac}")
        rng = np.random.default_rng(
            int(getattr(scfg, "fault_seed", 0)) + round)
        free = [i for i in range(m) if i not in plan]
        k = min(len(free), int(np.round(frac * m)))
        for i in rng.choice(len(free), size=k, replace=False):
            plan[free[int(i)]] = Fault(client=free[int(i)], kind="drop",
                                       round=round)
    return plan


def fault_seed(scfg, round: int) -> int:
    """The seed of one round's corruption (the reference's fault key,
    ``PRNGKey(fault_seed · 7919 + round)``)."""
    return int(getattr(scfg, "fault_seed", 0)) * 7919 + round


@torch.no_grad()
def corrupt_params(model: CNN, kind: str, *, generator: torch.Generator,
                   scale: float = 10.0) -> CNN:
    """A corrupted copy of one upload: a new ``CNN`` on the model's device
    (``generator`` lives there too), the upload left as it is."""
    state = model.net.state_dict()
    out = {}
    for name, a in state.items():
        if kind == "signflip":
            out[name] = -a
        elif kind == "noise":
            a32 = a.float()
            sigma = a32.std(correction=0) + 1e-8
            out[name] = (a32 + scale * sigma * torch.randn(
                a.shape, generator=generator, device=a.device)).to(a.dtype)
        elif kind in ("nan", "inf"):
            u = torch.rand(a.shape, generator=generator, device=a.device)
            hit = u < max(_CORRUPT_FRAC, 1.0 / max(a.numel(), 1))
            out[name] = a.float().masked_fill(
                hit, float(kind)).to(a.dtype)
        else:
            raise ValueError(f"corrupt_params cannot apply kind {kind!r}")
    return cnn_view(model.spec, {k: v.clone() for k, v in out.items()})


def rebuild_clients(clients, new_models: Sequence[CNN]):
    """The federation with client i's upload replaced by
    ``new_models[i]``: a ``ClientList`` whose untouched groups keep
    their stack as it is (no restack) and whose changed groups are
    stacked anew from the new models."""
    from repro_torch.core.ensemble import Client, group_clients
    from repro_torch.fl.federation import ClientList

    rebuilt = [Client(spec=c.spec, model=new_models[i], n_data=c.n_data,
                      class_counts=c.class_counts)
               for i, c in enumerate(clients)]
    pre = getattr(clients, "grouped", None)
    gspecs, gparams = [], []
    for gi, (spec, idx) in enumerate(group_clients(clients)):
        gspecs.append((spec, len(idx)))
        changed = any(new_models[i] is not clients[i].model for i in idx)
        if pre is not None and not changed:
            gparams.append(pre[1][gi])
        elif len(idx) == 1:
            gparams.append(new_models[idx[0]])
        else:
            gparams.append(stack_models([new_models[i] for i in idx]))
    return ClientList(rebuilt, gspecs, gparams)


def apply_upload_faults(clients, plan: dict[int, Fault], *, seed: int,
                        ledger=None, upload_tag: str = "round0-model-upload",
                        pending: dict | None = None,
                        corrupt: Callable | None = None):
    """Apply one round's plan at the upload boundary. Returns
    ``(clients, arrived, delayed)``: the federation with corrupted
    uploads substituted, an (m,) bool array (False where the upload did
    not land this round: drop, delay) and {client: model} held back by
    ``delay`` faults for the next round.

    ``pending`` (the previous round's delayed uploads) land now as those
    clients' uploads. ``corrupt(i, model, fault) -> CNN``, when given,
    replaces the seeded corruption (the tests inject the reference's);
    by default client i's draws come from a generator on its device
    seeded ``seed · 100003 + i``.

    Ledger: exactly one ``up`` event a client a round, ``delivered``
    (counted in ``uplink_bytes``), ``dropped`` or ``delayed``; admission
    adds zero-byte ``rejected`` markers later."""
    from repro_torch.fl.protocol import param_bytes

    m = len(clients)
    arrived = np.ones(m, bool)
    delayed: dict[int, CNN] = {}
    new_models = [c.model for c in clients]
    for i, fault in sorted(plan.items()):
        model = clients[i].model
        if fault.kind in ("drop", "delay"):
            arrived[i] = False
            if fault.kind == "delay":
                delayed[i] = model
            if ledger is not None:
                ledger.record("up", f"client{i}", param_bytes(model),
                              upload_tag, kind="dropped"
                              if fault.kind == "drop" else "delayed")
        elif corrupt is not None:
            new_models[i] = corrupt(i, model, fault)
        else:
            dev = next(model.parameters()).device
            gen = torch.Generator(device=dev).manual_seed(
                seed * 100003 + i)
            new_models[i] = corrupt_params(model, fault.kind, generator=gen,
                                           scale=fault.scale)
    for i, stale in (pending or {}).items():
        new_models[i] = stale                  # last round's upload lands
        arrived[i] = True
    if ledger is not None:
        for i in range(m):
            if arrived[i]:
                ledger.record("up", f"client{i}",
                              param_bytes(new_models[i]), upload_tag)
    if any(new_models[i] is not clients[i].model for i in range(m)):
        clients = rebuild_clients(clients, new_models)
    return clients, arrived, delayed


__all__ = ["FAULT_KINDS", "Fault", "normalize_plan", "build_fault_plan",
           "fault_seed", "corrupt_params", "apply_upload_faults",
           "rebuild_clients"]
