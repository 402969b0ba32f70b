"""The client ensemble (Eq. 1: average logits; ``repro/core/ensemble.py``).

Averaging logits, never parameters, is what lets DENSE take clients of
different architectures. Two paths compute it:

  * ``ensemble_logits`` — one forward per client, in eval mode: the
    looped reference path, kept as the port's oracle.
  * ``grouped_ensemble_logits`` — the path every server step takes:
    clients are grouped by ``CNNSpec`` (``group_clients``), each group's
    weights are stacked once at setup (``stack_grouped``) and a group of
    m runs as one network (``models/cnn.cnn_stack_apply_grouped``: one
    conv of m·O channels on the shared images, then cuDNN grouped convs
    and a batched fc). A singleton runs its own forward. With stats, the
    per-client BN statistics come back as a flat list in group order,
    which ``losses.bn_loss`` reads (it sums over clients, so the order
    does not matter).

The grouped representation is ``(gspecs, gparams)``: gspecs a tuple of
(CNNSpec, group size); gparams one entry a group, a stacked group (a
dict of tensors with a leading client axis, ``models/cnn.stack_models``)
for a group of more than one, the client's own ``CNN`` for a singleton.
Not ported, and refused: the mesh-sharded group sum and the chunked
teacher (ROADMAP.md, Queue 1 items 11 and 12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.models.cnn import (CNN, CNNSpec, cnn_apply,
                                    cnn_stack_apply_grouped, cnn_view,
                                    stack_models, stack_tensors)


@dataclass
class Client:
    spec: CNNSpec
    model: CNN
    n_data: int = 0                 # |D_k| (FedAvg weighting; DENSE ignores)
    class_counts: np.ndarray | None = None


def ensemble_logits(models: Sequence[CNN], x: torch.Tensor, *,
                    with_bn_stats: bool = False):
    """Eq. (1): D(x) = (1/m) Σ_k f^k(x), eval-mode BN (running stats).

    ``with_bn_stats`` also returns each client's per-BN-layer batch
    statistics of x, the inputs to L_BN (Eq. 3)."""
    logits_sum, all_stats = None, []
    for model in models:
        lg, stats = cnn_apply(model, x, train=False,
                              with_stats=with_bn_stats)
        lg = lg.float()
        logits_sum = lg if logits_sum is None else logits_sum + lg
        if with_bn_stats:
            all_stats.append(stats)
    avg = logits_sum / len(models)
    return (avg, all_stats) if with_bn_stats else avg


def group_specs(specs: Sequence[CNNSpec]):
    """[(spec, indices)], specs in order of first occurrence: the
    grouping of both the grouped engine and the grouped teacher."""
    groups: dict[CNNSpec, list[int]] = {}
    for i, spec in enumerate(specs):
        groups.setdefault(spec, []).append(i)
    return [(spec, tuple(idx)) for spec, idx in groups.items()]


def group_clients(clients: Sequence[Client]):
    """[(spec, client indices)]: ``group_specs`` of the clients' specs."""
    return group_specs([c.spec for c in clients])


def stack_grouped(clients: Sequence[Client], *, chunk: int | None = None):
    """The grouped representation (gspecs, gparams) of a federation.

    A federation from the grouped engine (``fl/federation.ClientList``)
    already is one: its own (gspecs, gparams) come back as they are, the
    tensors it trained. Otherwise each group of more than one client is
    stacked into new tensors, once (call it at setup), and a singleton
    keeps its model.

    A federation that went through upload admission
    (``fl.protocol.admit_uploads``) carries ``group_masks``: its
    quarantined clients are sliced out here (``apply_group_masks``), so
    every consumer (the DENSE teacher, the baselines, multi-round DENSE)
    sees what a federation built without them gives. The full stack,
    quarantined slots zero-filled, stays in the federation's
    ``grouped``."""
    if chunk:
        raise NotImplementedError(
            "stack_grouped(chunk=) is not ported yet (ROADMAP.md, Queue 1 "
            "item 11)")
    pre = getattr(clients, "grouped", None)
    if pre is not None:
        gspecs, gparams = tuple(pre[0]), list(pre[1])
    else:
        gspecs, gparams = [], []
        for spec, idx in group_clients(clients):
            gspecs.append((spec, len(idx)))
            gparams.append(clients[idx[0]].model if len(idx) == 1 else
                           stack_models([clients[i].model for i in idx]))
        gspecs = tuple(gspecs)
    return apply_group_masks(gspecs, gparams,
                             getattr(clients, "group_masks", None))


def apply_group_masks(gspecs, gparams, group_masks):
    """Slice the survivors out of a grouped representation, on the host
    side (``repro/core/ensemble.py:161-206``).

    ``group_masks`` has one entry a group: None (the whole group stays)
    or a numpy bool array over the group's clients. A group left with
    more than one client is re-stacked from its survivors' rows, one left
    with one becomes a singleton (a ``CNN`` viewing that row), one left
    with none disappears."""
    if group_masks is None or all(m is None for m in group_masks):
        return tuple(gspecs), list(gparams)
    if len(group_masks) != len(gspecs):
        raise ValueError(f"group_masks has {len(group_masks)} entries for "
                         f"{len(gspecs)} groups")
    new_specs, new_params = [], []
    for (spec, size), params, gm in zip(gspecs, gparams, group_masks):
        if gm is None:
            new_specs.append((spec, size))
            new_params.append(params)
            continue
        gm = np.asarray(gm, bool)
        if gm.shape != (size,):
            raise ValueError(f"group mask shape {gm.shape} != ({size},)")
        idx = np.nonzero(gm)[0]
        if idx.size == 0:
            continue
        if idx.size == size:
            new_specs.append((spec, size))
            new_params.append(params)
        elif idx.size == 1:
            new_specs.append((spec, 1))
            new_params.append(cnn_view(
                spec, {k: v[int(idx[0])] for k, v in params.items()}))
        else:
            new_specs.append((spec, int(idx.size)))
            new_params.append({k: stack_tensors([v[int(i)].detach()
                                                 for i in idx])
                               for k, v in params.items()})
    if not new_specs:
        raise ValueError("every client is quarantined: empty ensemble")
    return tuple(new_specs), new_params


def grouped_ensemble_logits(gspecs, gparams, x: torch.Tensor, *,
                            with_bn_stats: bool = False, mesh=None,
                            chunk: int | None = None):
    """Eq. (1) over the grouped representation: one forward a group.

    Agrees with ``ensemble_logits`` to float tolerance (without stats a
    group folds eval BN into its convs). ``with_bn_stats`` also returns
    the per-client stats, a flat list in group order."""
    if mesh is not None:
        raise NotImplementedError("the mesh-sharded teacher is not ported "
                                  "yet (ROADMAP.md, Queue 1 item 12)")
    if chunk:
        raise NotImplementedError("the chunked teacher is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 11)")
    m = sum(size for _, size in gspecs)
    logits_sum, all_stats = None, []
    for (spec, size), params in zip(gspecs, gparams):
        if size == 1:
            lg, stats = cnn_apply(params, x, train=False,
                                  with_stats=with_bn_stats)
            group_sum = lg.float()
            if with_bn_stats:
                all_stats.append(stats)
        else:
            lgs, stats = cnn_stack_apply_grouped(params, spec, x, size,
                                                 with_stats=with_bn_stats)
            group_sum = lgs.float().sum(dim=0)
            if with_bn_stats:
                all_stats.extend([{k: v[j] for k, v in s.items()}
                                  for s in stats] for j in range(size))
        logits_sum = group_sum if logits_sum is None \
            else logits_sum + group_sum
    avg = logits_sum / m
    return (avg, all_stats) if with_bn_stats else avg


def grouped_teacher(clients: Sequence[Client]):
    """The frozen ensemble of a server run: stacked once, here
    (``stack_grouped``). Returns ``teacher(x, with_bn_stats=False)``,
    ``grouped_ensemble_logits`` over it."""
    gspecs, gparams = stack_grouped(clients)

    def teacher(x, *, with_bn_stats: bool = False):
        return grouped_ensemble_logits(gspecs, gparams, x,
                                       with_bn_stats=with_bn_stats)

    return teacher
