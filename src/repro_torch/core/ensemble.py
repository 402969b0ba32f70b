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

For federations of m = 1000 (DESIGN.md §13): ``stack_grouped(chunk=)``
stacks a group in slices of that many clients, and
``grouped_ensemble_logits(chunk=)`` streams a group's logit sum through
slices of ``chunk`` clients (``_chunked_stack_sum``), so the teacher
never holds an (m, B, ...) activation block; with a gradient, each full
slice is checkpointed (``torch.utils.checkpoint``) and re-run in the
backward. ``grouped_teacher`` takes both from the execution policy
(``stack_chunk``, ``teacher_chunk``).

On a ("clients", "data") mesh (``fl/sharding.py``, ``mesh=``) a stacked
group the clients axis divides is summed sharded
(``_group_sum_sharded``, ``repro/core/ensemble.py:272-306``): each rank
runs the grouped forward on its own clients and the group's logit sum
is one all-reduce over ``clients`` (one a slice with ``chunk``), through
``fl.sharding.sum_over_clients``; the images enter through
``fl.sharding.replicated_input``, so the generator's teacher gradient
is the sum of the ranks' shares, all-reduced once. The per-client BN
statistics stay on their rank: ``GroupedStats`` marks such a part and
``losses.bn_loss`` sums its terms on the rank, then over the axis.
"""
from __future__ import annotations

from collections.abc import Sequence as SequenceABC
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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

    ``chunk`` > 0 stacks a group in slices of that many clients,
    concatenated (``models/cnn.stack_models``): the same values, bit for
    bit (``repro/core/ensemble.py:97-160``).

    A federation that went through upload admission
    (``fl.protocol.admit_uploads``) carries ``group_masks``: its
    quarantined clients are sliced out here (``apply_group_masks``), so
    every consumer (the DENSE teacher, the baselines, multi-round DENSE)
    sees what a federation built without them gives. The full stack,
    quarantined slots zero-filled, stays in the federation's
    ``grouped``."""
    pre = getattr(clients, "grouped", None)
    if pre is not None:
        gspecs, gparams = tuple(pre[0]), list(pre[1])
    else:
        gspecs, gparams = [], []
        for spec, idx in group_clients(clients):
            gspecs.append((spec, len(idx)))
            gparams.append(clients[idx[0]].model if len(idx) == 1 else
                           stack_models([clients[i].model for i in idx],
                                        chunk or 0))
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


class GroupedStats(SequenceABC):
    """The per-client BN statistics of a grouped forward, in group order:
    entry k is client k's list of one dict a BN layer ({"mean", "var",
    "running_mean", "running_var"}), as ``ensemble_logits`` gives them.
    They are held as each group's (or chunk's) stacked statistics,
    ``parts``: (n, a list of one dict a BN layer of (n, C) tensors,
    stacked, mesh) for n clients; a singleton's (C,) dicts count as
    n = 1 unstacked. A part of a group sharded over a mesh's clients
    axis carries that mesh and holds this rank's n / axis clients of it.
    So ``losses.bn_loss`` sums over the clients a layer at a time, and
    indexing makes a client's views on demand (not of a part sharded
    over more than one rank: those live on their ranks)."""

    def __init__(self):
        self.parts: list = []          # (n, stats, stacked, mesh)

    def add(self, n: int, stats, stacked: bool = True, mesh=None) -> None:
        self.parts.append((n, stats, stacked, mesh))

    def __len__(self) -> int:
        return sum(n for n, _, _, _ in self.parts)

    def __getitem__(self, k: int):
        from repro_torch.fl.sharding import client_axis_size

        if not isinstance(k, int):
            raise TypeError("GroupedStats takes an int index")
        if k < 0:
            k += len(self)
        for n, stats, stacked, mesh in self.parts:
            if k < n:
                if client_axis_size(mesh) > 1:
                    raise IndexError(f"client {k}'s statistics are "
                                     "sharded over the clients axis")
                return [{key: v[k] for key, v in layer.items()}
                        for layer in stats] if stacked else stats
            k -= n
        raise IndexError("client index out of range")


def _stack_forward(params, spec, x, size, with_stats):
    """(logits (size, B, K) float32, stacked stats: one dict a BN layer
    of (size, C) tensors, empty without stats) of one stacked group."""
    lgs, stats = cnn_stack_apply_grouped(params, spec, x, size,
                                         with_stats=with_stats)
    return lgs.float(), stats


def _chunked_stack_sum(params, spec, x, size, chunk, with_stats,
                       reduce=None):
    """One stacked group's logit sum, streamed in slices of ``chunk``
    clients (``repro/core/ensemble.py:227-270``): each slice's
    (chunk, B, K) logits are summed into a float32 (B, K) accumulator in
    client order, the tail slice last. Under a gradient each full slice
    runs checkpointed (``torch.utils.checkpoint``, non-reentrant, no RNG
    state: the forward draws none), so the backward re-runs it instead
    of keeping its activations, as the reference's ``jax.checkpoint``
    does. ``reduce`` (the sharded path's sum over the clients axis) is
    applied to every slice's partial sum before it is accumulated.
    Returns (sum (B, K), [(n, stacked stats) a slice])."""
    acc = torch.zeros((x.shape[0], spec.num_classes), dtype=torch.float32,
                      device=x.device)
    parts: list = []
    remat = torch.is_grad_enabled() and x.requires_grad
    for c0 in range(0, size, chunk):
        n = min(chunk, size - c0)
        sub = {k: v[c0:c0 + n] for k, v in params.items()}
        if remat and n == chunk:
            lgs, st = checkpoint(_stack_forward, sub, spec, x, n, with_stats,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            lgs, st = _stack_forward(sub, spec, x, n, with_stats)
        part = lgs.sum(dim=0)
        acc = acc + (part if reduce is None else reduce(part))
        parts.append((n, st))
    return acc, parts


def _group_sum_sharded(params, spec, x, size, mesh, with_stats, chunk=None):
    """A stacked group's logit sum with its clients sharded over the
    mesh's ``clients`` axis (``repro/core/ensemble.py:272-306``):
    ``params`` holds this rank's size // axis clients, which run the
    grouped forward on the (``replicated_input``) images; their partial
    sum is all-reduced once, or once a slice with ``chunk``. Returns
    (sum (B, K) float32, replicated; [(n, stacked stats)] of this rank's
    clients)."""
    from repro_torch.fl.sharding import client_axis_size, sum_over_clients

    loc = size // client_axis_size(mesh)
    if chunk and 0 < chunk < loc:
        return _chunked_stack_sum(params, spec, x, loc, chunk, with_stats,
                                  reduce=lambda v: sum_over_clients(v, mesh))
    lgs, stats = _stack_forward(params, spec, x, loc, with_stats)
    return sum_over_clients(lgs.sum(dim=0), mesh), [(loc, stats)]


def grouped_ensemble_logits(gspecs, gparams, x: torch.Tensor, *,
                            with_bn_stats: bool = False, mesh=None,
                            chunk: int | None = None):
    """Eq. (1) over the grouped representation: one forward a group.

    Agrees with ``ensemble_logits`` to float tolerance (without stats a
    group folds eval BN into its convs). ``with_bn_stats`` also returns
    the per-client stats in group order, a ``GroupedStats``. ``chunk`` > 0
    streams each group larger than it through slices of that many
    clients (``_chunked_stack_sum``); the stats stay per client, in
    group order.

    ``mesh``: a ("clients", "data") mesh (``fl/sharding.py``). Each
    stacked group whose size the clients axis divides is summed sharded
    (``_group_sum_sharded``) over this rank's rows of its stack
    (``fl.sharding.put_stacked``, as the reference's ``shard_map`` sees
    its shard). Other groups and singletons run as without a mesh, on
    every rank."""
    from repro_torch.fl.sharding import (client_axis_size, group_shardable,
                                         put_stacked, replicated_input)

    m = sum(size for _, size in gspecs)
    logits_sum, all_stats = None, GroupedStats()
    x_sh = None
    for (spec, size), params in zip(gspecs, gparams):
        if group_shardable(mesh, size):
            if x_sh is None:        # one gradient all-reduce for them all
                x_sh = replicated_input(x, mesh)
            group_sum, parts = _group_sum_sharded(
                put_stacked(params, mesh, size), spec, x_sh, size, mesh,
                with_bn_stats, chunk)
            if with_bn_stats:
                for n, stats in parts:
                    all_stats.add(n * client_axis_size(mesh), stats,
                                  mesh=mesh)
        elif size == 1:
            lg, stats = cnn_apply(params, x, train=False,
                                  with_stats=with_bn_stats)
            group_sum = lg.float()
            if with_bn_stats:
                all_stats.add(1, stats, stacked=False)
        else:
            if chunk and 0 < chunk < size:
                group_sum, parts = _chunked_stack_sum(
                    params, spec, x, size, chunk, with_bn_stats)
            else:
                lgs, stats = _stack_forward(params, spec, x, size,
                                            with_bn_stats)
                group_sum = lgs.sum(dim=0)
                parts = [(size, stats)]
            if with_bn_stats:
                for n, stats in parts:
                    all_stats.add(n, stats)
        logits_sum = group_sum if logits_sum is None \
            else logits_sum + group_sum
    avg = logits_sum / m
    return (avg, all_stats) if with_bn_stats else avg


def grouped_teacher(clients: Sequence[Client], *, chunk: int = 0,
                    stack_chunk: int = 0, mesh=None):
    """The frozen ensemble of a server run: stacked once, here
    (``stack_grouped(chunk=stack_chunk)``). Returns
    ``teacher(x, with_bn_stats=False)``, ``grouped_ensemble_logits``
    over it, streamed in slices of ``chunk`` clients when ``chunk`` > 0
    (the policy's ``teacher_chunk``, as the reference's
    ``make_dense_steps`` reads it), on ``mesh`` when given (each rank
    runs its own clients of every group the clients axis divides)."""
    gspecs, gparams = stack_grouped(clients, chunk=stack_chunk)

    def teacher(x, *, with_bn_stats: bool = False):
        return grouped_ensemble_logits(gspecs, gparams, x,
                                       with_bn_stats=with_bn_stats,
                                       mesh=mesh, chunk=chunk)

    return teacher
