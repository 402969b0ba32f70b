"""FedAvg aggregation, the paper's primary baseline: θ_S = Σ_k (n_k/n) θ^k
over every parameter and BN statistic (``repro/fl/fedavg.py``).
Homogeneous clients only.

``fedavg_stacked`` reduces a stacked group's client axis in one of two
topologies (``mode``, the execution policy's ``fedavg`` for ``fedavg``):
``"flat"``, one weighted sum, or ``"tree"`` (DESIGN.md §13), fan-in
``branch`` groups a level, each node the float32 weighted mean of its
children with their summed weight, as edge aggregators pre-combine
uploads; the root equals the flat sum to float32 summation order.
``fedavg`` reduces a grouped federation's stack
(``fl/federation.ClientList``) directly and stacks the clients' models
once otherwise; either way it averages the survivors of upload
admission only (``survivor_mask``). On a ("clients", "data") mesh
(``mesh=``, ``fl/sharding.py``) whose clients axis divides the
(surviving) clients, the tree is sharded (``_tree_reduce_sharded``,
``repro/fl/fedavg.py:100-125``): each rank tree-reduces its own clients
to one node and the mesh is the top level of the tree, a weighted sum
pair all-reduced over the axis.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.ensemble import Client
from repro_torch.models.cnn import CNN, cnn_view, stack_models


def _check_n_data(n_data) -> np.ndarray:
    n = np.asarray(n_data, np.float64)
    if n.size == 0:
        raise ValueError("FedAvg weights are n_k / n; got an empty "
                         "n_data list")
    if np.any(n <= 0):
        bad = [(i, v) for i, v in enumerate(np.asarray(n_data).tolist())
               if v <= 0][:5]
        raise ValueError("FedAvg weights are n_k / n; every client must "
                         f"report n_data > 0, got (client, n_data): {bad}")
    return n


def _tree_level(v: torch.Tensor, w: torch.Tensor, branch: int):
    """One level (``repro/fl/fedavg.py:56-77``): (m, ...) values and (m,)
    weights to ceil(m / branch) weighted-mean nodes and their summed
    weights. The tail group is padded with zero-weight children and
    keeps at least one real child, so no node divides by zero."""
    pad = (-v.shape[0]) % branch
    if pad:
        v = torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
        w = torch.cat([w, w.new_zeros(pad)])
    g = v.shape[0] // branch
    vg = v.view((g, branch) + v.shape[1:])
    wg = w.view(g, branch)
    wsum = wg.sum(1)
    node = (vg * wg.view((g, branch) + (1,) * (v.dim() - 1))).sum(1) \
        / wsum.view((g,) + (1,) * (v.dim() - 1))
    return node, wsum


def _tree_reduce(leaf: torch.Tensor, w: torch.Tensor, branch: int):
    """A (m, ...) leaf to its root weighted mean, float32 throughout."""
    v, ww = leaf.float(), w
    while v.shape[0] > 1:
        v, ww = _tree_level(v, ww, branch)
    return v[0].to(leaf.dtype)


def _tree_reduce_sharded(leaf: torch.Tensor, w: torch.Tensor, branch: int,
                         mesh):
    """The tree over a client-sharded (m, ...) leaf: this rank's rows
    reduce to one (value, weight) node, then Σ v·w and Σ w are
    all-reduced over the clients axis and divided."""
    import torch.distributed as dist

    from repro_torch.fl.sharding import client_rows, put_stacked

    lo, hi = client_rows(mesh, leaf.shape[0])
    v, ww = put_stacked(leaf, mesh, leaf.shape[0]).float(), w[lo:hi]
    while v.shape[0] > 1:
        v, ww = _tree_level(v, ww, branch)
    num, den = (v[0] * ww[0]).contiguous(), ww[0].clone()
    group = mesh.get_group("clients")
    dist.all_reduce(num, group=group)
    dist.all_reduce(den, group=group)
    return (num / den).to(leaf.dtype)


@torch.no_grad()
def fedavg_stacked(stacked: dict, n_data, survivor_mask=None, *,
                   mode: str = "flat", branch: int = 8,
                   mesh=None) -> dict:
    """FedAvg over a stacked group (``repro/fl/fedavg.py:126-168``): new
    tensors, Σ_k w_k θ^k in float32 with w_k = n_k / n, no client axis;
    ``mode="tree"`` reduces it in fan-in ``branch`` levels (module doc).

    ``survivor_mask`` (a host bool array over the clients) leaves the
    masked-out clients out of the sum and of the weights' normalization
    (their n_data need not be positive). ``mode="tree"`` with a
    ``mesh`` whose clients axis divides the (surviving) clients reduces
    sharded (``_tree_reduce_sharded``); every rank holds the whole stack
    and gets the whole average."""
    from repro_torch.fl.sharding import group_shardable

    if mode not in ("flat", "tree"):
        raise ValueError(f"unknown fedavg mode {mode!r} "
                         "(expected 'flat' or 'tree')")
    rows = None
    if survivor_mask is not None:
        mask = np.asarray(survivor_mask, bool)
        n_all = np.asarray(n_data)
        if mask.shape != (n_all.shape[0],):
            raise ValueError(f"survivor_mask shape {mask.shape} != "
                             f"({n_all.shape[0]},)")
        if not mask.any():
            raise ValueError("FedAvg over zero surviving clients")
        rows = np.nonzero(mask)[0]
        n_data = n_all[rows]
    n = _check_n_data(n_data)
    sharded = mode == "tree" and group_shardable(mesh, len(n))
    out = {}
    for name, leaf in stacked.items():
        if rows is not None:
            leaf = leaf[torch.as_tensor(rows, device=leaf.device)]
        w = torch.tensor(n / n.sum(), dtype=torch.float32,
                         device=leaf.device)
        if sharded:
            out[name] = _tree_reduce_sharded(leaf, w, int(branch), mesh)
        elif mode == "tree":
            out[name] = _tree_reduce(leaf, w, int(branch))
        else:
            w = w.view((-1,) + (1,) * (leaf.dim() - 1))
            out[name] = (w * leaf.float()).sum(0).to(leaf.dtype)
    return out


def fedavg(clients: Sequence[Client], *, policy=None, mesh=None) -> CNN:
    """A new model holding the n_data-weighted average of the clients'
    parameters and BN running statistics, on the clients' device
    (``repro/fl/fedavg.py:171-205``). ``policy`` (an ``ExecPolicy``)
    routes the topology, ``fedavg`` and ``fedavg_branch``; None is the
    flat sum.

    A federation that went through upload admission carries
    ``survivor_mask``: its quarantined clients are left out, and the
    result is the average of a federation built without them. Zero
    survivors raise ``ValueError``. ``mesh`` shards the tree
    (``fedavg_stacked``)."""
    mode = policy.fedavg if policy is not None else "flat"
    branch = policy.fedavg_branch if policy is not None else 8
    kinds = {c.spec for c in clients}
    if len(kinds) != 1:
        raise ValueError("FedAvg requires homogeneous client models; got "
                         f"{[c.spec.kind for c in clients]}")
    mask = getattr(clients, "survivor_mask", None)
    n_data = [c.n_data for c in clients]
    grouped = getattr(clients, "grouped", None)
    if grouped is not None and len(grouped[0]) == 1 \
            and grouped[0][0][1] == len(clients) and len(clients) > 1:
        # the engine's own stack
        avg = fedavg_stacked(grouped[1][0], n_data, survivor_mask=mask,
                             mode=mode, branch=branch, mesh=mesh)
        return cnn_view(clients[0].spec, avg)
    if mask is not None:
        mask = np.asarray(mask, bool)
        if not mask.any():
            raise ValueError("FedAvg over zero surviving clients")
        clients = [c for c, ok in zip(clients, mask) if ok]
        n_data = [c.n_data for c in clients]
    _check_n_data(n_data)
    avg = fedavg_stacked(stack_models([c.model for c in clients]), n_data,
                         mode=mode, branch=branch, mesh=mesh)
    return cnn_view(clients[0].spec, avg)
