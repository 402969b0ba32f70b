"""Client-axis sharding: one vocabulary for every stacked-client
computation, from grouped local training to the ensemble teacher
(``repro/fl/sharding.py:40-121``).

The grouped engine (``fl/federation.py``) and the grouped ensemble
(``core/ensemble.stack_grouped``) hold a federation as per-architecture
stacks with a leading client dim of size m. This module maps that dim
onto the ("clients", "data") mesh (``launch/mesh.make_client_mesh``):

  * ``resolve_mesh(scfg)`` routes ``ensemble_shard_mode``: "none" → None
    (one device), "clients" → the client mesh over the process world.
  * The port is SPMD, one process a rank. A stack placed client-sharded
    (``put_stacked``) is the rank's own rows: rank r of n keeps clients
    [r·m/n, (r+1)·m/n). A group the axis does not divide
    (``group_shardable``) stays whole on every rank, so
    ``ensemble_shard_mode="clients"`` is correct on any world size.
  * ``stack_specs`` prepends a stacked-client axis to a spec tree, the
    vocabulary shared with ``core/dense_llm.pod_stack_specs``, whose
    ensemble dim is the same leading client dim under the name "pod";
    ``client_stack_sharding`` / ``replicated_sharding`` give the DTensor
    placements of the two layouts (``launch/mesh.placements``).
  * ``sum_over_clients`` and ``replicated_input`` are the two collectives
    of a sharded sum that autograd flows through, ``launch/mesh``'s
    ``sum_over`` and ``replicated_over`` on the ``clients`` axis: the
    forward sum is an all-reduce whose backward is the identity (the
    cotangent of a replicated result is already the same on every rank);
    a replicated input (the generator's images) that feeds the
    rank-local part is the identity forward and all-reduces its gradient
    in the backward, once, so each rank's local share is summed.
  * ``gather_rows`` all-gathers rank-local rows back into the stack, in
    client order.

On one rank every collective is a copy, so the sharded path sums in the
unsharded order and gives its results bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.configs.backend import SHARD_MODES, resolve_exec_policy
from repro_torch.launch.mesh import (P, axis_size, gather_over,
                                     make_client_mesh, placements,
                                     replicated_over, sum_over)

CLIENT_AXIS = "clients"


def resolve_mesh(scfg, *, device="cuda"):
    """None (one device) or the ("clients", "data") client mesh over the
    process world, from ``ensemble_shard_mode`` as the execution policy
    resolves it (``configs/backend.py``; "none" on every profile unless
    the config opts in). ``scfg`` may be a config, an ``ExecPolicy``
    (whose backend names the device) or None."""
    pol = resolve_exec_policy(scfg, device=device)
    if pol.ensemble_shard == "none":
        return None
    dev = torch.device(device)
    if dev.type != pol.backend:
        dev = torch.device(pol.backend)
    return make_client_mesh(device=dev)


def client_axis_size(mesh) -> int:
    if mesh is None:
        return 1
    return axis_size(mesh, CLIENT_AXIS)


def group_shardable(mesh, size: int) -> bool:
    """A stacked group shards iff the clients axis divides its size (each
    rank then holds size // axis whole clients)."""
    return mesh is not None and size > 1 \
        and size % client_axis_size(mesh) == 0


def client_rows(mesh, size: int) -> tuple[int, int]:
    """[lo, hi): the clients of a shardable group of ``size`` this rank
    holds."""
    loc = size // client_axis_size(mesh)
    r = mesh.get_local_rank(CLIENT_AXIS)
    return r * loc, (r + 1) * loc


def stack_specs(inner_specs, axis):
    """Prepend a stacked-client axis to a spec tree (nested dicts, lists
    or tuples of ``PartitionSpec``): the host CNN stacks use
    axis="clients", the LLM pod cell axis="pod"; axis=None gives a
    replicated leading dim."""
    if isinstance(inner_specs, P):
        return P(axis, *inner_specs)
    if isinstance(inner_specs, dict):
        return {k: stack_specs(v, axis) for k, v in inner_specs.items()}
    return type(inner_specs)(stack_specs(v, axis) for v in inner_specs)


def client_stack_sharding(mesh) -> tuple:
    """Leading client dim over ``clients``, the rest replicated."""
    return placements(P(CLIENT_AXIS), mesh)


def replicated_sharding(mesh) -> tuple:
    return placements(P(), mesh)


def _rows(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _rows(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rows(v, lo, hi) for v in tree)
    return tree[lo:hi]


def put_stacked(tree, mesh, size: int):
    """A stacked tree (dicts, lists or tuples of tensors with a leading
    client dim of ``size``) as this rank holds it: its own rows (views)
    when the group shards, else the whole tree."""
    if not group_shardable(mesh, size):
        return tree
    lo, hi = client_rows(mesh, size)
    return _rows(tree, lo, hi)


def put_replicated(tree, mesh):
    """Replicated: every rank holds all of it."""
    return tree


def put_grouped(gspecs, gparams, mesh):
    """A grouped representation (``core/ensemble.stack_grouped``) as
    this rank holds it: each stacked group the axis divides as its own
    rows, singletons and ragged groups whole."""
    if mesh is None:
        return list(gparams)
    return [put_replicated(params, mesh) if size == 1
            else put_stacked(params, mesh, size)
            for (_, size), params in zip(gspecs, gparams)]


def sum_over_clients(t: torch.Tensor, mesh) -> torch.Tensor:
    """Σ over the clients axis of each rank's ``t`` (replicated result);
    its gradient is passed through as it is."""
    return sum_over(t, mesh, CLIENT_AXIS)


def replicated_input(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` (the same on every rank) for a rank-local computation: its
    gradient is summed over the clients axis in the backward."""
    return replicated_over(t, mesh, CLIENT_AXIS)


@torch.no_grad()
def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The rank-local rows of every rank along dim 0, concatenated in
    rank order (client order)."""
    return gather_over(t, mesh, CLIENT_AXIS)


__all__ = ["CLIENT_AXIS", "SHARD_MODES", "client_axis_size", "client_rows",
           "client_stack_sharding", "gather_rows", "group_shardable",
           "put_grouped", "put_replicated", "put_stacked",
           "replicated_input", "replicated_sharding", "resolve_mesh",
           "stack_specs", "sum_over_clients"]
