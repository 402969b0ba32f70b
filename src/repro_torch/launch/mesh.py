"""Device meshes over the process world (``repro/launch/mesh.py:37-69``).

The reference builds its meshes over ``jax.devices()``, one program that
sees every chip. The port is SPMD: one process a rank, each on its own
device, and a ``torch.distributed.device_mesh.DeviceMesh`` over the
world those processes form, with the reference's axis names:

  * ``make_host_mesh(model)`` — ("data", "model") over the world;
  * ``make_client_mesh(data)`` — ("clients", "data"): the leading axis
    shards the grouped engine's stacked client dim (``fl/sharding.py``
    owns the placement vocabulary), ``data`` defaults to 1;
  * ``dp_axes_of(mesh)`` — the data-parallel axes ("pod", "data").

The world is ``torchrun``'s when its environment is set (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): the default process
group is initialized from it, NCCL on ``cuda`` and gloo on ``cpu``.
Without one, and with no process group initialized, a one-rank world is
started on the caller's device over an in-process store, so nothing
listens on a port. A mesh is built once per device type, shape and
world and then reused: building one makes process groups, which every
rank must do together and which a captured CUDA graph cannot do.

The spec vocabulary is ``PartitionSpec``: a tuple with one entry a
tensor dim, an axis name, a tuple of axis names or None (replicated),
equal one for one to the reference's ``jax.sharding.PartitionSpec``;
``placements(spec, mesh)`` turns one into DTensor placements, the
counterpart of ``NamedSharding``. Rules that read only axis names and
sizes (``launch/shardings.py``) also take any object with the
reference's ``axis_names`` and ``shape`` (a dict of sizes), so they can
be held at the reference's 16 x 16 and 2 x 16 x 16 shapes without 256
ranks.
"""
from __future__ import annotations

import os

import torch

DP_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """Per tensor dim an axis name, a tuple of names, or None; a tuple of
    one name is that name and an empty one None, as the reference's
    ``PartitionSpec`` normalizes them."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or of an object with
    ``axis_names`` and a ``shape`` dict (the reference's mesh shape)."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, name: str) -> int:
    return int(axis_sizes(mesh).get(name, 1))


def placements(spec, mesh) -> tuple:
    """DTensor placements of a ``PartitionSpec`` on ``mesh``: per mesh
    dim, ``Shard(d)`` for the tensor dim d that names it, else
    ``Replicate()``. A tensor dim may name several axes (the reference's
    tuple entries); each of them shards that dim."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_names(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def ensure_world(device="cuda") -> int:
    """Initialize the default process group if it is not: from
    ``torchrun``'s environment when set, else a one-rank world over an
    in-process store. Returns the world size."""
    import torch.distributed as dist

    dev = torch.device(device)
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(_backend(dev.type))
        else:
            if dev.type == "cuda":
                torch.cuda.set_device(dev.index if dev.index is not None
                                      else torch.cuda.current_device())
            dist.init_process_group(_backend(dev.type),
                                    store=dist.HashStore(), rank=0,
                                    world_size=1)
    return dist.get_world_size()


_MESHES: dict = {}


def _mesh(device, shape: tuple, names: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev_type = torch.device(device).type
    n = ensure_world(device)
    used = 1
    for s in shape:
        used *= s
    world = dist.group.WORLD
    key = (dev_type, shape, names, n)
    if key not in _MESHES or _MESHES[key][0] is not world:
        grid = torch.arange(used, dtype=torch.int).reshape(shape)
        _MESHES[key] = (world, DeviceMesh(dev_type, grid,
                                          mesh_dim_names=names))
    return _MESHES[key][1]


def make_host_mesh(model: int = 1, device="cuda"):
    """("data", "model") over the world, ``model`` ranks a model group
    (at most the world)."""
    n = ensure_world(device)
    model = max(1, min(int(model), n))
    return _mesh(device, (n // model, model), ("data", "model"))


def make_client_mesh(*, data: int = 1, device="cuda"):
    """("clients", "data") over the world. Takes the leading
    ``(n // data) * data`` ranks, so a world that ``data`` does not
    divide degrades instead of failing (the ranks past them hold no
    coordinate)."""
    n = ensure_world(device)
    data = max(1, min(int(data), n))
    return _mesh(device, (n // data, data), ("clients", "data"))


def dp_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a in DP_AXES)


__all__ = ["P", "PartitionSpec", "axis_names", "axis_size",
           "axis_sizes", "dp_axes_of", "ensure_world", "make_client_mesh",
           "make_host_mesh", "placements"]
