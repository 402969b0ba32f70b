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
group is initialized from it (the backend by the rule below).
Without one, and with no process group initialized, a one-rank world is
started on the caller's device over an in-process store, so nothing
listens on a port. A mesh is built once per device type, shape and
world and then reused: building one makes process groups, which every
rank must do together and which a captured CUDA graph cannot do.

The backend follows from how many ranks share a visible device: NCCL
refuses two ranks on one card ("Duplicate GPU detected"), so a ``cuda``
world whose local ranks outnumber the cards takes gloo, whose
all-reduce, all-gather and broadcast take CUDA tensors (the tensors stay
on the card; only those three collectives run on such a world); NCCL
otherwise, and gloo on the CPU. Rank r's card is ``cuda:{LOCAL_RANK %
device_count}``.

The collectives of a sharded computation that autograd flows through,
over any named axis or tuple of axes (an axis of size 1 is a copy, so a
one-rank mesh gives the unsharded results bit for bit):

  * ``sum_over`` — the all-reduce sum; its backward is the identity (the
    result is replicated, and so is its cotangent);
  * ``replicated_over`` — the identity on a tensor that is the same on
    every rank of the axes and feeds a rank-local part; its backward
    all-reduces the gradient over them, once, so each rank's local share
    is summed. PyTorch's own autograd all-reduce
    (``torch.distributed.nn.functional.all_reduce``) all-reduces the
    cotangent in its backward instead, which gives such an input each
    rank's own wrong gradient;
  * ``gather_over`` — the all-gather of each rank's rows along dim 0 in
    rank order (the leading axis outermost); its backward takes this
    rank's rows of the cotangent;
  * ``take_rows`` — this rank's rows of a replicated tensor; its backward
    all-gathers the rows' gradients back into the whole.

``make_production_mesh`` gives the reference's TPU meshes (16 x 16 and
2 x 16 x 16) as axis names and sizes alone, for the rules.
``fake_world`` starts a world of 256 or 512 ranks that runs no
collective (torch's ``fake`` backend over a ``FakeStore``), and
``fake_mesh`` builds those meshes as real ``DeviceMesh``es on it: the
dry run (``launch/dryrun.py``) traces rank 0 of it. It refuses to start
beside a real process group.

The partitioned trunk's other collectives, none of which autograd flows
through: ``max_over`` (an all-reduce max), ``reduce_scatter_over`` (a
gradient's sum over axes, each rank keeping its block of one dim) and
``gather_dim`` (every rank's block of one dim, in rank order).

The roofline constants (``PEAK_FLOPS_BF16``, ``HBM_BW``, ``NVLINK_BW``,
``IB_BW``) are the datasheet figures of the NVIDIA H100 80GB HBM3 (SXM)
at 700 W, not measurements; ``GPUS_PER_NODE`` ranks share a node's
NVLink.

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
import warnings
from types import SimpleNamespace

import torch

DP_AXES = ("pod", "data")

# datasheet figures of the NVIDIA H100 80GB HBM3 (SXM) at 700 W, per GPU:
# not measurements
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 450e9               # bytes/s a direction (NVLink 4, 18 links)
IB_BW = 50e9                    # bytes/s a GPU across nodes (400 Gb/s)
GPUS_PER_NODE = 8


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


def backend_for(device_type: str, ranks_per_device: int = 1) -> str:
    """gloo on the CPU and where ranks share a card, NCCL otherwise."""
    if device_type == "cuda" and ranks_per_device <= 1:
        return "nccl"
    return "gloo"


def ensure_world(device="cuda") -> int:
    """Initialize the default process group if it is not: from
    ``torchrun``'s environment when set, else a one-rank world over an
    in-process store. Returns the world size."""
    import torch.distributed as dist

    dev = torch.device(device)
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            share = 1
            if dev.type == "cuda":
                cards = torch.cuda.device_count()
                local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                           os.environ["WORLD_SIZE"]))
                share = -(-local // cards)
                torch.cuda.set_device(
                    int(os.environ.get("LOCAL_RANK", 0)) % cards)
            dist.init_process_group(backend_for(dev.type, share))
        else:
            if dev.type == "cuda":
                torch.cuda.set_device(dev.index if dev.index is not None
                                      else torch.cuda.current_device())
            dist.init_process_group(backend_for(dev.type),
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


def entry_mesh(model_parallel: int, device):
    """An entry point's ``(mesh, device)``: ``make_host_mesh(
    model_parallel)`` where a process group runs, ``torchrun``'s
    environment names one or ``model_parallel`` > 1, else None (a
    one-rank mesh gives the same results); the device this rank runs
    on, which the world sets."""
    import torch.distributed as dist

    from repro_torch.configs.backend import resolve_device

    resolve_device(device)          # no card: fail before a world forms
    world = dist.is_initialized() or ("RANK" in os.environ
                                      and "WORLD_SIZE" in os.environ)
    mesh = make_host_mesh(model_parallel, device=device) \
        if model_parallel > 1 or world else None
    return mesh, resolve_device(device)


def make_client_mesh(*, data: int = 1, device="cuda"):
    """("clients", "data") over the world. Takes the leading
    ``(n // data) * data`` ranks, so a world that ``data`` does not
    divide degrades instead of failing (the ranks past them hold no
    coordinate)."""
    n = ensure_world(device)
    data = max(1, min(int(data), n))
    return _mesh(device, (n // data, data), ("clients", "data"))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh by names and sizes: (data 16,
    model 16), or (pod 2, data 16, model 16) with ``multi_pod``."""
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def fake_world(world: int) -> None:
    """Start (or restart at another size) a world of ``world`` ranks on
    torch's ``fake`` backend, this process rank 0: every collective
    returns at once and moves nothing. Refuses where a real process
    group is initialized."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "fake_world: a real process group "
                f"({dist.get_backend()}) is initialized in this process")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
        _MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_mesh(*, multi_pod: bool = False, dims: tuple | None = None):
    """The production mesh (``make_production_mesh``), or ``dims`` over
    the trailing names of ("pod", "data", "model"), as a ``DeviceMesh``
    on a fake world of as many ranks (``fake_world``)."""
    from torch.distributed.device_mesh import DeviceMesh

    if dims is None:
        prod = make_production_mesh(multi_pod=multi_pod)
        names, dims = prod.axis_names, tuple(prod.shape.values())
    else:
        dims = tuple(int(d) for d in dims)
        names = ("pod", "data", "model")[-len(dims):]
    n = 1
    for d in dims:
        n *= d
    fake_world(n)
    return DeviceMesh("cpu", torch.arange(n).reshape(dims),
                      mesh_dim_names=names)


def dp_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a in DP_AXES)


# ------------------------------------------------------------ collectives --

def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _groups(mesh, axes) -> list:
    """The process group of each of ``axes`` that has more than one
    rank, in order."""
    return [mesh.get_group(a) for a in _axes(axes) if axis_size(mesh, a) > 1]


def _block(mesh, axes) -> tuple[int, int]:
    """(this rank's index, the count) over ``axes``, the first
    outermost."""
    idx, n = 0, 1
    for a in _axes(axes):
        size = axis_size(mesh, a)
        idx = idx * size + (mesh.get_local_rank(a) if size > 1 else 0)
        n *= size
    return idx, n


def _all_gather(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every rank's ``t`` along dim 0, in rank order over ``axes``."""
    import torch.distributed as dist

    for a in reversed(_axes(axes)):         # the innermost axis first
        size = axis_size(mesh, a)
        if size > 1:
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(size)]
            dist.all_gather(parts, t, group=mesh.get_group(a))
            t = torch.cat(parts)
    return t


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        import torch.distributed as dist

        out = t.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.rows, ctx.idx = t.shape[0], _block(mesh, axes)[0]
        return _all_gather(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.idx * ctx.rows:(ctx.idx + 1) * ctx.rows], None, None


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        idx, n = _block(mesh, axes)
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not split over {n} "
                             f"ranks of {_axes(axes)}")
        rows = t.shape[0] // n
        ctx.mesh, ctx.axes = mesh, axes
        return t[idx * rows:(idx + 1) * rows]

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axes), None, None


@torch.no_grad()
def max_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise max over ``axes`` of each rank's ``t`` (no
    gradient)."""
    import torch.distributed as dist

    out = t.detach().clone()
    for g in _groups(mesh, axes):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g)
    return out


@torch.no_grad()
def reduce_scatter_over(t: torch.Tensor, mesh, axes, dim: int):
    """Σ over ``axes`` of each rank's ``t``, of which this rank keeps its
    block of ``dim`` (the blocks in rank order, the leading axis
    outermost): a gradient's reduce-scatter (no gradient)."""
    import torch.distributed as dist

    t = t.detach().movedim(dim, 0)
    for a in _axes(axes):                 # the outermost axis first
        size = axis_size(mesh, a)
        if size > 1:
            if t.shape[0] % size:
                raise ValueError(f"{t.shape[0]} rows do not split over "
                                 f"{size} ranks of {a!r}")
            out = t.new_empty((t.shape[0] // size, *t.shape[1:]))
            with warnings.catch_warnings():     # deprecated in torch 2.13
                warnings.simplefilter("ignore", FutureWarning)
                dist.reduce_scatter_tensor(out, t.contiguous(),
                                           group=mesh.get_group(a))
            t = out
    return t.movedim(0, dim)


@torch.no_grad()
def gather_dim(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Every rank's block of ``dim`` in rank order over ``axes`` (no
    gradient)."""
    return _all_gather(t.detach().movedim(dim, 0), mesh,
                       axes).movedim(0, dim).contiguous()


def sum_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Σ over ``axes`` of each rank's ``t`` (replicated result); its
    gradient is passed through as it is."""
    return _Sum.apply(t, _groups(mesh, axes))


def replicated_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` (the same on every rank of ``axes``) for a rank-local
    computation: its gradient is summed over ``axes`` in the backward."""
    return _Replicated.apply(t, _groups(mesh, axes))


def gather_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every rank's rows of ``t`` along dim 0 in rank order over
    ``axes``; the backward takes this rank's rows."""
    return _Gather.apply(t, mesh, _axes(axes))


def take_rows(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """This rank's equal share of ``t``'s rows (dim 0) over ``axes``, in
    rank order; the backward all-gathers the gradient."""
    return _TakeRows.apply(t, mesh, _axes(axes))


__all__ = ["DP_AXES", "GPUS_PER_NODE", "HBM_BW", "IB_BW", "NVLINK_BW",
           "P", "PEAK_FLOPS_BF16", "PartitionSpec", "axis_names",
           "axis_size", "axis_sizes", "backend_for", "dp_axes_of",
           "ensure_world", "entry_mesh", "fake_mesh", "fake_world",
           "gather_dim", "gather_over", "make_client_mesh",
           "make_host_mesh", "make_production_mesh", "max_over",
           "placements", "reduce_scatter_over", "replicated_over",
           "sum_over", "take_rows"]
