"""The multi-pod dry run (``repro/launch/dryrun.py``): every (architecture
x input shape) cell of the production mesh traced as rank 0 of a fake
world, with its per-device memory, FLOPs, bytes, collectives and
roofline.

The reference lowers and compiles each cell's jitted step on 256 or 512
host devices and reads XLA's cost analysis. The port has no compiler to
ask: it runs the step itself, once, as one rank of a world of 256
(16 x 16) or 512 (2 x 16 x 16) ranks on torch's ``fake`` backend
(``launch/mesh.fake_world``), under ``FakeTensorMode``: this rank's
state and inputs are built at their shard shapes from ``launch/specs``
and the spec trees (``launch/shardings``), nothing is allocated, and
every collective returns at once. The step is the one a run takes
(``launch/steps`` with ``specs=``: the partitioned trunk), on the CPU
profile (the plain path), as the reference's dry run lowers its plain
XLA path on host devices. Decode passes ``pos`` as a Python int
(``seq - 1``).

Where each count comes from (torch's own counters, ``"counted_by":
"torch"``):

  * FLOPs per device: ``torch.utils.flop_counter.FlopCounterMode``,
    which counts matrix products, convolutions and attention only (not
    elementwise work, norms or softmax); a recomputed block (remat) is
    counted again;
  * bytes per device: the inputs and outputs of every op that is not a
    view (``_ByteCounter``), each op's traffic as if nothing stayed in
    cache;
  * collectives: their counts from ``CommDebugMode``, their bytes (each
    op's own tensor arguments: the all-reduce's tensor, the all-gather's
    and reduce-scatter's input and output) by kind and by mesh axis;
  * memory: ``argument_bytes``, the local state and inputs; the peak
    from ``MemTracker`` (everything live during the step).

Every layer is traced, so the reference's two-depth extrapolation
(``depth_pair``) has no counterpart: the record says the full depth was
counted. ``model_flops`` is the reference's formula. The roofline
divides by the H100's datasheet figures (``launch/mesh``): FLOPs over
the bf16 dense peak, bytes over HBM, and each axis's collective bytes
over NVLink when its groups lie within one node's 8 consecutive ranks,
else over InfiniBand.

Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-2-3b \\
      --shape train_4k [--multi-pod] [--mesh 64x4] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --dense-distill \\
      [--multi-pod]

One JSON record a cell under ``--out`` (default ``artifacts/dryrun``),
the reference's keys; a summary line a cell on stdout. Refuses to run in
a process where a real process group is initialized.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs.base import available_archs, get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import shardings as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import P

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d ops by kind
_KIND = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all"}
FLOPS_COUNTED = "matrix products, convolutions and attention only"


def model_flops(cfg, shape_name: str) -> float:
    """Analytic useful FLOPs for the whole step, all devices
    (``repro/launch/dryrun.py:85-91``)."""
    sh = SP.SHAPES[shape_name]
    n = cfg.active_param_count()
    tokens = sh["batch"] * (sh["seq"] if sh["kind"] != "decode" else 1)
    mult = 6 if sh["kind"] == "train" else 2
    return float(mult) * n * tokens


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _make_counter():
    """A dispatch mode that sums each non-view op's input and output
    bytes, and each collective's tensor bytes by kind and process group
    (built here: ``TorchDispatchMode`` is imported when a cell runs)."""
    import torch.distributed as dist
    from torch.utils._python_dispatch import TorchDispatchMode

    class _ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.coll = []          # (kind, group name, bytes)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.namespace == "c10d":
                kind = _KIND.get(func._overloadpacket.__name__)
                if kind is not None:
                    name = None
                    for a in args:
                        if type(a).__name__ == "ScriptObject":
                            try:
                                name = dist.ProcessGroup.unbox(a).group_name
                                break
                            except RuntimeError:
                                continue
                    n = sum(_nbytes(t) for a in args for t in _tensors(a))
                    self.coll.append((kind, name, n))
                return out
            if not func.is_view:
                self.bytes += sum(_nbytes(t) for a in (*args,
                                                       *kwargs.values())
                                  for t in _tensors(a))
                self.bytes += sum(_nbytes(t) for t in _tensors(out))
            return out

    return _ByteCounter()


def _axis_groups(mesh) -> dict:
    """{process group name: (axis, its ranks)} of every axis of
    ``mesh`` with more than one rank (this rank's group of each)."""
    import torch.distributed as dist

    out = {}
    for a in M.axis_names(mesh):
        if M.axis_size(mesh, a) > 1:
            g = mesh.get_group(a)
            out[g.group_name] = (a, dist.get_process_group_ranks(g))
    return out


def _on_nvlink(ranks) -> bool:
    """Whether a group's ranks lie within one node (``GPUS_PER_NODE``
    consecutive ranks)."""
    return len({r // M.GPUS_PER_NODE for r in ranks}) == 1


def _local(meta_tree, specs, mesh):
    """Fake tensors of this rank's shard shapes (under FakeTensorMode)."""
    return SH.map_leaves(meta_tree, lambda keys, leaf: torch.empty(
        SH.local_shape(leaf.shape, SH.spec_at(specs, keys), mesh),
        dtype=leaf.dtype))


def _bytes_of(tree) -> int:
    if isinstance(tree, dict):
        return sum(_bytes_of(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes_of(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    return 0


def _mesh(multi_pod: bool, mesh_shape: str | None):
    dims = tuple(int(x) for x in mesh_shape.split("x")) if mesh_shape \
        else None
    return M.fake_mesh(multi_pod=multi_pod, dims=dims)


def _build(cfg, shape_name: str, mesh):
    """(run, argument bytes): the cell's step on this rank's fake shards
    and what its state and inputs hold. Call under FakeTensorMode."""
    from repro_torch.launch import steps as ST

    sh = SP.SHAPES[shape_name]
    spec = SP.input_specs(cfg, shape_name)
    aparams = SP.abstract_params(cfg)
    pspecs, sspecs = SH.train_state_specs(cfg, mesh, aparams)
    bspec = SH.batch_specs(mesh, sh["batch"])
    params = _local(aparams, pspecs, mesh)
    vision = spec.get("vision") if sh["kind"] != "train" \
        else spec["batch_inputs"].get("vision")
    vspec = P(bspec, None, None)

    if sh["kind"] == "train":
        bspecs = {k: P(bspec, *([None] * (v.dim() - 1)))
                  for k, v in spec["batch_inputs"].items()}
        batch = _local(spec["batch_inputs"], bspecs, mesh)
        state = ST.make_train_state(cfg, params=params, device="cpu",
                                    mesh=mesh, specs=sspecs)
        step = ST.make_train_step(cfg, mesh, specs=(sspecs, bspecs))
        args = _bytes_of(params) + _bytes_of(state["opt"].m) \
            + _bytes_of(state["opt"].v) + _bytes_of(batch)
        return (lambda: step(state, batch)), args

    cspecs = SH.cache_specs(cfg, spec["cache"], mesh, batch=sh["batch"])
    cache = _local(spec["cache"], cspecs, mesh)
    tspec = P(bspec, None)
    tokens = torch.empty(SH.local_shape(spec["tokens"].shape, tspec, mesh),
                         dtype=spec["tokens"].dtype)
    vis = None
    if vision is not None:
        vis = torch.empty(SH.local_shape(vision.shape, vspec, mesh),
                          dtype=vision.dtype)
    args = _bytes_of(params) + _bytes_of(cache) + _bytes_of(tokens) \
        + _bytes_of(vis)
    if sh["kind"] == "prefill":
        step = ST.make_prefill_step(cfg, mesh, specs=(pspecs, cspecs, tspec))
        return (lambda: step(params, cache, tokens, vis)), args
    step = ST.make_serve_step(cfg, mesh, specs=(pspecs, cspecs, tspec, P()))
    pos = sh["seq"] - 1
    return (lambda: step(params, cache, tokens, pos, vis)), args


def _measure(run, mesh) -> dict:
    """Run ``run()`` once under the counters (module doc)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    counter = _make_counter()
    tracker = MemTracker()
    with FlopCounterMode(display=False) as flops, CommDebugMode() as comm, \
            counter, tracker:
        run()
    peak = tracker.get_tracker_snapshot("peak")
    peak_bytes = max((v.get("Total", 0) for v in peak.values()), default=0)
    groups = _axis_groups(mesh)
    coll = {k: 0 for k in COLLECTIVES}
    by_axis: dict = {}
    for kind, name, n in counter.coll:
        axis = groups.get(name, (name or "?", ()))[0]
        coll[kind] += n
        by_axis.setdefault(axis, {k: 0 for k in COLLECTIVES})[kind] += n
    coll["total"] = sum(coll[k] for k in COLLECTIVES)
    coll["count"] = len(counter.coll)
    coll["counts_by_op"] = {str(k): v for k, v in
                            comm.get_comm_counts().items()}
    coll["by_axis"] = {a: dict(v, total=sum(v.values()))
                       for a, v in by_axis.items()}
    link = {a: ("nvlink" if _on_nvlink(r) else "infiniband")
            for a, r in groups.values()}
    coll["link_by_axis"] = link
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(counter.bytes), "collectives": coll,
            "peak": peak_bytes, "link": link}


def _roofline(flops: float, nbytes: float, coll: dict) -> dict:
    t_coll = sum(v["total"] / (M.NVLINK_BW if coll["link_by_axis"].get(a)
                               == "nvlink" else M.IB_BW)
                 for a, v in coll["by_axis"].items())
    return {"compute_s": flops / M.PEAK_FLOPS_BF16,
            "memory_s": nbytes / M.HBM_BW, "collective_s": t_coll}


def _constants() -> dict:
    return {"source": "NVIDIA H100 80GB HBM3 (SXM) datasheet at 700 W, "
                      "not measured",
            "peak_flops_bf16": M.PEAK_FLOPS_BF16, "hbm_bw": M.HBM_BW,
            "nvlink_bw": M.NVLINK_BW, "ib_bw": M.IB_BW,
            "gpus_per_node": M.GPUS_PER_NODE}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh_shape: str | None = None,
             cfg_overrides: dict | None = None) -> dict:
    """One (arch, shape) cell's record (module doc)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": mesh_shape or ("2x16x16" if multi_pod else "16x16"),
           "counted_by": "torch"}
    if cfg_overrides:
        rec["cfg_overrides"] = {k: str(v) for k, v in cfg_overrides.items()}
    if shape_name == "long_500k" and not SP.long_context_ok(cfg):
        rec["status"] = "skipped"
        rec["reason"] = ("pure full-attention arch: long_500k requires a "
                         "sub-quadratic path (DESIGN.md §5)")
        return rec
    mesh = _mesh(multi_pod, mesh_shape)
    chips = 1
    for v in M.axis_sizes(mesh).values():
        chips *= v
    t0 = time.perf_counter()
    try:
        with FakeTensorMode():
            run, arg_bytes = _build(cfg, shape_name, mesh)
            got = _measure(run, mesh)
    except Exception as e:      # a failure here is a fault of the port
        rec["status"] = "FAILED"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        return rec
    rec["status"] = "ok"
    rec["trace_s"] = time.perf_counter() - t0
    rec["depth"] = {"counted": "full", "n_layers": cfg.n_layers}
    rec["memory"] = {"argument_bytes": arg_bytes,
                     "peak_per_device": got["peak"]}
    rec["flops_per_device"] = got["flops"]
    rec["flops_counted"] = FLOPS_COUNTED
    rec["bytes_per_device"] = got["bytes"]
    rec["collectives"] = got["collectives"]
    rec["roofline"] = _roofline(got["flops"], got["bytes"],
                                got["collectives"])
    rec["roofline_constants"] = _constants()
    rec["bottleneck"] = max(rec["roofline"], key=rec["roofline"].get)
    mf = model_flops(cfg, shape_name)
    rec["model_flops_total"] = mf
    rec["useful_flops_ratio"] = mf / (got["flops"] * chips) \
        if got["flops"] else 0.0
    return rec


def run_dense_distill_cell(*, multi_pod: bool = False,
                           arch: str = "llama3-2-3b", batch: int = 64,
                           seq: int = 512, chunked_kl: bool = False) -> dict:
    """DENSE's stage-2 distillation at production scale
    (``repro/launch/dryrun.py:250-314``): the homogeneous client stack's
    leading dim over ``pod`` on the two-pod mesh (the teacher's mean one
    all-reduce over ``pod``), replicated on one pod with two clients;
    the student's state by ``param_specs``/``zero1_specs``, the
    embeddings over ``data``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import dense_llm as DL

    cfg = get_config(arch)
    mesh = _mesh(multi_pod, None)
    sizes = M.axis_sizes(mesh)
    chips = 1
    for v in sizes.values():
        chips *= v
    n_clients = sizes["pod"] if multi_pod else 2
    rec = {"arch": f"dense-distill-{arch}", "shape": f"b{batch}_s{seq}",
           "mesh": "2x16x16" if multi_pod else "16x16",
           "n_clients": n_clients, "chunked_kl": chunked_kl,
           "counted_by": "torch"}
    t0 = time.perf_counter()
    try:
        with FakeTensorMode():
            aparams = SP.abstract_params(cfg)
            pspecs, sspecs = SH.train_state_specs(cfg, mesh, aparams)
            cspecs = DL.pod_stack_specs(pspecs, mesh)
            espec = P("data", None, None)
            full_stack = SH.map_leaves(aparams, lambda k, t: torch.empty(
                (n_clients, *t.shape), dtype=t.dtype, device="meta"))
            stacked = _local(full_stack, cspecs, mesh)
            embeds = torch.empty(SH.local_shape(
                (batch, seq, cfg.d_model), espec, mesh),
                dtype=getattr(torch, cfg.dtype))
            step = DL.make_pod_distill_step(
                cfg, mesh, n_clients=n_clients, chunked_kl=chunked_kl,
                device="cpu", specs=(sspecs, cspecs, espec))
            state = step.make_state(_local(aparams, pspecs, mesh))
            arg_bytes = _bytes_of(state["params"]) \
                + _bytes_of(state["opt"].m) + _bytes_of(state["opt"].v) \
                + _bytes_of(stacked) + _bytes_of(embeds)
            got = _measure(lambda: step(state, stacked, embeds), mesh)
    except Exception as e:
        rec["status"] = "FAILED"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        return rec
    rec["status"] = "ok"
    rec["trace_s"] = time.perf_counter() - t0
    rec["depth"] = {"counted": "full", "n_layers": cfg.n_layers}
    rec["memory"] = {"argument_bytes": arg_bytes,
                     "peak_per_device": got["peak"]}
    rec["flops_per_device"] = got["flops"]
    rec["flops_counted"] = FLOPS_COUNTED
    rec["bytes_per_device"] = got["bytes"]
    rec["collectives"] = got["collectives"]
    rec["roofline"] = _roofline(got["flops"], got["bytes"],
                                got["collectives"])
    rec["roofline_constants"] = _constants()
    rec["bottleneck"] = max(rec["roofline"], key=rec["roofline"].get)
    rec["chips"] = chips
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SP.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--dense-distill", action="store_true",
                    help="the DENSE stage-2 distillation cell")
    ap.add_argument("--mesh", default=None,
                    help="an alternate logical mesh over the same ranks, "
                         "e.g. 64x4 (axes data x model)")
    ap.add_argument("--baseline-attn", action="store_true",
                    help="no blockwise attention")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    mesh_tag = args.mesh or ("2x16x16" if args.multi_pod else "16x16")

    if args.dense_distill:
        chunked = os.environ.get("DENSE_CHUNKED_KL", "") == "1"
        rec = run_dense_distill_cell(multi_pod=args.multi_pod,
                                     chunked_kl=chunked)
        tag = (f"dense-distill_{rec['shape']}"
               f"{'_chunked' if chunked else ''}_{mesh_tag}")
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps({k: rec.get(k) for k in
                          ("status", "trace_s", "bottleneck", "error")}),
              flush=True)
        return
    if not (args.all or args.arch):
        ap.error("give --arch, --all or --dense-distill")
    archs = [args.arch] if args.arch else available_archs()
    shapes = [args.shape] if args.shape else list(SP.SHAPES)
    overrides = {"use_blockwise_attn": False} if args.baseline_attn \
        else None
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}_{shape}_{mesh_tag}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"skip {tag} (exists)")
                continue
            print(f"=== {tag} ===", flush=True)
            rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                           mesh_shape=args.mesh, cfg_overrides=overrides)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(json.dumps({k: rec.get(k) for k in
                              ("status", "trace_s", "bottleneck", "reason",
                               "error")}), flush=True)


if __name__ == "__main__":
    main()
