"""One rank of a CPU gloo world for tests/test_torch_partitioned.py.

    python tests/_partitioned_worker.py DIR RANK WORLD

Joins the four-rank world over the file store ``DIR/store``, reads the
cases from ``DIR/inputs.pkl`` (numpy only), runs each with the specs the
reference's dry run jits its steps with, on this rank's shards, and
writes what they give, gathered back to full tensors, to
``DIR/out<RANK>.pkl``. Imports torch and the port only.

The meshes over the four ranks: ``"dm"``, ("data", "model") 2 x 2; and
``"pairs"``, ("replica", "model") 2 x 2, two independent model groups of
two ranks with the batch replicated (the MoE case: its capacity and
auxiliary are per data shard, as in the reference, so only a mesh
without a data axis matches the unsharded step).
"""
import os
import pickle
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.core import dense_llm as DL  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import P, gather_dim  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _tree_from(like, flat):
    it = iter(flat)

    def build(tree):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in tree.items()}
    return build(like)


def _rows(t, mesh, spec):
    """This rank's rows of a full batch tensor under ``spec``."""
    return SH.cut(t, spec, mesh)


def _all_rows(t, mesh, spec):
    axes = ST.batch_axes_of(spec)
    return gather_dim(t, mesh, axes, 0) if axes else t


def job_train(case, cfg, mesh):
    pspecs, sspecs = SH.train_state_specs(cfg, mesh,
                                          min_size=case["min_size"])
    B = case["batches"][0][0].shape[0]
    bspec = P(SH.batch_specs(mesh, B), None)
    full = interop.lm_params_from_reference(case["params"], cfg,
                                            device="cpu")
    state = ST.make_train_state(cfg, lr=case["lr"], params=full,
                                device="cpu", mesh=mesh, specs=sspecs)
    step = ST.make_train_step(cfg, mesh, specs=(sspecs, {"tokens": bspec,
                                                         "labels": bspec}))
    hist = []
    for x, y in case["batches"]:
        b = {"tokens": _rows(torch.from_numpy(x), mesh, bspec),
             "labels": _rows(torch.from_numpy(y), mesh, bspec)}
        state, m = step(state, b)
        hist.append({k: float(v) for k, v in m.items()})
    zspecs = sspecs["opt"]["m"]
    m_tree = _tree_from(state["params"], state["opt"].m)
    return {"hist": hist,
            "params": _numpy(SH.gather_params(state["params"], cfg, mesh,
                                              pspecs)),
            "adam_m": _numpy(SH.gather_tree(m_tree, zspecs, mesh)),
            "local_embed": tuple(state["params"]["embed"]["table"].shape)}


def job_serve(case, cfg, mesh):
    """Prefill ``prompt`` into a cache of ``max_len``, then decode the
    given ``tokens`` one at a time (teacher-forced): every step's
    logits, the batch gathered back."""
    pspecs, _ = SH.train_state_specs(cfg, mesh)
    prompt, feed = case["prompt"], case["feed"]
    B = prompt.shape[0]
    cache = T.init_cache(cfg, B, case["max_len"], device="cpu")
    cspecs = SH.cache_specs(cfg, cache, mesh, batch=B)
    tspec = P(SH.batch_specs(mesh, B), None)
    params = SH.local_params(interop.lm_params_from_reference(
        case["params"], cfg, device="cpu"), cfg, mesh, pspecs)
    cache = SH.local_tree(cache, cspecs, mesh)
    pre = ST.make_prefill_step(cfg, mesh, specs=(pspecs, cspecs, tspec))
    dec = ST.make_serve_step(cfg, mesh, specs=(pspecs, cspecs, tspec, P()))
    out = []
    with torch.no_grad():
        logits, cache = pre(params, cache,
                            _rows(torch.from_numpy(prompt), mesh, tspec))
        out.append(_all_rows(logits, mesh, tspec).numpy())
        for i in range(feed.shape[1]):
            tok = _rows(torch.from_numpy(feed[:, i:i + 1]), mesh, tspec)
            logits, cache = dec(params, cache, tok, prompt.shape[1] + i)
            out.append(_all_rows(logits, mesh, tspec).numpy())
    return {"logits": out, "cache_specs": repr(cspecs),
            "local_cache": {"/".join(k): tuple(v.shape)
                            for k, v in SH.leaf_paths(cache)}}


def job_pod(case, cfg, mesh):
    pspecs, sspecs = SH.train_state_specs(cfg, mesh,
                                          min_size=case["min_size"])
    stacked_full = interop.tree_from_reference(case["stacked"],
                                               device="cpu")
    stack_specs = DL.pod_stack_specs(pspecs, mesh)
    espec = P("data", None, None)
    step = DL.make_pod_distill_step(
        cfg, mesh, n_clients=case["n_clients"], s_lr=case["lr"],
        distill_kl_mode="ref", kernel_vjp_mode="ref", device="cpu",
        specs=(sspecs, stack_specs, espec))
    state = step.make_state(interop.lm_params_from_reference(
        case["student"], cfg, device="cpu"))
    stacked = SH.local_tree(stacked_full, stack_specs, mesh)
    embeds = SH.cut(torch.from_numpy(case["embeds"]), espec, mesh)
    state, met = step(state, stacked, embeds)
    return {"loss": float(met["dis_loss"]),
            "params": _numpy(SH.gather_params(state["params"], cfg, mesh,
                                              pspecs))}


def job_refuse(case, cfg, mesh):
    """A step given full (uncut) parameters raises; so does a fake world
    started beside this real one."""
    from repro_torch.launch.mesh import fake_world

    try:
        fake_world(256)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    pspecs, sspecs = SH.train_state_specs(cfg, mesh)
    bspec = P(SH.batch_specs(mesh, 4), None)
    step = ST.make_train_step(cfg, mesh, specs=(sspecs, {"tokens": bspec,
                                                         "labels": bspec}))
    full = interop.lm_params_from_reference(case["params"], cfg,
                                            device="cpu")
    state = {"params": full, "opt": None, "step": 0}
    x = torch.zeros((2, 8), dtype=torch.int32)
    try:
        step(state, {"tokens": x, "labels": x})
    except ValueError as e:
        return {"raised": str(e), "fake_world": refused}
    return {"raised": None, "fake_world": refused}


JOBS = {"train": job_train, "serve": job_serve, "pod": job_pod,
        "refuse": job_refuse}


def main(path: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/store",
                            rank=rank, world_size=world)
    with open(os.path.join(path, "inputs.pkl"), "rb") as f:
        cases = pickle.load(f)
    meshes = {"dm": DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                               mesh_dim_names=("data", "model")),
              "pairs": DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                                  mesh_dim_names=("replica", "model"))}
    out = {}
    for name, case in cases.items():
        cfg = get_smoke_config(case["arch"]).replace(**case["cfg"])
        out[name] = JOBS[case["job"]](case, cfg, meshes[case["mesh"]])
    with open(os.path.join(path, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
