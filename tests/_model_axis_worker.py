"""One rank of a CPU gloo world for tests/test_torch_model_axis.py.

    python tests/_model_axis_worker.py DIR RANK WORLD

Joins the world over the file store ``DIR/store`` (and, for the entry
points, ``torchrun``'s environment variables, set here), reads the jobs'
inputs from ``DIR/inputs.pkl`` (numpy only), runs every job and writes
what they give to ``DIR/out<RANK>.pkl``. Imports torch and the port
only: the test holds the outputs to the JAX package's results.

The meshes: ("data", "model") of 1 x 4, 2 x 2 and 4 x 1 over the four
ranks for the MoE, and ("replica", "model") 2 x 2 for the jobs at model
2: two independent pairs, each a model group of two ranks with no data
axis, the reference's two-device (1, 2) mesh twice.
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
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import shardings as SH  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def _cfg(arch, inp, **kw):
    return get_smoke_config(arch).replace(**inp["cfg"], **kw)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _mesh(shape, names):
    return DeviceMesh("cpu", torch.arange(4).reshape(shape),
                      mesh_dim_names=names)


def job_rules(inp, meshes):
    """The collectives' gradient rules on the 2 x 2 (data, model) mesh:
    x replicated, y = Σ over ``model`` of (r_m + 1)·x, gathered and cut
    over ``data``."""
    mesh = meshes[2, 2]
    m, d = mesh.get_local_rank("model"), mesh.get_local_rank("data")
    x = torch.tensor(inp["x"], requires_grad=True)
    y = M.sum_over(M.replicated_over(x, mesh, "model") * (m + 1), mesh,
                   "model")
    g_sum, = torch.autograd.grad(y.sum() + (x * x).sum(), x)
    y = M.sum_over(M.replicated_over(x, mesh, ("data", "model")) * (m + 1),
                   mesh, ("data", "model"))
    g_both, = torch.autograd.grad((y * y).sum(), x)
    rows = M.take_rows(x, mesh, "data")
    back = M.gather_over(rows * (d + 1), mesh, "data")
    g_rows, = torch.autograd.grad((back * back).sum(), x)
    return {"sum": g_sum.numpy(), "both": g_both.numpy(),
            "rows": rows.detach().numpy(), "back": back.detach().numpy(),
            "g_rows": g_rows.numpy()}


def job_moe(inp, meshes):
    cfg = _cfg("deepseek-v2-lite-16b", inp)
    out = {}
    for shape in inp["meshes"]:
        mesh = meshes[tuple(shape)]
        full = {"moe": interop.tree_from_reference(inp["params"],
                                                   device="cpu")}
        p = SH.local_params(full, cfg, mesh)
        leaves = T.leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        x = torch.tensor(inp["x"], requires_grad=True)
        y, aux = MoE.moe_apply(p["moe"], x, cfg, mesh=mesh,
                               dp_axes=("data",))
        grads = torch.autograd.grad((y * torch.sin(y)).sum() + aux,
                                    [x, *leaves])
        gtree = _rebuild(p, list(grads[1:]))
        out[tuple(shape)] = {
            "y": y.detach().numpy(), "aux": float(aux.detach()),
            "gx": grads[0].numpy(),
            "gp": _numpy(SH.gather_params(gtree, cfg, mesh)["moe"])}
    return out


def _rebuild(tree, flat):
    return {k: _rebuild(v, flat) if isinstance(v, dict) else flat.pop(0)
            for k, v in tree.items()}


class _Capture:
    """An optimizer stand-in that keeps the gradients it is given."""

    def __init__(self, params):
        self.params = list(params)

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]


def job_lm(inp, meshes):
    """loss_fn, one train step, the dense engine at model 2 (the pairs)."""
    mesh = meshes["pairs"]
    cfg = _cfg("deepseek-v2-lite-16b", inp)

    def full():
        return interop.lm_params_from_reference(inp["params"], cfg,
                                                device="cpu")

    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    local = SH.local_params(full(), cfg, mesh)
    with torch.no_grad():
        loss, parts = T.loss_fn(local, cfg, batch, mesh=mesh)
    state = ST.make_train_state(cfg, lr=inp["lr"], params=full(),
                                device="cpu", mesh=mesh)
    state, metrics = ST.make_train_step(cfg, mesh)(state, batch)
    from repro_torch.launch.engine import ServeEngine

    eng = ServeEngine(cfg, full(), mesh=mesh, max_reqs=len(inp["prompts"]),
                      max_len=inp["max_len"], device="cpu")
    rids = [eng.submit(p, max_new=inp["max_new"]) for p in inp["prompts"]]
    streams = eng.drain()
    return {"loss": float(loss), "ce": float(parts["ce"]),
            "moe_aux": float(parts["moe_aux"]), "mode": eng.mode,
            "experts": tuple(local["blocks"]["moe"]["gate"].shape),
            "step_params": _numpy(SH.gather_params(state["params"], cfg,
                                                   mesh)),
            "step_m": _numpy(SH.gather_params(
                _rebuild(state["params"], list(state["opt"].m)), cfg, mesh)),
            "step_metrics": {k: float(v) for k, v in metrics.items()},
            "streams": [streams[r] for r in rids]}


def job_llm(inp, meshes):
    """make_llm_dense_steps' two steps at model 2, gradients captured."""
    from repro_torch.core import dense_llm as DL

    mesh = meshes["pairs"]
    ccfgs = [_cfg(a, inp, vocab_size=inp["vocab"]) for a in inp["clients"]]
    scfg = _cfg(inp["student"], inp, vocab_size=inp["vocab"])
    cparams = [SH.local_params(interop.lm_params_from_reference(
        p, c, device="cpu"), c, mesh) for p, c in zip(inp["cparams"], ccfgs)]
    stu = SH.local_params(interop.lm_params_from_reference(
        inp["stu"], scfg, device="cpu"), scfg, mesh)
    for t in T.leaves(stu):
        t.requires_grad_(True)
    gen = interop.tok_generator_from_reference(
        inp["gen"], seq=inp["gen_seq"], d_model=scfg.d_model, device="cpu")
    gen_step, student_step, _, _ = DL.make_llm_dense_steps(
        scfg, ccfgs, mesh=mesh, distill_kl_mode="ref",
        kernel_vjp_mode="ref", device="cpu")
    z, y = torch.tensor(inp["z"]), torch.tensor(inp["y"])
    gcap = _Capture(gen.parameters())
    gl, parts = gen_step(gen, gcap, stu, cparams, z, y)
    scap = _Capture(T.leaves(stu))
    dl = student_step(stu, scap, gen, cparams, z, y)
    s_grad = SH.gather_params(_rebuild(stu, list(scap.grads)), scfg, mesh)
    return {"gen_loss": float(gl),
            "parts": {k: float(v) for k, v in parts.items()},
            "g_grad": {n: g.numpy() for (n, _), g in
                       zip(gen.named_parameters(), gcap.grads)},
            "dis_loss": float(dl), "s_grad": _numpy(s_grad)}


def job_pod(inp, meshes):
    """The pod distillation step of a lite stack at model 2 and without
    a mesh, both loss routes: the losses and the student after it."""
    from repro_torch.core import dense_llm as DL

    mesh = meshes["pairs"]
    cfg = _cfg("deepseek-v2-lite-16b", inp)
    out = {}
    for chunked in (False, True):
        for name, m in (("mesh", mesh), ("none", None)):
            stacked = SH.local_params(interop.tree_from_reference(
                inp["stacked"], device="cpu"), cfg, m)
            step = DL.make_pod_distill_step(
                cfg, m, n_clients=2, chunked_kl=chunked, kl_chunk=8,
                distill_kl_mode="ref", kernel_vjp_mode="ref", device="cpu")
            state = step.make_state(SH.local_params(
                interop.lm_params_from_reference(inp["stu"], cfg,
                                                 device="cpu"), cfg, m))
            state, met = step(state, stacked, torch.tensor(inp["embeds"]))
            out[name, chunked] = {
                "loss": float(met["dis_loss"]),
                "params": _numpy(SH.gather_params(state["params"], cfg, m))}
    return out


def job_entry(inp, meshes):
    """The entry points over the whole world at --model-parallel 2 (a
    2 x 2 (data, model) mesh): llama's history and weights, and lite's
    with a checkpoint that rank 0 alone writes."""
    from repro_torch.launch.train import train

    out = {}
    rank = dist.get_rank()
    for arch, ckpt in (("llama3.2-3b", None), ("deepseek-v2-lite-16b",
                                               f"ckpt{rank}")):
        state, hist = train(arch, steps=2, batch=2, seq=16, smoke=True,
                            model_parallel=2, log_every=100, device="cpu",
                            ckpt=ckpt and os.path.join(inp["dir"], ckpt))
        out[arch] = {"hist": [{k: v for k, v in h.items()
                               if k != "seconds"} for h in hist]}
        if arch == "llama3.2-3b":
            out[arch]["params"] = _numpy(state["params"])
        else:
            cfg = get_smoke_config(arch)
            out[arch]["params"] = _numpy(SH.gather_params(
                state["params"], cfg, M.make_host_mesh(2, device="cpu")))
    return out


JOBS = {"rules": job_rules, "moe": job_moe, "lm": job_lm, "llm": job_llm,
        "pod": job_pod, "entry": job_entry}


def main(path: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    dist.init_process_group("gloo", init_method=f"file://{path}/store",
                            rank=rank, world_size=world)
    with open(os.path.join(path, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    meshes = {(d, m): _mesh((d, m), ("data", "model"))
              for d, m in ((1, 4), (2, 2), (4, 1))}
    meshes["pairs"] = _mesh((2, 2), ("replica", "model"))
    out = {name: JOBS[name](inputs[name], meshes) for name in inputs["jobs"]}
    with open(os.path.join(path, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
