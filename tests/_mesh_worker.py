"""One rank of a CPU gloo world for tests/test_torch_mesh_spmd.py.

    python tests/_mesh_worker.py DIR RANK WORLD

Joins the world over the file store ``DIR/store``, reads the jobs and
their inputs from ``DIR/inputs.pt`` (``torch.save``), runs each on the
("clients", "data") client mesh in turn and writes what they give to
``DIR/out<RANK>.pt``. Imports torch and the port only: the test holds
the outputs to the JAX package's results, which it computes itself.
"""
import dataclasses
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def job_routing(inp, mesh):
    from repro_torch.configs import smoke
    from repro_torch.fl import sharding as SH
    from repro_torch.launch import mesh as M

    on = dataclasses.replace(smoke(), ensemble_shard_mode="clients")
    return {"none": SH.resolve_mesh(smoke(), device="cpu") is None,
            "same_mesh": SH.resolve_mesh(on, device="cpu") is mesh,
            "names": M.axis_names(mesh), "sizes": M.axis_sizes(mesh),
            "host": M.axis_sizes(M.make_host_mesh(device="cpu")),
            "dp_axes": M.dp_axes_of(mesh),
            "rows": SH.client_rows(mesh, 4),
            "shardable": [SH.group_shardable(mesh, m) for m in (1, 2, 3, 4)],
            "stacked": str(SH.client_stack_sharding(mesh)),
            "replicated": str(SH.replicated_sharding(mesh))}


def job_grad_rule(inp, mesh):
    """y = Σ_r (r + 1)·x over the ranks, x replicated: dΣy/dx is
    Σ_r (r + 1) on every rank; plus a replicated term x·x."""
    from repro_torch.fl.sharding import replicated_input, sum_over_clients

    r = dist.get_rank()
    x = torch.tensor(inp["x"], requires_grad=True)
    y = sum_over_clients(replicated_input(x, mesh) * (r + 1), mesh)
    loss = y.sum() + (x * x).sum()
    g_lin, = torch.autograd.grad(loss, x)
    y = sum_over_clients(replicated_input(x, mesh) * (r + 1), mesh)
    g_sq, = torch.autograd.grad((y * y).sum(), x)
    return {"lin": g_lin.numpy(), "sq": g_sq.numpy()}


def job_teacher(inp, mesh):
    from repro_torch.core import losses as LS
    from repro_torch.core.ensemble import grouped_ensemble_logits

    out = {}
    for chunk in (0, 1):
        for name, m in (("mesh", mesh), ("none", None)):
            x = torch.tensor(inp["x"], requires_grad=True)
            avg, stats = grouped_ensemble_logits(
                inp["gspecs"], inp["gparams"], x, with_bn_stats=True,
                mesh=m, chunk=chunk)
            l_ce = LS.ce_loss(avg, torch.tensor(inp["y"]))
            l_bn = LS.bn_loss(stats)
            total = l_ce + inp["lambda_bn"] * l_bn
            gx, = torch.autograd.grad(total, x)
            out[name, chunk] = {"avg": avg.detach().numpy(),
                                "bn": float(l_bn), "ce": float(l_ce),
                                "total": float(total), "gx": gx.numpy(),
                                "n_stats": len(stats)}
    return out


def job_local(inp, mesh):
    from repro_torch.fl.client import local_update_grouped

    stacked = {k: v.clone() for k, v in inp["stacked"].items()}
    _, info = local_update_grouped(stacked, inp["spec"], inp["xs"],
                                   inp["ys"], inp["plan"], lr=inp["lr"],
                                   momentum=inp["momentum"], mesh=mesh)
    return {"stacked": {k: v.detach().numpy() for k, v in stacked.items()},
            "loss": info["loss"].numpy()}


def job_fedavg(inp, mesh):
    from repro_torch.fl.fedavg import fedavg_stacked

    return {k: v.numpy() for k, v in fedavg_stacked(
        inp["stacked"], inp["n_data"], mode="tree", branch=inp["branch"],
        mesh=mesh).items()}


def job_round(inp, mesh):
    from repro_torch import interop
    from repro_torch.core import train_dense_server
    from repro_torch.fl import build_federation
    from repro_torch.models.cnn import cnn_logits

    scfg = inp["scfg"]
    clients, _ = build_federation(scfg, inp["data"], device="cpu",
                                  init_models=inp["inits"])
    noise = inp["noise"]
    stu, _, hist = train_dense_server(clients, scfg, device="cpu",
                                      noise=noise.__getitem__,
                                      gen=inp["gen"], student=inp["stu"])
    with torch.no_grad():
        logits = cnn_logits(stu, torch.from_numpy(inp["data"]["test"][0]))
    return {"uploads": [interop.cnn_to_ref(c.model) for c in clients],
            "gen_loss": hist.gen_loss, "dis_loss": hist.dis_loss,
            "gen_parts": hist.gen_parts, "logits": logits.numpy()}


JOBS = {"routing": job_routing, "grad_rule": job_grad_rule,
        "teacher": job_teacher, "local": job_local, "fedavg": job_fedavg,
        "round": job_round}


def main(path: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/store",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_client_mesh

    inputs = torch.load(os.path.join(path, "inputs.pt"), weights_only=False)
    mesh = make_client_mesh(device="cpu")
    out = {name: JOBS[name](inputs[name], mesh) for name in inputs["jobs"]}
    torch.save(out, os.path.join(path, f"out{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
