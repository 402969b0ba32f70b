"""The JAX package's expert-parallel results for
tests/test_torch_model_axis.py, on a CPU host forced to four devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python tests/_model_axis_ref.py DIR PART[,PART...]

Reads ``DIR/inputs.pkl`` (numpy only, written by the test) and writes
the parts it is given, each to ``DIR/ref_<PART>.pkl`` (the test runs
them in two processes side by side):

  * ``moe``: the sharded ``moe_apply`` on ("data", "model") meshes of
    1 x 4, 2 x 2 and 4 x 1 with ``dp_axes=("data",)``: y, aux and the
    gradient of Σ y·sin(y) + aux with respect to x and every parameter
    (``jax.grad`` of the jitted sharded call);
  * ``lm``: on a 1 x 2 mesh of two devices, ``loss_fn``, one
    ``make_train_step`` update and the dense engine's greedy streams;
  * ``llm``: on that mesh, ``make_llm_dense_steps``' generator and
    student steps with their Adam replaced by a stand-in that hands back
    the gradient (the losses and the gradients).

The device count must be set before JAX is imported, so this runs in a
process of its own: the test process keeps its one device.
"""
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as R_base  # noqa: E402
from repro.core import dense_llm as R_DL  # noqa: E402
from repro.launch import steps as R_ST  # noqa: E402
from repro.launch.engine import ServeEngine  # noqa: E402
from repro.models import moe as R_M  # noqa: E402
from repro.models import transformer as R_T  # noqa: E402


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _cfg(arch, inp, **kw):
    return R_base.get_smoke_config(arch).replace(**inp["cfg"], **kw)


def moe(inp):
    cfg = _cfg("deepseek-v2-lite-16b", inp)
    out = {}
    for d, m in inp["meshes"]:
        mesh = jax.make_mesh((d, m), ("data", "model"))

        def loss(p, x, mesh=mesh):
            y, aux = R_M.moe_apply(p, x, cfg, mesh=mesh, dp_axes=("data",))
            return jnp.sum(y * jnp.sin(y)) + aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(_j(inp["params"]),
                                                 jnp.asarray(inp["x"]))
        out[d, m] = {"y": np.asarray(y), "aux": float(aux), "gx": _np(gx),
                     "gp": _np(gp)}
    return out


class _GradOut:
    """Stands in for Adam inside the LLM DENSE steps: ``update`` returns
    the gradient in place of the new parameters."""

    def __init__(self, lr):
        pass

    def init(self, params):
        return ()

    def update(self, grads, state, params, step=None):
        return grads, state


def lm(inp, mesh):
    cfg = _cfg("deepseek-v2-lite-16b", inp)
    params = _j(inp["params"])
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    dp = ("data",)
    loss, parts = jax.jit(lambda p, b: R_T.loss_fn(
        p, cfg, b, mesh=mesh, dp_axes=dp))(params, batch)
    state = {"params": params, "opt": R_ST.optim.adam(inp["lr"]).init(params),
             "step": jnp.zeros((), jnp.int32)}
    new, metrics = jax.jit(R_ST.make_train_step(cfg, mesh, lr=inp["lr"]))(
        state, batch)
    eng = ServeEngine(cfg, params, mesh=mesh, max_reqs=len(inp["prompts"]),
                      max_len=inp["max_len"])
    rids = [eng.submit(p, max_new=inp["max_new"]) for p in inp["prompts"]]
    streams = eng.drain()
    return {"loss": float(loss), "ce": float(parts["ce"]),
            "moe_aux": float(parts["moe_aux"]), "mode": eng.mode,
            "step_params": _np(new["params"]), "step_m": _np(new["opt"]["m"]),
            "step_metrics": {k: float(v) for k, v in metrics.items()},
            "streams": [streams[r] for r in rids]}


def llm(inp, mesh):
    ccfgs = [_cfg(a, inp, vocab_size=inp["vocab"]) for a in inp["clients"]]
    scfg = _cfg(inp["student"], inp, vocab_size=inp["vocab"])
    R_DL.optim.adam = _GradOut
    gstep, sstep, _, _ = R_DL.make_llm_dense_steps(
        scfg, ccfgs, gen_seq=inp["gen_seq"], nz=inp["nz"], mesh=mesh,
        dp_axes=("data",), distill_kl_mode="ref", kernel_vjp_mode="ref")
    cp = [_j(p) for p in inp["cparams"]]
    g_grad, _, gl, parts = gstep(_j(inp["gen"]), (), _j(inp["stu"]), cp,
                                 inp["z"], inp["y"])
    s_grad, _, dl = sstep(_j(inp["stu"]), (), _j(inp["gen"]), cp, inp["z"],
                          inp["y"])
    return {"gen_loss": float(gl),
            "parts": {k: float(v) for k, v in parts.items()},
            "g_grad": _np(g_grad), "dis_loss": float(dl),
            "s_grad": _np(s_grad)}


PARTS = {"moe": lambda inp, two: moe(inp), "lm": lm, "llm": llm}


def main(path, parts):
    with open(os.path.join(path, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    assert len(jax.devices()) == 4, jax.devices()
    two = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                            ("data", "model"))
    for part in parts:
        out = PARTS[part](inputs[part], two)
        with open(os.path.join(path, f"ref_{part}.pkl"), "wb") as f:
            pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2].split(","))
