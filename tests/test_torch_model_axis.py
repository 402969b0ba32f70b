"""The model axis at run time — the expert-parallel MoE, ``mesh=`` and
``dp_axes`` through the trunk, the train step, the dense engine, LLM
DENSE and the pod step on a host mesh, and ``--model-parallel`` in the
entry points — against the JAX package's sharded results.

The reference side runs in two subprocesses on a CPU host forced to
four devices (``tests/_model_axis_ref.py``; the flag must be set before
JAX is imported, so never in this process). The port side runs in one
gloo world of four ranks (``tests/_model_axis_worker.py``), beside
them. At
smoke lite widths (4 experts top-2, d 128) with a capacity factor of
0.5, so that every mesh drops assignments:

  * the sharded ``moe_apply`` on (data, model) meshes of 1 x 4, 2 x 2 and
    4 x 1: y, the per-shard auxiliary and every gradient;
  * at model 2 (two pairs of ranks, each the reference's 1 x 2 mesh):
    ``loss_fn``, one train step gathered back, the dense engine's greedy
    streams, ``make_llm_dense_steps``' two steps (a lite and a gemma3
    client, a lite student) and the pod step against itself without a
    mesh;
  * ``launch/train.py`` at ``--model-parallel 2`` over the world: llama
    bit for bit as without a mesh, lite with a checkpoint rank 0 alone
    writes;
  * the collectives' gradient rules, and a one-rank mesh in this process:
    the unsharded path bit for bit.

Tolerances: 1e-5 of each largest entry for what one call computes in
float32 (the MoE, the loss, the pod step against itself), 1e-4 for a
train step's parameters and the LLM DENSE steps (``tests/
test_torch_train.py``'s and ``test_torch_family_train.py``'s).
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as r_restore

from repro_torch import interop
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import generator as T_gen
from repro_torch.launch import mesh as T_mesh
from repro_torch.launch import steps as T_ST
from repro_torch.launch.train import train as lm_train
from repro_torch.models import moe as T_M
from repro_torch.models import transformer as T_T

TOL = 1e-5
TOL_STEP = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
CFG = {"capacity_factor": 0.5}
LITE = "deepseek-v2-lite-16b"
MESHES = ((1, 4), (2, 2), (4, 1))
LLM = dict(clients=(LITE, "gemma3-4b"), student=LITE, vocab=256,
           gen_seq=16, nz=16, d_g=32, batch=2)


def _cfg(arch, **kw):
    return get_smoke_config(arch).replace(**CFG, **kw)


def _init(cfg, seed):
    """The port's ``init_model`` from ``seed`` in the reference's tree
    (numpy)."""
    return interop.lm_params_to_reference(
        T_T.init_model(cfg, seed=seed, device="cpu"))


def _close_rel(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, \
        (float(np.abs(got - want).max()), scale)


def _pairs(a, b, prefix=()):
    """(path, a leaf, b leaf) of two nested dicts with the same keys."""
    assert set(a) == set(b), (prefix, set(a) ^ set(b))
    for k in a:
        if isinstance(a[k], dict):
            yield from _pairs(a[k], b[k], prefix + (k,))
        else:
            yield prefix + (k,), a[k], b[k]


def _inputs(tmp):
    rng = np.random.default_rng(0)
    lite = _cfg(LITE)
    moe = jax.tree.map(lambda a: a[0], _init(lite, 5)["blocks"]["moe"])
    llm_cfgs = [_cfg(a, vocab_size=LLM["vocab"]) for a in LLM["clients"]]
    stu_cfg = _cfg(LLM["student"], vocab_size=LLM["vocab"])
    gen = interop.tok_generator_to_reference(T_gen.tok_generator_init(
        nz=LLM["nz"], seq=LLM["gen_seq"], d_model=stu_cfg.d_model,
        d_g=LLM["d_g"], n_classes=LLM["vocab"],
        generator=torch.Generator().manual_seed(8), device="cpu"))
    clients = [_init(lite, 11), _init(lite, 12)]
    return {
        "jobs": ["rules", "moe", "lm", "llm", "pod", "entry"],
        "rules": {"x": np.arange(1.0, 5.0, dtype=np.float32)},
        "moe": {"cfg": CFG, "meshes": MESHES, "params": moe,
                "x": rng.standard_normal((4, 16, 128)).astype(np.float32)},
        "lm": {"cfg": CFG, "params": _init(lite, 3), "lr": 1e-3,
               "batch": {k: rng.integers(0, lite.vocab_size, (2, 16))
                         .astype(np.int32) for k in ("tokens", "labels")},
               "prompts": [rng.integers(0, lite.vocab_size, 8)
                           .astype(np.int32) for _ in range(2)],
               "max_new": 5, "max_len": 13},
        "llm": dict(LLM, cfg=CFG,
                    cparams=[_init(c, 20 + i) for i, c in
                             enumerate(llm_cfgs)],
                    stu=_init(stu_cfg, 7), gen=gen,
                    z=rng.standard_normal((LLM["batch"], LLM["nz"]))
                    .astype(np.float32),
                    y=rng.integers(0, LLM["vocab"],
                                   (LLM["batch"], LLM["gen_seq"]))),
        "pod": {"cfg": CFG, "stu": _init(lite, 13),
                "stacked": jax.tree.map(lambda *a: np.stack(a), *clients),
                "embeds": rng.standard_normal((2, 16, 128))
                .astype(np.float32)},
        "entry": {"dir": str(tmp)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' results: the reference's subprocesses and the
    four-rank world run side by side. Returns (inputs, reference, [rank
    outputs])."""
    tmp = tmp_path_factory.mktemp("model_axis")
    inputs = _inputs(tmp)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_model_axis_ref.py"), str(tmp),
         parts], env=jax_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for parts in ("moe,lm", "llm")]
    procs += [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_model_axis_worker.py"),
         str(tmp), str(r), "4"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ref = {}
    for part in ("moe", "lm", "llm"):
        with open(tmp / f"ref_{part}.pkl", "rb") as f:
            ref[part] = pickle.load(f)
    outs = []
    for r in range(4):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return inputs, ref, outs


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- collectives --

def test_collectives_gradient_rules(runs):
    """sum_over / replicated_over over model (two ranks) and over (data,
    model), gather_over / take_rows over data, on every rank."""
    x = np.arange(1.0, 5.0, dtype=np.float32)
    for r, out in enumerate(runs[2]):
        g = out["rules"]
        d = r // 2                       # rank = data·2 + model
        # Σ_m (m + 1)·x = 3x: d(Σy + Σx²)/dx = 3 + 2x
        np.testing.assert_array_equal(g["sum"], 3 + 2 * x)
        # over both axes 6x: d(Σy²)/dx = 72x
        np.testing.assert_array_equal(g["both"], 72 * x)
        np.testing.assert_array_equal(g["rows"], x[2 * d:2 * d + 2])
        np.testing.assert_array_equal(g["back"], x * [1, 1, 2, 2])
        np.testing.assert_array_equal(g["g_rows"], 2 * x * [1, 1, 4, 4])


# -------------------------------------------------------------- MoE --

def _dropped(inp, shape) -> int:
    """Assignments past their expert's capacity on the data shards of
    ``shape`` (the reference's routing: stable top-k of the softmax)."""
    cfg = _cfg(LITE)
    d, _ = shape
    xf = inp["x"].reshape(-1, cfg.d_model).astype(np.float64)
    logits = xf @ inp["params"]["router"]["w"]
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.top_k]
    t_local = xf.shape[0] // d
    cap = T_M._capacity(t_local, cfg)
    return sum(int(np.maximum(np.bincount(
        idx[i * t_local:(i + 1) * t_local].ravel(),
        minlength=cfg.n_experts) - cap, 0).sum()) for i in range(d))


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_moe_matches_reference(runs, shape):
    """y, aux (each data shard's, averaged) and the gradient of
    Σ y·sin(y) + aux with respect to x, the router and every expert
    (gathered back over ``model``) and the shared experts."""
    inputs, ref, outs = runs
    assert _dropped(inputs["moe"], shape) > 0
    want = ref["moe"][shape]
    for out in outs:
        got = out["moe"][shape]
        _close_rel(got["y"], want["y"])
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=TOL)
        _close_rel(got["gx"], want["gx"])
        for path, a, b in _pairs(got["gp"], want["gp"]):
            _close_rel(a, b)
    for out in outs[1:]:
        np.testing.assert_array_equal(out["moe"][shape]["y"],
                                      outs[0]["moe"][shape]["y"])


@pytest.fixture
def solo():
    """A one-rank world in this process, taken down after the test."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = T_mesh.make_host_mesh(1, device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_one_rank_mesh_is_the_unsharded_path_bit_for_bit(solo, one_thread):
    """The MoE layer (y, aux, every gradient) and a lite train step on a
    1 x 1 mesh equal the unsharded ones bit for bit."""
    cfg = _cfg(LITE)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((4, 16, 128)).astype(np.float32)
    moe = T_T.layer(T_T.init_model(cfg, seed=5, device="cpu")["blocks"],
                    0)["moe"]
    res = []
    for mesh in (solo, None):
        p = _fresh(moe)
        x = torch.tensor(x0, requires_grad=True)
        y, aux = T_M.moe_apply(p, x, cfg, mesh=mesh, dp_axes=("data",))
        grads = torch.autograd.grad((y * torch.sin(y)).sum() + aux,
                                    [x, *T_T.leaves(p)])
        res.append([y.detach(), aux.detach(), *grads])
    for a, b in zip(*res):
        assert torch.equal(a, b)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
             for k in ("tokens", "labels")}
    steps = []
    for mesh in (solo, None):
        state = T_ST.make_train_state(cfg, seed=3, device="cpu", mesh=mesh)
        state, m = T_ST.make_train_step(cfg, mesh)(state, batch)
        steps.append((m, T_T.leaves(state["params"])))
    (m1, p1), (m0, p0) = steps
    assert all(torch.equal(m1[k], m0[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(p1, p0))


def _fresh(tree):
    """Copies of a tree's tensors, each a leaf that requires grad."""
    return {k: _fresh(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_(True)
            for k, v in tree.items()}


# ------------------------------------------------------ at model 2 --

def test_loss_fn_at_model_2_matches_reference(runs):
    _, ref, outs = runs
    want = ref["lm"]
    for out in outs:
        got = out["lm"]
        assert got["experts"][1] == 2            # 4 experts over 2 ranks
        for k in ("loss", "ce", "moe_aux"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL)


def test_train_step_at_model_2_matches_reference(runs):
    """One train step (clip over the full tree, Adam on each rank's
    expert rows), the expert rows gathered back: the metrics, Adam's
    first moment ((1 − β1) times the clipped gradient) and the updated
    parameters wherever that gradient is above 1e-5. Below it Adam's
    first step, lr·g/(|g| + 1e-8), turns float32 noise into a change of
    the update (ROADMAP.md Queue 3), in both packages."""
    _, ref, outs = runs
    want = ref["lm"]
    for out in outs:
        got = out["lm"]
        for k in ("loss", "ce", "moe_aux", "grad_norm"):
            np.testing.assert_allclose(got["step_metrics"][k],
                                       want["step_metrics"][k], rtol=TOL)
        for _, a, b in _pairs(got["step_m"], want["step_m"]):
            _close_rel(a, b, TOL_STEP)
        moments = dict((p, m) for p, m, _ in _pairs(want["step_m"],
                                                   want["step_m"]))
        for p, a, b in _pairs(got["step_params"], want["step_params"]):
            big = np.abs(moments[p]) > 0.1 * 1e-5
            assert big.mean() > 0.5
            _close_rel(a[big], b[big], TOL_STEP)


def test_dense_engine_at_model_2_matches_reference(runs):
    """Dense mode by default under the model axis; greedy streams equal
    the reference engine's on its 1 x 2 mesh, and every rank's equal."""
    _, ref, outs = runs
    assert ref["lm"]["mode"] == "dense"
    for out in outs:
        assert out["lm"]["mode"] == "dense"
        for a, b in zip(out["lm"]["streams"], ref["lm"]["streams"],
                        strict=True):
            np.testing.assert_array_equal(a, b)


def test_llm_dense_steps_at_model_2_match_reference(runs):
    """The generator step and the student step of a lite and a gemma3
    client with a lite student: losses, the generator's gradient and the
    student's (expert rows gathered)."""
    _, ref, outs = runs
    want = ref["llm"]
    gwant = interop.ref_to_state(want["g_grad"])
    for out in outs:
        got = out["llm"]
        np.testing.assert_allclose(got["gen_loss"], want["gen_loss"],
                                   rtol=TOL_STEP)
        for k in ("ce", "bn", "div"):
            np.testing.assert_allclose(got["parts"][k], want["parts"][k],
                                       rtol=TOL_STEP, atol=TOL_STEP)
        np.testing.assert_allclose(got["dis_loss"], want["dis_loss"],
                                   rtol=TOL_STEP)
        for n, g in got["g_grad"].items():
            _close_rel(g, gwant[n].numpy(), TOL_STEP)
        for _, a, b in _pairs(got["s_grad"], want["s_grad"]):
            _close_rel(a, b, TOL_STEP)


@pytest.mark.parametrize("chunked", [False, True])
def test_pod_step_on_a_host_mesh(runs, chunked):
    """The pod distillation step of a lite stack on the model-2 mesh
    against itself without a mesh (no data axis: the same function)."""
    for out in runs[2]:
        a, b = out["pod"]["mesh", chunked], out["pod"]["none", chunked]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=TOL)
        for _, x, y in _pairs(a["params"], b["params"]):
            _close_rel(x, y)


# -------------------------------------------------- the entry points --

def test_train_llama_under_model_parallel_equals_without(runs, one_thread):
    """``launch/train.py`` at ``--model-parallel 2`` over the four-rank
    world: llama reads no mesh, so its history and weights equal a run
    without one, bit for bit, on every rank."""
    state, hist = lm_train("llama3.2-3b", steps=2, batch=2, seq=16,
                           smoke=True, log_every=100, device="cpu")
    want = [{k: v for k, v in h.items() if k != "seconds"} for h in hist]
    for out in runs[2]:
        got = out["entry"]["llama3.2-3b"]
        assert got["hist"] == want
        for _, a, b in _pairs(got["params"], interop.lm_params_to_reference(
                state["params"])):
            np.testing.assert_array_equal(a, b)


def test_train_lite_model_parallel_checkpoint(runs):
    """Lite at ``--model-parallel 2`` (data 2 x model 2): the same history
    on every rank, the checkpoint written by rank 0 alone, with the
    expert rows gathered, and the reference restores it."""
    inputs, _, outs = runs
    got = [o["entry"][LITE] for o in outs]
    for g in got[1:]:
        assert g["hist"] == got[0]["hist"]
    tmp = inputs["entry"]["dir"]
    assert os.path.exists(os.path.join(tmp, "ckpt0.npz"))
    assert not any(os.path.exists(os.path.join(tmp, f"ckpt{r}.npz"))
                   for r in (1, 2, 3))
    like = jax.tree.map(jnp.zeros_like, got[0]["params"])
    back = r_restore(os.path.join(tmp, "ckpt0"), like)
    for _, a, b in _pairs(got[0]["params"], back):
        np.testing.assert_array_equal(np.asarray(b), a)
    assert got[0]["params"]["blocks"]["moe"]["gate"].shape[1] == 4
