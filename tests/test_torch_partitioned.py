"""The trunk partitioned by the rules: the train, prefill, decode and pod
distillation steps given the specs the reference's dry run jits them
with (``param_specs``, ``zero1_specs``, ``batch_specs``,
``cache_specs``, ``pod_stack_specs``), each rank computing on its
shards, against the JAX package's unsharded steps on the same full
batch.

The port side runs once, in one gloo world of four CPU ranks
(``tests/_partitioned_worker.py``, four processes over a file store),
on a ("data", "model") 2 x 2 mesh; the MoE case on ("replica", "model")
2 x 2, two model groups of two with the batch replicated (its capacity
and auxiliary are per data shard, the reference's sharded semantics,
which only a mesh without a data axis matches to the unsharded step).
The reference side runs in this process meanwhile. Smoke configs:

  * ``dense``: llama (4 query / 2 KV heads: attention head-sharded);
  * ``dense_rep``: llama with one KV head (attention replicated, the
    KV cache's sequence dim over ``model``);
  * ``moe``: lite's MLA with routed and shared experts (capacity factor
    4: no drops);
  * ``ssm``: mamba2 (8 heads: head-sharded, the gated norm over
    ``model``); ``hybrid``: zamba2.

ZeRO-1 takes every moment of 1024 entries or more (``min_size``), so
the embedding, the projections and the MLPs step their ``data`` slice.
Every parameter that starts at zero (the conv biases, ``dt_bias``) is
drawn at random, so that a bias on the wrong shard shows.

Tolerances: the losses and grad norms 1e-5 relative; Adam's first
moments 1e-4 of each tensor's largest entry; the parameters after two
Adam steps 1e-4 of each tensor's largest entry wherever the gradient of
every step is above 1e-5: below it Adam's update lr·g/(|g| + 1e-8)
turns float32 noise into a change of the update, in both packages
(ROADMAP.md Queue 3; ``tests/test_torch_model_axis.py`` holds one step
so); logits 1e-5 of the largest entry; the pod step's loss 1e-5
relative and its parameters as a train step's.
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

from repro import optim as R_optim
from repro.configs import base as R_base
from repro.core import dense_llm as R_DL
from repro.launch import steps as R_ST
from repro.launch.mesh import make_host_mesh as r_host_mesh
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.configs import base as T_base
from repro_torch.models import transformer as T_T

TOL = 1e-5
TOL_STEP = 1e-4
G_FLOOR = 1e-5
PER_HEAD = ("a_log", "dt_bias", "d_skip")
B1 = 0.9                # Adam's β1: m_t = β1·m_{t−1} + (1 − β1)·g_t
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_partitioned_worker.py")
LR = 1e-3
CASES = {
    "dense": dict(arch="llama3.2-3b", cfg={}, mesh="dm"),
    "dense_rep": dict(arch="llama3.2-3b", cfg={"n_kv_heads": 1},
                      mesh="dm"),
    "moe": dict(arch="deepseek-v2-lite-16b", cfg={"capacity_factor": 4.0},
                mesh="pairs"),
    "ssm": dict(arch="mamba2-130m", cfg={}, mesh="dm"),
    "hybrid": dict(arch="zamba2-7b", cfg={}, mesh="dm"),
}
POD = ("dense", "moe")
# batch-1 decode: the cache's sequence over ``data`` (dense: with the
# KV heads over ``model``; dense_rep: over (data, model)); the hybrid's
# shared attention the same, its mamba states replicated over the batch
BATCH_ONE = ("dense", "dense_rep", "hybrid")


def _init(cfg, seed):
    """The port's ``init_model`` in the reference's tree (numpy), every
    leaf that starts at zero (the conv biases, ``dt_bias``) drawn
    N(0, 0.1²) instead, so that a bias on the wrong shard shows."""
    tree = interop.lm_params_to_reference(
        T_T.init_model(cfg, seed=seed, device="cpu"))
    rng = np.random.default_rng(seed + 100)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        if not np.any(t):
            return (rng.standard_normal(t.shape) * 0.1).astype(t.dtype)
        return t
    return fill(tree)


def _cfgs(case):
    return (R_base.get_smoke_config(case["arch"]).replace(**case["cfg"]),
            T_base.get_smoke_config(case["arch"]).replace(**case["cfg"]))


def _inputs():
    rng = np.random.default_rng(0)
    out = {}
    for name, case in CASES.items():
        _, tc = _cfgs(case)
        p, V = _init(tc, 1), tc.vocab_size
        batches = [tuple(rng.integers(0, V, (4, 16)).astype(np.int32)
                         for _ in range(2)) for _ in range(2)]
        out[f"{name}/train"] = dict(case, job="train", params=p,
                                    batches=batches, lr=LR, min_size=1 << 10)
        prompt = rng.integers(0, V, (4, 8)).astype(np.int32)
        feed = rng.integers(0, V, (4, 3)).astype(np.int32)
        out[f"{name}/serve"] = dict(case, job="serve", params=p,
                                    prompt=prompt, feed=feed, max_len=16)
        if name in BATCH_ONE:
            out[f"{name}/serve1"] = dict(case, job="serve", params=p,
                                         prompt=prompt[:1], feed=feed[:1],
                                         max_len=16)
        if name in POD:
            clients = [_init(tc, 5 + i) for i in range(2)]
            out[f"{name}/pod"] = dict(
                case, job="pod", lr=LR, min_size=1 << 10, n_clients=2,
                stacked=jax.tree.map(lambda *xs: np.stack(xs), *clients),
                student=_init(tc, 9),
                embeds=rng.standard_normal((4, 8, tc.d_model)).astype(
                    np.float32))
    out["refuse"] = dict(CASES["dense"], job="refuse",
                         params=out["dense/train"]["params"])
    return out


def _start_world(tmp, inputs, n=4):
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen([sys.executable, WORKER, str(tmp), str(r),
                              str(n)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def _join_world(tmp, procs):
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    outs = []
    for r in range(len(procs)):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ref_train(case):
    rc, _ = _cfgs(case)
    params = _j(case["params"])
    state = {"params": params, "opt": R_optim.adam(LR).init(params),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(R_ST.make_train_step(rc, None, lr=LR, clip=1.0))
    hist, grads, m_prev = [], [], None
    for x, y in case["batches"]:
        state, m = step(state, {"tokens": jnp.asarray(x),
                                "labels": jnp.asarray(y)})
        hist.append({k: float(v) for k, v in m.items()})
        m_now = _np(state["opt"]["m"])
        grads.append(_grads(m_now, m_prev))
        m_prev = m_now
    return {"hist": hist, "params": _np(state["params"]),
            "adam_m": m_prev, "grads": grads}


def _grads(m_now, m_prev):
    """The (clipped) gradient a step gave Adam, from its first moments
    before and after."""
    if m_prev is None:
        return jax.tree.map(lambda m: m / (1 - B1), m_now)
    return jax.tree.map(lambda m, p: (m - B1 * p) / (1 - B1), m_now,
                        m_prev)


def _ref_serve(case):
    rc, _ = _cfgs(case)
    params = _j(case["params"])
    prompt, feed = case["prompt"], case["feed"]
    cache = R_T.init_cache(rc, prompt.shape[0], case["max_len"])
    pre = jax.jit(R_ST.make_prefill_step(rc, None))
    dec = jax.jit(R_ST.make_serve_step(rc, None))
    logits, cache = pre(params, cache, jnp.asarray(prompt))
    out = [np.asarray(logits)]
    for i in range(feed.shape[1]):
        logits, cache = dec(params, cache, jnp.asarray(feed[:, i:i + 1]),
                            jnp.int32(prompt.shape[1] + i))
        out.append(np.asarray(logits))
    return {"logits": out}


def _ref_pod(case):
    rc, _ = _cfgs(case)
    step = R_DL.make_pod_distill_step(
        rc, r_host_mesh(), n_clients=case["n_clients"], s_lr=LR,
        chunked_kl=False, distill_kl_mode="ref", kernel_vjp_mode="ref")
    p = _j(case["student"])
    state = {"params": p, "opt": R_optim.adam(LR).init(p),
             "step": jnp.zeros((), jnp.int32)}
    new, out = jax.jit(step)(state, _j(case["stacked"]),
                             jnp.asarray(case["embeds"]))
    return {"loss": float(out["dis_loss"]), "params": _np(new["params"]),
            "grads": [_grads(_np(new["opt"]["m"]), None)]}


REF = {"train": _ref_train, "serve": _ref_serve, "pod": _ref_pod}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partitioned")
    inputs = _inputs()
    procs = _start_world(tmp, inputs)
    ref = {k: REF[c["job"]](c) for k, c in inputs.items()
           if c["job"] in REF}
    return inputs, ref, _join_world(tmp, procs)


def _leaves(tree, path=""):
    if isinstance(tree, dict):                  # jax sorts a dict's keys
        for k, v in sorted(tree.items()):
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree, np.float64)


def _close_rel(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def _metrics(got, want):
    for h, w in zip(got["hist"], want["hist"], strict=True):
        for k in ("loss", "ce", "moe_aux", "grad_norm"):
            np.testing.assert_allclose(h[k], w[k], rtol=TOL, atol=1e-7,
                                       err_msg=k)


def _params(got, want, grads):
    """Each tensor within TOL_STEP of its largest entry wherever every
    step's gradient is above G_FLOOR (module doc)."""
    gs = [dict(_leaves(g)) for g in grads]
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True):
        big = np.all([np.abs(g[path]) > G_FLOOR for g in gs], axis=0)
        # the per-head scalars' gradients lie near the floor (ROADMAP.md
        # Queue 3): their first moments hold them
        assert big.mean() > 0.25 or path.endswith(PER_HEAD), path
        if not big.any():
            continue
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b)[big].max())
        assert err <= TOL_STEP * scale, (path, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_with_specs_matches_reference(runs, name):
    """Two train steps on this rank's shards (the batch over ``data``,
    the trunk over ``model``, ZeRO-1 moments), gathered back, against
    the reference's unsharded step: the metrics, Adam's first moments
    and the parameters; every rank the same."""
    _, ref, outs = runs
    want = ref[f"{name}/train"]
    for out in outs:
        got = out[f"{name}/train"]
        _metrics(got, want)
        for (path, a), (_, b) in zip(_leaves(got["adam_m"]),
                                     _leaves(want["adam_m"]), strict=True):
            _close_rel(a, b, TOL_STEP, path)
        _params(got["params"], want["params"], want["grads"])
    # the embedding is vocabulary-sharded: 512 rows over 2 model ranks
    assert outs[0][f"{name}/train"]["local_embed"][0] == 256


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_and_decode_with_specs_match_reference(runs, name):
    """Prefill 8 tokens of 4 sequences into a cache cut by
    ``cache_specs``, then 3 teacher-forced decode steps: every step's
    logits (the batch gathered back) against the reference's."""
    _, ref, outs = runs
    want = ref[f"{name}/serve"]["logits"]
    for out in outs:
        got = out[f"{name}/serve"]
        for a, b in zip(got["logits"], want, strict=True):
            _close_rel(a, b, TOL)
    specs = outs[0][f"{name}/serve"]["cache_specs"]
    if name == "dense_rep":                 # sequence over ``model``
        assert "P(None, 'data', 'model', None, None)" in specs, specs


@pytest.mark.parametrize("name", BATCH_ONE)
def test_batch_one_decode_over_sequence_sharded_cache(runs, name):
    """A global batch of one: the KV cache's sequence dim over ``data``
    (and ``model`` where attention is replicated); each rank attends over
    its slice and the slices combine flash-decode style."""
    _, ref, outs = runs
    want = ref[f"{name}/serve1"]["logits"]
    for out in outs:
        for a, b in zip(out[f"{name}/serve1"]["logits"], want, strict=True):
            _close_rel(a, b, TOL)
    specs = outs[0][f"{name}/serve1"]["cache_specs"]
    assert ("'data', 'model'" if name != "dense_rep"
            else "('data', 'model')") in specs, specs
    local = outs[0][f"{name}/serve1"]["local_cache"]
    kv = [v for k, v in local.items() if k.endswith("/k")]
    assert kv and all(s[-3] < 16 for s in kv), local


@pytest.mark.parametrize("name", POD)
def test_pod_step_with_specs_matches_reference(runs, name):
    """``make_pod_distill_step`` with the student state's specs, the
    stack's ``pod_stack_specs`` and the embeddings over ``data``: the
    vocabulary-parallel KL's loss and the student after its Adam step."""
    _, ref, outs = runs
    want = ref[f"{name}/pod"]
    for out in outs:
        got = out[f"{name}/pod"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
        _params(got["params"], want["params"], want["grads"])


def test_params_not_cut_to_their_specs_raise(runs):
    """A step given the full parameters where its specs name shards
    raises, and the fake world refuses to start beside the real one."""
    _, _, outs = runs
    for out in outs:
        got = out["refuse"]
        assert got["raised"] and "embed/table" in got["raised"], got
        assert got["fake_world"] and "gloo" in got["fake_world"], got
