"""The client mesh on CPU gloo worlds against the JAX package's unsharded
results on its one CPU device.

One world of two ranks (``tests/_mesh_worker.py``, two processes over a
file store) runs in turn: the all-reduce's gradient rule alone, the
sharded grouped teacher (four cnn1 clients sharded two a rank, a cnn2
singleton on both: the logits, L_BN over the per-client statistics and
the generator's gradient, whole and chunked), sharded local training
(``local_update_grouped``), the sharded tree FedAvg and a smoke DENSE
round with ``ensemble_shard_mode="clients"`` (grouped engine, uploads,
server). One world of one rank checks the routing
(``fl.sharding.resolve_mesh``, the axes) and that the sharded teacher
gives the unsharded one's results bit for bit there.

Tolerances: 1e-5 of the largest entry for what one call computes in
float32 (teacher, local training, FedAvg); the round end to end at
``tests/test_torch_round.py``'s 1e-3 and its uploads at its 1e-4. Every
rank must hold the same replicated results.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_cifar as R_cfg
from repro.core import ensemble as R_ens
from repro.core import generator as R_gen
from repro.core import losses as R_L
from repro.core.dense import train_dense_server as r_train
from repro.data import make_classification_data as r_make_data
from repro.data import pipeline as R_pipe
from repro.fl import client as R_client
from repro.fl import fedavg_stacked as r_fedavg_stacked
from repro.data.partition import dirichlet_partition as r_partition
from repro.fl.federation import train_clients_grouped as r_train_grouped
from repro.models import cnn as R_cnn

from repro_torch import interop
from repro_torch.configs import paper_cifar as T_cfg
from repro_torch.data import (build_batch_plan, make_classification_data,
                              pad_shards)
from repro_torch.models.cnn import CNNSpec, cnn_init

TOL = 1e-5
STEP_TOL = 1e-4         # tests/test_torch_round.py's
END_TOL = 1e-3
WORKER = os.path.join(os.path.dirname(__file__), "_mesh_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAMBDA_BN = 0.7
ROUND = dict(
    n_clients=4, alpha=0.5, local_epochs=1, batch_size=16, num_classes=4,
    image_size=8, in_ch=3, train_per_class=12, test_per_class=6,
    client_kinds=("cnn1",), global_kind="cnn1", width=0.25, nz=16, t_g=2,
    epochs=2, synth_batch=16, loop_mode="python", distill_kl_mode="ref",
    g_lr=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _rspec(kind):
    return R_cnn.CNNSpec(kind=kind, num_classes=4, in_ch=3, width=0.25,
                         image_size=8)


def _tspec(kind):
    return CNNSpec(kind=kind, num_classes=4, in_ch=3, width=0.25,
                   image_size=8)


def _init(kind, seed):
    """Weights in the reference's tree, drawn by the port's ``cnn_init``
    (the reference's eager init costs ~1 s a model)."""
    return interop.cnn_to_ref(cnn_init(
        _tspec(kind), generator=torch.Generator().manual_seed(seed),
        device="cpu"))


def _close_rel(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)),
                                                    1e-30), \
        (np.max(np.abs(got - want)), np.max(np.abs(want)))


def _world(tmp, inputs, n):
    """Run ``inputs`` on an n-rank gloo world; each rank's outputs."""
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, WORKER, str(tmp), str(r),
                               str(n)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(n)]


# --------------------------------------------------------- the reference --

@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(0)
    kinds = ("cnn1",) * 4 + ("cnn2",)
    clients = [R_ens.Client(spec=_rspec(k), params=_j(_init(k, i)),
                            n_data=10) for i, k in enumerate(kinds)]
    gspecs, gparams = R_ens.stack_grouped(clients)
    x = rng.uniform(-1, 1, (6, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, (6,))

    def loss(xx):
        avg, stats = R_ens.grouped_ensemble_logits(gspecs, gparams, xx,
                                                   with_bn_stats=True)
        l_ce, l_bn = R_L.ce_loss(avg, jnp.asarray(y)), R_L.bn_loss(stats)
        return l_ce + LAMBDA_BN * l_bn, (avg, l_ce, l_bn)

    (total, (avg, l_ce, l_bn)), gx = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jnp.asarray(x))
    teacher = dict(gspecs=gspecs, gparams=_np(gparams), x=x, y=y,
                   avg=np.asarray(avg), ce=float(l_ce), bn=float(l_bn),
                   total=float(total), gx=np.asarray(gx))

    # one stacked group's local phase: ragged shards, a padded plan
    sizes, bs = (37, 21, 30, 16), 8
    shards = [(rng.uniform(-1, 1, (n, 8, 8, 3)).astype(np.float32),
               rng.integers(0, 4, (n,))) for n in sizes]
    stacked = _np(gparams[0])
    xs, ys = R_pipe.pad_shards(shards)
    plan = R_pipe.build_batch_plan(list(sizes), bs, epochs=2,
                                   seeds=[3, 4, 5, 6])
    trained, info = R_client.local_update_grouped(
        jax.tree.map(jnp.asarray, stacked), _rspec("cnn1"), xs, ys, plan,
        lr=0.05, momentum=0.9, num_classes=4)
    local = dict(shards=shards, sizes=sizes, batch=bs, stacked=stacked,
                 trained=_np(trained), loss=np.asarray(info["loss"]))

    n_data = np.array([5, 9, 2, 7])
    fed = dict(n_data=n_data, avg=_np(r_fedavg_stacked(
        jax.tree.map(jnp.asarray, stacked), n_data, mode="tree",
        branch=2)))

    # a smoke round on the grouped engine, unsharded
    scfg = R_cfg.DenseExperimentConfig(**ROUND)
    data = r_make_data(0, num_classes=4, size=8, ch=3,
                       train_per_class=scfg.train_per_class,
                       test_per_class=scfg.test_per_class)
    spec = _rspec("cnn1")
    inits = [_init("cnn1", 10 + i) for i in range(scfg.n_clients)]
    x_tr, y_tr = data["train"]
    parts = r_partition(y_tr, scfg.n_clients, scfg.alpha, seed=0)
    rclients = r_train_grouped(
        [spec] * scfg.n_clients, [(x_tr[i], y_tr[i]) for i in parts],
        epochs=scfg.local_epochs, lr=scfg.local_lr,
        momentum=scfg.local_momentum, batch_size=scfg.batch_size,
        use_ldam=False, num_classes=4, seeds=list(range(scfg.n_clients)),
        init_params=[_j(p) for p in inits])
    skey = jax.random.PRNGKey(1)
    k_gen, _, k_epochs = jax.random.split(skey, 3)
    gen0 = _np(R_gen.img_generator_init(k_gen, nz=scfg.nz, img_size=8,
                                        out_ch=3))
    stu0 = _init("cnn1", 20)
    noise = []
    for ek in jax.random.split(k_epochs, scfg.epochs):
        kz, ky, _ = jax.random.split(ek, 3)
        noise.append((np.asarray(jax.random.normal(
            kz, (scfg.synth_batch, scfg.nz))),
            np.asarray(jax.random.randint(ky, (scfg.synth_batch,), 0, 4))))
    stu, _, hist = r_train(skey, rclients, scfg, student_params=_j(stu0))
    xt, _ = data["test"]
    rnd = dict(inits=inits, gen0=gen0, stu0=stu0, noise=noise, hist=hist,
               uploads=[_np(c.params) for c in rclients],
               logits=np.asarray(R_cnn.cnn_logits(stu, spec, xt)))
    return dict(teacher=teacher, local=local, fed=fed, round=rnd)


def _teacher_inputs(ref):
    t = ref["teacher"]
    gspecs, gparams = interop.grouped_from_reference(t["gspecs"],
                                                     t["gparams"],
                                                     device="cpu")
    return dict(gspecs=gspecs, gparams=gparams, x=t["x"], y=t["y"],
                lambda_bn=LAMBDA_BN)


def _stack_inputs(ref):
    _, gparams = interop.grouped_from_reference(
        [(_rspec("cnn1"), 4)], [ref["local"]["stacked"]], device="cpu")
    return gparams[0]


@pytest.fixture(scope="module")
def spmd(ref, tmp_path_factory):
    """The two-rank world's outputs, every job run on both ranks."""
    loc = ref["local"]
    xs, ys = pad_shards(loc["shards"])
    plan = build_batch_plan(list(loc["sizes"]), loc["batch"], epochs=2,
                            seeds=[3, 4, 5, 6])
    r = ref["round"]
    scfg = T_cfg.DenseExperimentConfig(**ROUND, ensemble_shard_mode="clients")
    spec = _tspec("cnn1")
    inputs = {
        "jobs": ["grad_rule", "teacher", "local", "fedavg", "round"],
        "grad_rule": {"x": np.arange(1.0, 5.0, dtype=np.float32)},
        "teacher": _teacher_inputs(ref),
        "local": dict(stacked=_stack_inputs(ref), spec=spec, xs=xs, ys=ys,
                      plan=plan, lr=0.05, momentum=0.9),
        "fedavg": dict(stacked=_stack_inputs(ref),
                       n_data=ref["fed"]["n_data"], branch=2),
        "round": dict(
            scfg=scfg,
            data=make_classification_data(
                0, num_classes=4, size=8, ch=3,
                train_per_class=scfg.train_per_class,
                test_per_class=scfg.test_per_class),
            inits=[interop.cnn_from_ref(p, spec, device="cpu")
                   for p in r["inits"]],
            gen=interop.generator_from_ref(r["gen0"], nz=scfg.nz,
                                           img_size=8, out_ch=3,
                                           device="cpu"),
            stu=interop.cnn_from_ref(r["stu0"], spec, device="cpu"),
            noise=[(torch.tensor(z), torch.tensor(y).long(),
                    torch.zeros((0, scfg.synth_batch, scfg.nz)))
                   for z, y in r["noise"]])}
    return _world(tmp_path_factory.mktemp("spmd"), inputs, 2)


@pytest.fixture(scope="module")
def solo(ref, tmp_path_factory):
    """A one-rank world: the routing, and the teacher sharded and not."""
    inputs = {"jobs": ["routing", "teacher"], "routing": {},
              "teacher": _teacher_inputs(ref)}
    return _world(tmp_path_factory.mktemp("solo"), inputs, 1)[0]


# ----------------------------------------------------------------- tests --

def test_one_rank_routing(solo):
    r = solo["routing"]
    assert r["none"] and r["same_mesh"]
    assert r["names"] == ("clients", "data")
    assert r["sizes"] == {"clients": 1, "data": 1}
    assert r["host"] == {"data": 1, "model": 1}
    assert r["dp_axes"] == ("data",)
    assert r["rows"] == (0, 4)
    assert r["shardable"] == [False, True, True, True]
    assert r["stacked"] == "(Shard(dim=0), Replicate())"
    assert r["replicated"] == "(Replicate(), Replicate())"


def test_one_rank_sharded_teacher_is_the_unsharded_one_bit_for_bit(solo):
    """On one rank every collective is a copy: logits, losses and
    statistics are bit for bit. So is the images' gradient without
    chunks; with chunks the slices' shares reach the images summed
    through the one all-reduce first, another float32 order than the
    unsharded path's, so they are held to 1e-6 of the largest entry."""
    t = solo["teacher"]
    for chunk in (0, 1):
        a, b = t["mesh", chunk], t["none", chunk]
        np.testing.assert_array_equal(a["avg"], b["avg"])
        assert [a[k] for k in ("bn", "ce", "total", "n_stats")] == \
            [b[k] for k in ("bn", "ce", "total", "n_stats")]
        if chunk:
            _close_rel(a["gx"], b["gx"], 1e-6)
        else:
            np.testing.assert_array_equal(a["gx"], b["gx"])


def test_all_reduce_gradient_rule(spmd):
    x = np.arange(1.0, 5.0, dtype=np.float32)
    for out in spmd:
        g = out["grad_rule"]
        # y = 3x over two ranks: d(Σy + Σx²)/dx = 3 + 2x, d(Σy²)/dx = 18x
        np.testing.assert_array_equal(g["lin"], 3 + 2 * x)
        np.testing.assert_array_equal(g["sq"], 18 * x)


@pytest.mark.parametrize("chunk", [0, 1])
def test_two_rank_sharded_teacher_matches_reference(ref, spmd, chunk):
    want = ref["teacher"]
    for out in spmd:
        got = out["teacher"]["mesh", chunk]
        assert got["n_stats"] == 5
        _close_rel(got["avg"], want["avg"])
        _close_rel(got["gx"], want["gx"])
        for k in ("ce", "bn", "total"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL)
    a, b = (o["teacher"]["mesh", chunk] for o in spmd)
    np.testing.assert_array_equal(a["gx"], b["gx"])
    np.testing.assert_array_equal(a["avg"], b["avg"])


def test_two_rank_sharded_local_training_matches_reference(ref, spmd):
    _, gparams = interop.grouped_from_reference(
        [(_rspec("cnn1"), 4)], [ref["local"]["trained"]], device="cpu")
    for out in spmd:
        got = out["local"]
        for k, v in gparams[0].items():
            _close_rel(got["stacked"][k], v.detach().numpy())
        _close_rel(got["loss"], ref["local"]["loss"])


def test_two_rank_sharded_tree_fedavg_matches_reference(ref, spmd):
    _, gparams = interop.grouped_from_reference(
        [(_rspec("cnn1"), 4)],
        [jax.tree.map(lambda a: a[None], ref["fed"]["avg"])], device="cpu")
    for out in spmd:
        for k, v in gparams[0].items():
            _close_rel(out["fedavg"][k], v[0].detach().numpy())


def test_two_rank_sharded_round_matches_reference(ref, spmd):
    want = ref["round"]
    for out in spmd:
        got = out["round"]
        for up, rp in zip(got["uploads"], want["uploads"], strict=True):
            for a, b in zip(jax.tree.leaves(up), jax.tree.leaves(rp),
                            strict=True):
                np.testing.assert_allclose(a, b, rtol=STEP_TOL,
                                           atol=STEP_TOL)
        h = want["hist"]
        np.testing.assert_allclose(got["gen_loss"], h.gen_loss, rtol=END_TOL,
                                   atol=END_TOL)
        np.testing.assert_allclose(got["dis_loss"], h.dis_loss, rtol=END_TOL,
                                   atol=END_TOL)
        for g, w in zip(got["gen_parts"], h.gen_parts, strict=True):
            for part in ("ce", "bn", "div"):
                np.testing.assert_allclose(g[part], w[part], rtol=END_TOL,
                                           atol=END_TOL)
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   rtol=END_TOL, atol=END_TOL)
    np.testing.assert_array_equal(spmd[0]["round"]["logits"],
                                  spmd[1]["round"]["logits"])
