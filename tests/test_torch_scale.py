"""The m = 1000 scaling layers (DESIGN.md §13) of the port against the
JAX package's, at smoke sizes on the CPU: bucketed plans, bucketed and
chunked local training, chunked stacking, the chunked teacher and tree
FedAvg.

What is held:

  * ``bucket_members``, ``plan_step_waste`` and
    ``build_batch_plan(steps_per_epoch=)``: the reference's, exactly,
    on long-tailed shard sizes and on an m = 1000 Dirichlet (α 0.1)
    partition, which must terminate; bucketing cuts the padded-step
    waste at least 3x there;
  * ``local_update_bucketed`` from the reference's inits against the
    reference's (1e-4, as tests/test_torch_grouped.py holds the grouped
    engine), and the port's bucketed and chunked runs against its own
    single-plan run: 1e-6 of each entry (another number of stacked
    clients in a grouped convolution may round otherwise), in member
    order;
  * ``stack_grouped(chunk=)``: bit for bit, in the same layout;
  * the chunked teacher against the reference's chunked and unchunked
    teacher: logits, BN statistics and the image gradient to 1e-5, with
    a tail chunk and a chunk at or above the group's size;
  * tree FedAvg against the reference's tree and flat FedAvg, with and
    without a survivor mask (1e-6);
  * survivor masks compose with bucketed training: masked FedAvg over a
    bucketed, chunked federation is masked FedAvg over the single-plan
    one (the reference's ``test_quarantine_composes_with_bucketed_
    training``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_cifar as R_cfg
from repro.configs.backend import resolve_exec_policy as r_resolve
from repro.core import ensemble as R_ens
from repro.data import partition as R_part
from repro.data import pipeline as R_pipe
from repro.fl import fedavg_stacked as r_fedavg_stacked
from repro.fl.client import local_update_bucketed as r_bucketed
from repro.models import cnn as R_cnn

from repro_torch import interop
from repro_torch.configs import backend
from repro_torch.configs import paper_cifar as T_cfg
from repro_torch.core import Client, grouped_ensemble_logits, stack_grouped
from repro_torch.data import (bucket_members, build_batch_plan,
                              dirichlet_partition, plan_step_waste)
from repro_torch.fl import (admit_uploads, fedavg_stacked,
                            local_update_bucketed, train_clients_grouped)
from repro_torch.models import cnn as T_cnn

TOL = 1e-4
SELF_TOL = 1e-6
TEACHER_TOL = 1e-5
FEDAVG_TOL = 1e-6
R_SPEC = R_cnn.CNNSpec(kind="cnn1", num_classes=4, in_ch=1, width=0.25,
                       image_size=8)
T_SPEC = T_cnn.CNNSpec(kind="cnn1", num_classes=4, in_ch=1, width=0.25,
                       image_size=8)
# long-tailed shard sizes, as Dirichlet α ≤ 0.1 gives them
SKEWED = [530, 410, 61, 55, 48, 40, 33, 29, 21, 17, 13, 11, 9, 7, 5, 3]
SIZES = [37, 21, 130, 5, 64, 12]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _shards(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, 8, 8, 1)).astype(np.float32),
             rng.integers(0, 4, n)) for n in sizes]


def _inits(m, seed=0):
    """m cnn1 inits as reference trees (numpy)."""
    g = torch.Generator().manual_seed(seed)
    return [interop.cnn_to_ref(T_cnn.cnn_init(T_SPEC, generator=g,
                                              device="cpu"))
            for _ in range(m)]


def _to_ref(stacked, m):
    return interop.grouped_to_reference([(T_SPEC, m)], [stacked])[1][0]


def _close_trees(got, want, tol):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _m1000_sizes():
    y = np.random.default_rng(0).integers(0, 10, 50_000)
    return dirichlet_partition(y, 1000, 0.1, seed=0), y


# -------------------------------------------------------------- bucketing --

@pytest.mark.parametrize("mode", ["off", "pow2", "quantile"])
@pytest.mark.parametrize("batch", [16, 64])
def test_bucket_members_and_waste_are_the_references(mode, batch):
    assert bucket_members(SKEWED, batch, mode) == \
        R_pipe.bucket_members(SKEWED, batch, mode)
    assert plan_step_waste(SKEWED, batch, mode) == \
        R_pipe.plan_step_waste(SKEWED, batch, mode)


def test_m1000_dirichlet_partition_buckets_as_the_reference():
    """An m = 1000 Dirichlet (α 0.1) partition of 50,000 labels (the
    scale phase's): it terminates, equals the reference's, and both
    bucketing modes cut the padded-step waste at least 3x at batch 64,
    with the reference's buckets and waste."""
    parts, y = _m1000_sizes()
    want = R_part.dirichlet_partition(y, 1000, 0.1, seed=0)
    assert len(parts) == len(want) == 1000
    for a, b in zip(parts, want):
        np.testing.assert_array_equal(a, b)
    sizes = [len(p) for p in parts]
    assert sum(sizes) == 50_000 and min(sizes) >= 2
    base = plan_step_waste(sizes, 64, "off")
    for mode in ("pow2", "quantile"):
        assert bucket_members(sizes, 64, mode) == \
            R_pipe.bucket_members(sizes, 64, mode)
        waste = plan_step_waste(sizes, 64, mode)
        assert waste == R_pipe.plan_step_waste(sizes, 64, mode)
        assert waste <= base / 3.0, (mode, waste, base)


def test_bucketed_plans_are_the_references():
    sizes, batch, seeds = [37, 21, 130, 5], 16, [11, 12, 13, 14]
    for members in bucket_members(sizes, batch, "pow2"):
        nb = max(-(-sizes[j] // batch) for j in members)
        args = ([sizes[j] for j in members], batch)
        kw = dict(epochs=2, seeds=[seeds[j] for j in members],
                  steps_per_epoch=nb + 1)
        got, want = build_batch_plan(*args, **kw), \
            R_pipe.build_batch_plan(*args, **kw)
        np.testing.assert_array_equal(got.idx, want.idx)
        np.testing.assert_array_equal(got.mask, want.mask)
        assert got.steps_per_epoch == want.steps_per_epoch == nb + 1


# ------------------------------------------- bucketed and chunked training --

@pytest.fixture(scope="module")
def bucketed_runs():
    shards = _shards(SIZES, seed=3)
    seeds = list(range(20, 26))
    inits = _inits(len(SIZES), seed=4)
    counts = np.stack([np.bincount(y, minlength=4) for _, y in shards])
    kw = dict(batch_size=16, epochs=2, seeds=seeds, use_ldam=False,
              num_classes=4, class_counts=counts)

    def port(bucketing, chunk):
        return local_update_bucketed(
            lambda j: interop.cnn_from_ref(inits[j], T_SPEC, device="cpu"),
            T_SPEC, shards, bucketing=bucketing, chunk=chunk, **kw)

    ref = r_bucketed(lambda j: jax.tree.map(jnp.asarray, inits[j]), R_SPEC,
                     shards, bucketing="quantile", chunk=3, **kw)
    return {"port": port, "ref": _np(ref), "off": port("off", 0)}


def test_bucketed_update_matches_the_references(bucketed_runs):
    got = bucketed_runs["port"]("quantile", 3)
    _close_trees(_to_ref(got, len(SIZES)), bucketed_runs["ref"], TOL)


@pytest.mark.parametrize("bucketing,chunk", [("off", 2), ("pow2", 0),
                                             ("pow2", 2), ("quantile", 3)])
def test_bucketed_update_matches_the_single_plan(bucketed_runs, bucketing,
                                                 chunk):
    off = bucketed_runs["off"]
    got = bucketed_runs["port"](bucketing, chunk)
    assert got.keys() == off.keys()
    for k, v in off.items():
        assert got[k].shape == v.shape and got[k].stride() == v.stride()
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   v.detach().numpy(), rtol=SELF_TOL,
                                   atol=SELF_TOL)


def test_stack_grouped_chunked_is_bit_for_bit():
    models = [interop.cnn_from_ref(p, T_SPEC, device="cpu")
              for p in _inits(5, seed=6)]
    clients = [Client(spec=T_SPEC, model=m, n_data=10) for m in models]
    _, full = stack_grouped(clients)
    for chunk in (1, 2, 3, 5, 9):
        _, chunked = stack_grouped(clients, chunk=chunk)
        for k, v in full[0].items():
            assert torch.equal(chunked[0][k], v)
            assert chunked[0][k].stride() == v.stride()


# --------------------------------------------------------- chunked teacher --

@pytest.fixture(scope="module")
def teacher_inputs():
    inits = _inits(5, seed=7)
    rclients = [R_ens.Client(spec=R_SPEC, params=jax.tree.map(jnp.asarray,
                                                              p))
                for p in inits]
    rgspecs, rgparams = R_ens.stack_grouped(rclients)
    gspecs, gparams = interop.grouped_from_reference(
        rgspecs, _np(rgparams), device="cpu")
    x = np.random.default_rng(9).uniform(-1, 1, (6, 8, 8, 1)).astype(
        np.float32)
    return (rgspecs, rgparams), (gspecs, gparams), x, \
        _ref_teacher((rgspecs, rgparams), x, None)


def _ref_teacher(rg, x, chunk):
    """The reference's logits, stats and image gradient of
    Σ log_softmax(logits)²."""
    rgspecs, rgparams = rg

    def loss(xx):
        lg, st = R_ens.grouped_ensemble_logits(rgspecs, rgparams, xx,
                                               with_bn_stats=True,
                                               chunk=chunk)
        return jnp.sum(jax.nn.log_softmax(lg) ** 2), (lg, st)

    (_, (lg, st)), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(x))
    return np.asarray(lg), _np(st), np.asarray(grad)


def _port_teacher(tg, x, chunk):
    gspecs, gparams = tg
    xx = torch.from_numpy(x).requires_grad_(True)
    lg, st = grouped_ensemble_logits(gspecs, gparams, xx,
                                     with_bn_stats=True, chunk=chunk)
    loss = (torch.log_softmax(lg, -1) ** 2).sum()
    grad, = torch.autograd.grad(loss, xx)
    return lg.detach().numpy(), st, grad.numpy()


def _close_rel(got, want, tol=TEACHER_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("chunk", [2, 3, 5, 16])
def test_chunked_teacher_matches_the_references(teacher_inputs, chunk):
    """Chunks of 2 and 3 over 5 clients leave a tail; 5 and 16 are at or
    above the group's size (the unchunked path). Each against the
    reference's chunked teacher and its unchunked one."""
    rg, tg, x, ref_unchunked = teacher_inputs
    lg, st, grad = _port_teacher(tg, x, chunk)
    unchunked = _port_teacher(tg, x, 0)
    for want in (_ref_teacher(rg, x, chunk), ref_unchunked):
        w_lg, w_st, w_grad = want
        _close_rel(lg, w_lg)
        _close_rel(grad, w_grad)
        assert len(st) == len(w_st) == 5
        for gs, ws in zip(st, w_st):
            for g, w in zip(gs, ws, strict=True):
                for k in g:
                    _close_rel(g[k], w[k])
    _close_rel(lg, unchunked[0])
    _close_rel(grad, unchunked[2])


def test_chunked_teacher_without_grad_or_stats(teacher_inputs):
    """The student step's teacher (no gradient, BN folded) chunked."""
    rg, tg, x, _ = teacher_inputs
    want = jax.jit(lambda p, xx: R_ens.grouped_ensemble_logits(
        rg[0], p, xx, chunk=2))(rg[1], jnp.asarray(x))
    with torch.no_grad():
        got = grouped_ensemble_logits(*tg, torch.from_numpy(x), chunk=2)
    _close_rel(got, np.asarray(want))


# ------------------------------------------------------------- tree FedAvg --

def _stack_pair(m, seed):
    rng = np.random.default_rng(seed)
    inits = _inits(m, seed=seed)
    ref = jax.tree.map(lambda *a: np.stack(a), *inits)
    port = interop.grouped_from_reference([(R_SPEC, m)], [ref],
                                          device="cpu")[1][0]
    return ref, port, rng.integers(1, 500, m).tolist()


@pytest.mark.parametrize("branch", [2, 3, 8, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_tree_fedavg_matches_the_references(branch, masked):
    ref, port, n_data = _stack_pair(13, seed=10)
    mask = np.array([True, False, True, True, True, False, True, True,
                     True, True, False, True, True]) if masked else None
    got = fedavg_stacked(port, n_data, survivor_mask=mask, mode="tree",
                         branch=branch)
    got = interop.cnn_to_ref(T_cnn.cnn_view(T_SPEC, got))
    for want in (r_fedavg_stacked(ref, n_data, survivor_mask=mask,
                                  mode="tree", branch=branch),
                 r_fedavg_stacked(ref, n_data, survivor_mask=mask)):
        _close_trees(got, _np(want), FEDAVG_TOL)
    flat = fedavg_stacked(port, n_data, survivor_mask=mask)
    _close_trees(got, interop.cnn_to_ref(T_cnn.cnn_view(T_SPEC, flat)),
                 FEDAVG_TOL)


def test_fedavg_unknown_mode_raises():
    _, port, n_data = _stack_pair(2, seed=11)
    with pytest.raises(ValueError):
        fedavg_stacked(port, n_data, mode="nope")


# ------------------------------------------ survivor masks and buckets ----

def test_quarantine_composes_with_bucketed_training():
    """Survivor masks act on the member order the bucketed engine
    restores: masked tree FedAvg over a bucketed, chunked federation is
    masked flat FedAvg over the single-plan one, and the reference's
    policy resolves the same knobs."""
    m = len(SIZES)
    shards = _shards(SIZES, seed=13)
    inits = [interop.cnn_from_ref(p, T_SPEC, device="cpu")
             for p in _inits(m, seed=14)]
    kw = dict(epochs=1, lr=0.05, momentum=0.9, batch_size=16,
              use_ldam=False, num_classes=4, seeds=list(range(m)),
              init_models=inits)
    knobs = dict(plan_bucketing="pow2", stack_chunk=2, fedavg_mode="tree",
                 fedavg_branch=2)
    pol = backend.resolve_exec_policy(T_cfg.DenseExperimentConfig(**knobs),
                                      device="cpu")
    rpol = r_resolve(R_cfg.DenseExperimentConfig(**knobs), backend="cpu")
    assert (pol.bucketing, pol.stack_chunk, pol.fedavg,
            pol.fedavg_branch) == (rpol.bucketing, rpol.stack_chunk,
                                   rpol.fedavg, rpol.fedavg_branch)
    ref = train_clients_grouped([T_SPEC] * m, shards, **kw)
    buck = train_clients_grouped([T_SPEC] * m, shards, **kw, policy=pol)
    for k, v in ref.grouped[1][0].items():
        np.testing.assert_allclose(buck.grouped[1][0][k].detach().numpy(),
                                   v.detach().numpy(), rtol=SELF_TOL,
                                   atol=SELF_TOL)
    arrived = np.array([True, True, False, True, True, True])
    aref = admit_uploads(ref, arrived=arrived)
    abuck = admit_uploads(buck, arrived=arrived)
    np.testing.assert_array_equal(aref.survivor_mask, abuck.survivor_mask)
    fa = fedavg_stacked(aref.grouped[1][0], [c.n_data for c in aref],
                        survivor_mask=aref.survivor_mask)
    fb = fedavg_stacked(abuck.grouped[1][0], [c.n_data for c in abuck],
                        survivor_mask=abuck.survivor_mask,
                        mode=pol.fedavg, branch=pol.fedavg_branch)
    for k, v in fa.items():
        np.testing.assert_allclose(fb[k].numpy(), v.numpy(),
                                   rtol=FEDAVG_TOL, atol=FEDAVG_TOL)
