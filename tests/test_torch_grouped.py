"""The port's grouped engine and grouped teacher against the JAX
package's own grouped functions, at smoke sizes on the CPU.

The reference's inits are carried across with ``repro_torch.interop``
(``grouped_from_reference`` for its stacked groups); data and masks come
from numpy seeds. What is held:

  * ``build_batch_plan`` and ``pad_shards``: bit for bit;
  * ``masked_batch_moments`` and masked train-mode BN: 1e-5;
  * the grouped eval forward (conv-stack cnn1 and wrn16_1, below and
    above the reference's im2col batch switch of 32, with and without
    stats; without stats eval BN is folded into the convs on both
    sides) and the grouped train forward (cnn1 against the reference's
    ``cnn_stack_train_grouped``, wrn16_1 against its vmapped
    ``cnn_apply``): 1e-4;
  * ``local_update_grouped`` on ragged shards (37 and 21 at batch 16),
    CE and LDAM: 1e-4, as tests/test_federation.py holds the
    reference's grouped engine to its per-client one;
  * the grouped teacher with stats, ``bn_loss`` on it, and one
    ``gen_step`` and one student step over it: 1e-4 (gradients relative
    to their largest entry);
  * ``stack_grouped`` / ``apply_group_masks`` on hand-made masks and
    ``fedavg_stacked`` with a survivor mask: exact, and 1e-6;
  * a heterogeneous ``build_federation`` (cnn1, cnn2, cnn1), the grouped
    engine against the port's own per-client one: the same uploads, one
    round and no downlink, params to 1e-4, and ``stack_grouped`` handing
    back the engine's own tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_cifar as R_cfg
from repro.core import ensemble as R_ens
from repro.core import generator as R_gen
from repro.core import losses as R_L
from repro.core.dense import make_dense_steps as r_make_steps
from repro.data import pipeline as R_pipe
from repro.fl import client as R_client
from repro.fl import fedavg_stacked as r_fedavg_stacked
from repro.models import cnn as R_cnn
from repro.models import layers as R_layers

from repro_torch import interop, optim
from repro_torch.configs import backend
from repro_torch.configs import paper_cifar as T_cfg
from repro_torch.core import (Client, bn_loss, ensemble_logits,
                              grouped_ensemble_logits, img_generator_init,
                              make_dense_steps, stack_grouped)
from repro_torch.core.ensemble import apply_group_masks
from repro_torch.data import (build_batch_plan, make_classification_data,
                              pad_shards)
from repro_torch.fl import (ClientList, CommLedger, build_federation,
                            fedavg, fedavg_stacked, local_update_grouped,
                            param_bytes)
from repro_torch.models import cnn as T_cnn
from repro_torch.models import layers as T_layers

TOL = 1e-4
MOMENT_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rspec(kind, in_ch=3, width=0.25):
    return R_cnn.CNNSpec(kind=kind, num_classes=4, in_ch=in_ch, width=width,
                         image_size=8)


def _tspec(kind, in_ch=3, width=0.25):
    return T_cnn.CNNSpec(kind=kind, num_classes=4, in_ch=in_ch, width=width,
                         image_size=8)


def _port_models(kinds, seed=0, in_ch=3):
    """Port inits of ``kinds``, running statistics moved off their init
    by one train-mode batch."""
    g = torch.Generator().manual_seed(seed)
    x = torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (24, 8, 8, in_ch)).astype(np.float32))
    models = [T_cnn.cnn_init(_tspec(k, in_ch), generator=g, device="cpu")
              for k in kinds]
    with torch.no_grad():
        for model in models:
            T_cnn.cnn_apply(model, x, train=True)
    return models


def _ref_stack(kind, m, seed=0, in_ch=3):
    """m inits of ``kind`` (``_port_models``) as a reference stack."""
    rows = [interop.cnn_to_ref(p) for p in _port_models([kind] * m, seed,
                                                        in_ch)]
    return jax.tree.map(lambda *a: np.stack(a), *rows)


def _port_stack(kind, tree, in_ch=3):
    _, gparams = interop.grouped_from_reference(
        [(_rspec(kind, in_ch), jax.tree.leaves(tree)[0].shape[0])], [tree],
        device="cpu")
    return gparams[0]


def _close(got, want, tol=TOL, rel_to_max=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    atol = tol * np.abs(want).max() if rel_to_max else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _close_trees(got, want, tol=TOL):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


# ------------------------------------------------------------ pipeline --

@pytest.mark.parametrize("sizes,batch,epochs,spe", [
    ([37, 16, 20], 8, 3, None), ([37, 21], 16, 2, None),
    ([9, 40, 1], 16, 2, 5), ([5], 4, 1, None)])
def test_batch_plan_is_the_references(sizes, batch, epochs, spe):
    seeds = [11 + i for i in range(len(sizes))]
    got = build_batch_plan(sizes, batch, epochs=epochs, seeds=seeds,
                           steps_per_epoch=spe)
    want = R_pipe.build_batch_plan(sizes, batch, epochs=epochs, seeds=seeds,
                                   steps_per_epoch=spe)
    np.testing.assert_array_equal(got.idx, want.idx)
    np.testing.assert_array_equal(got.mask, want.mask)
    assert (got.steps, got.steps_per_epoch, got.epochs, got.batch_size) == \
        (want.steps, want.steps_per_epoch, want.epochs, want.batch_size)


@pytest.mark.parametrize("pad_to", [None, 50])
def test_pad_shards_is_the_references(pad_to):
    rng = np.random.default_rng(1)
    shards = [(rng.standard_normal((n, 8, 8, 3)).astype(np.float32),
               rng.integers(0, 4, n)) for n in (37, 21, 5)]
    for a, b in zip(pad_shards(shards, pad_to=pad_to),
                    R_pipe.pad_shards(shards, pad_to=pad_to)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_batch_plan_refuses_too_few_steps():
    with pytest.raises(ValueError):
        build_batch_plan([37], 8, epochs=1, seeds=[0], steps_per_epoch=2)
    with pytest.raises(ValueError):
        pad_shards([(np.zeros((4, 2)), np.zeros(4, int))], pad_to=3)


# ----------------------------------------------------- masked moments ---

@pytest.mark.parametrize("valid", [16, 9, 1, 0])
def test_masked_batch_moments(valid):
    rng = np.random.default_rng(valid)
    x = rng.standard_normal((16, 5, 6, 7)).astype(np.float32) * 3 + 1
    mask = np.arange(16) < valid
    rng.shuffle(mask)
    want = R_layers.masked_batch_moments(jnp.asarray(x), jnp.asarray(mask))
    got = T_layers.masked_batch_moments(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(mask))
    for g, w in zip(got, want):
        _close(g, w, MOMENT_TOL)


@pytest.mark.parametrize("valid", [(16, 9, 1), (0, 16, 5)])
def test_masked_batch_moments_per_client(valid):
    """An (m, B) mask over m clients' channels side by side: each
    client's moments over its own rows, as the reference takes them
    client by client."""
    m, c = len(valid), 4
    rng = np.random.default_rng(sum(valid))
    x = rng.standard_normal((16, 6, 7, m * c)).astype(np.float32) * 3 + 1
    mask = np.stack([rng.permutation(np.arange(16) < v) for v in valid])
    mu, var = T_layers.masked_batch_moments(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(mask))
    assert mu.shape == var.shape == (m, c)
    for j in range(m):
        want = R_layers.masked_batch_moments(
            jnp.asarray(x[..., j * c:(j + 1) * c]), jnp.asarray(mask[j]))
        _close(mu[j], want[0], MOMENT_TOL)
        _close(var[j], want[1], MOMENT_TOL)


@pytest.mark.parametrize("kind", ["cnn1", "wrn16_1"])
def test_masked_train_bn_matches(kind):
    """cnn_apply(train=True, sample_mask=...): the valid rows' logits,
    the new running statistics and the recorded moments."""
    tree = jax.tree.map(lambda a: a[0], _ref_stack(kind, 1, seed=2))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (12, 8, 8, 3)).astype(np.float32)
    mask = np.arange(12) < 7
    lg, new, stats = jax.jit(R_cnn.cnn_apply, static_argnums=1,
                             static_argnames="train")(
        tree, _rspec(kind), x, train=True, sample_mask=jnp.asarray(mask))
    model = interop.cnn_from_ref(tree, _tspec(kind), device="cpu")
    got, got_stats = T_cnn.cnn_apply(model, torch.from_numpy(x), train=True,
                                     sample_mask=torch.from_numpy(mask))
    _close(got[:7], np.asarray(lg)[:7], MOMENT_TOL)
    _close_trees(interop.cnn_to_ref(model), _np(new), MOMENT_TOL)
    for g, w in zip(got_stats, stats, strict=True):
        _close(g["mean"], w["mean"], MOMENT_TOL)
        _close(g["var"], w["var"], MOMENT_TOL)


# ----------------------------------------------------- grouped forwards --

@pytest.fixture(scope="module")
def stacks():
    return {kind: _ref_stack(kind, 3, seed=4) for kind in ("cnn1",
                                                          "wrn16_1")}


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("batch", [8, 40])
@pytest.mark.parametrize("kind", ["cnn1", "wrn16_1"])
def test_stack_apply_grouped_matches(stacks, kind, batch, with_stats):
    tree = stacks[kind]
    x = np.random.default_rng(batch).uniform(
        -1, 1, (batch, 8, 8, 3)).astype(np.float32)
    lg, stats = jax.jit(R_cnn.cnn_stack_apply_grouped, static_argnums=(1, 3),
                        static_argnames="with_stats")(
        tree, _rspec(kind), x, 3, with_stats=with_stats)
    got, got_stats = T_cnn.cnn_stack_apply_grouped(
        _port_stack(kind, tree), _tspec(kind), torch.from_numpy(x), 3,
        with_stats=with_stats)
    assert got.shape == (3, batch, 4)
    _close(got, lg)
    assert len(got_stats) == len(stats)
    for g, w in zip(got_stats, stats):
        for k in ("mean", "var", "running_mean", "running_var"):
            _close(g[k], w[k])


@pytest.mark.parametrize("kind", ["cnn1", "wrn16_1"])
def test_stack_train_grouped_matches(stacks, kind):
    """cnn1 against the reference's cnn_stack_train_grouped; wrn16_1
    against its vmapped cnn_apply, which its grouped engine trains
    residual kinds with."""
    tree = stacks[kind]
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (3, 10, 8, 8, 3)).astype(np.float32)
    mask = np.ones((3, 10), bool)
    mask[1, 6:] = False
    mask[2, 1:] = False
    spec = _rspec(kind)
    if kind == "cnn1":
        lg, new, stats = jax.jit(R_cnn.cnn_stack_train_grouped,
                                 static_argnums=1)(tree, spec, x, mask)
    else:
        lg, new, stats = jax.jit(jax.vmap(
            lambda p, xk, mk: R_cnn.cnn_apply(p, spec, xk, train=True,
                                              sample_mask=mk)))(
            tree, x, mask)
    stacked = _port_stack(kind, tree)
    got, new_stats, got_stats = T_cnn.cnn_stack_train_grouped(
        stacked, _tspec(kind), torch.from_numpy(x), torch.from_numpy(mask))
    for k in range(3):
        _close(got[k][mask[k]], np.asarray(lg)[k][mask[k]])
    want = dict(interop._flatten(_np(new)))
    assert set(new_stats) == {k for k in want
                              if k.endswith((".bn.mean", ".bn.var"))}
    for name, v in new_stats.items():
        _close(v, want[name])
    for g, w in zip(got_stats, stats, strict=True):
        _close(g["mean"], w["mean"])
        _close(g["var"], w["var"])


# ------------------------------------------------- grouped local update --

@pytest.fixture(scope="module")
def ragged():
    rng = np.random.default_rng(2)
    shards = [(rng.standard_normal((n, 8, 8, 1)).astype(np.float32),
               rng.integers(0, 4, n)) for n in (37, 21)]
    inits = [interop.cnn_to_ref(m)
             for m in _port_models(["cnn1"] * 2, seed=3, in_ch=1)]
    return shards, inits


@pytest.mark.parametrize("use_ldam", [False, True])
def test_local_update_grouped_matches(ragged, use_ldam):
    shards, inits = ragged
    xs, ys = pad_shards(shards)
    plan = build_batch_plan([37, 21], 16, epochs=2, seeds=[11, 12])
    counts = np.stack([np.bincount(y, minlength=4) for _, y in shards])
    stacked0 = jax.tree.map(lambda *a: jnp.stack(a), *inits)
    want, info = R_client.local_update_grouped(
        stacked0, _rspec("cnn1", 1), xs, ys, plan, use_ldam=use_ldam,
        num_classes=4, class_counts=counts)
    stacked = _port_stack("cnn1", jax.tree.map(
        lambda *a: np.stack(a), *inits), in_ch=1)
    got, got_info = local_update_grouped(
        stacked, _tspec("cnn1", 1), xs, ys, plan, use_ldam=use_ldam,
        num_classes=4, class_counts=counts)
    assert got is stacked and got_info["loss"].shape == (plan.steps, 2)
    _close(got_info["loss"], info["loss"])
    # client 1's fourth step of each epoch is padding: loss 0
    assert float(got_info["loss"][2, 1]) == 0.0
    _, gparams = interop.grouped_to_reference(
        [(_tspec("cnn1", 1), 2)], [got])
    _close_trees(gparams[0], _np(want))


def test_padding_steps_pass_through():
    """A client with no valid row in a step keeps its params, momentum
    and running statistics bit for bit."""
    from repro_torch.fl.client import make_grouped_local_update

    spec = _tspec("cnn1", 1)
    g = torch.Generator().manual_seed(0)
    stacked = T_cnn.stack_models([T_cnn.cnn_init(spec, generator=g,
                                                 device="cpu")
                                  for _ in range(2)])
    before = {k: v.detach().clone() for k, v in stacked.items()}
    step, opt = make_grouped_local_update(spec, stacked, lr=0.1,
                                          momentum=0.9)
    x = torch.randn(2, 4, 8, 8, 1)
    mask = torch.tensor([[True] * 4, [False] * 4])
    loss = step(x, torch.zeros(2, 4, dtype=torch.long), mask,
                np.array([True, False]))
    assert float(loss[1]) == 0.0 and float(loss[0]) > 0.0
    for k, v in stacked.items():
        assert torch.equal(v[1], before[k][1]), k
    assert any(not torch.equal(v[0], before[k][0]) for k, v in
               stacked.items())
    assert all(float(b[1].abs().max()) == 0.0 for b in opt.bufs)


# ------------------------------------------------------ grouped teacher --

@pytest.fixture(scope="module")
def hetero():
    """The reference's grouped representation of (cnn1, cnn2, cnn1,
    cnn1): a stacked cnn1 group of 3 and a cnn2 singleton."""
    kinds = ("cnn1", "cnn2", "cnn1", "cnn1")
    clients = [R_ens.Client(spec=_rspec(k), params=jax.tree.map(
        jnp.asarray, interop.cnn_to_ref(m)), n_data=10 + i)
        for i, (k, m) in enumerate(zip(kinds, _port_models(kinds, 7)))]
    return clients, R_ens.stack_grouped(clients)


def _port_grouped(hetero):
    gspecs, gparams = interop.grouped_from_reference(
        hetero[1][0], _np(hetero[1][1]), device="cpu")
    return gspecs, gparams


def test_grouped_ensemble_logits_with_stats_and_bn_loss(hetero):
    x = np.random.default_rng(8).uniform(-1, 1, (16, 8, 8, 3)
                                         ).astype(np.float32)
    rgspecs, rgparams = hetero[1]
    avg, stats = jax.jit(lambda p, xx: R_ens.grouped_ensemble_logits(
        rgspecs, p, xx, with_bn_stats=True))(rgparams, x)
    gspecs, gparams = _port_grouped(hetero)
    got, got_stats = grouped_ensemble_logits(gspecs, gparams,
                                             torch.from_numpy(x),
                                             with_bn_stats=True)
    _close(got, avg)
    assert len(got_stats) == len(stats) == 4
    for gs, ws in zip(got_stats, stats):
        for g, w in zip(gs, ws, strict=True):
            for k in g:
                _close(g[k], w[k])
    _close(bn_loss(got_stats), R_L.bn_loss(stats))
    # without stats the groups fold BN into their convs: held to the
    # looped oracle on the same weights
    models = [p for p in gparams if isinstance(p, T_cnn.CNN)] + \
        T_cnn.client_views(gspecs[0][0], gparams[0])
    _close(grouped_ensemble_logits(gspecs, gparams, torch.from_numpy(x)),
           ensemble_logits(models, torch.from_numpy(x)).detach().numpy())


def test_stack_grouped_and_masks_match_reference(hetero):
    clients, (rgspecs, rgparams) = hetero
    gspecs, gparams = _port_grouped(hetero)
    assert [(s.kind, n) for s, n in gspecs] == [("cnn1", 3), ("cnn2", 1)]
    masks = [np.array([True, False, True]), None]
    want = R_ens.apply_group_masks(rgspecs, rgparams, masks)
    got = apply_group_masks(gspecs, gparams, masks)
    assert [n for _, n in got[0]] == [n for _, n in want[0]] == [2, 1]
    _close_trees(interop.grouped_to_reference(*got)[1], _np(want[1]), 0)
    # a group reduced to one becomes a singleton; one reduced to none goes
    masks = [np.array([False, True, False]), np.array([False])]
    want = R_ens.apply_group_masks(rgspecs, rgparams, masks)
    got = apply_group_masks(gspecs, gparams, masks)
    assert [n for _, n in got[0]] == [n for _, n in want[0]] == [1]
    assert isinstance(got[1][0], T_cnn.CNN)
    _close_trees(interop.grouped_to_reference(*got)[1], _np(want[1]), 0)
    # a per-client federation is stacked in group order, singletons kept
    views = T_cnn.client_views(gspecs[0][0], gparams[0])
    port_clients = [Client(spec=gspecs[0][0], model=views[0]),
                    Client(spec=gspecs[1][0], model=gparams[1]),
                    Client(spec=gspecs[0][0], model=views[1]),
                    Client(spec=gspecs[0][0], model=views[2])]
    s_specs, s_params = stack_grouped(port_clients)
    assert s_specs == gspecs and s_params[1] is gparams[1]
    _close_trees(interop.grouped_to_reference(s_specs, s_params)[1],
                 _np(rgparams), 0)
    # stacked in slices of two clients: the same tensors, bit for bit
    c_specs, c_params = stack_grouped(port_clients, chunk=2)
    assert c_specs == gspecs and c_params[1] is gparams[1]
    for k, v in s_params[0].items():
        assert torch.equal(c_params[0][k], v)
        assert c_params[0][k].stride() == v.stride()
    with pytest.raises(ValueError):
        apply_group_masks(gspecs, gparams, [np.array([False] * 3),
                                            np.array([False])])


def test_fedavg_stacked_with_survivor_mask(hetero):
    clients, (_, rgparams) = hetero
    _, gparams = _port_grouped(hetero)
    n_data = [10, 12, 13]
    mask = np.array([True, False, True])
    want = r_fedavg_stacked(rgparams[0], n_data, survivor_mask=mask)
    got = fedavg_stacked(gparams[0], n_data, survivor_mask=mask)
    model = T_cnn.cnn_view(_tspec("cnn1"), got)
    _close_trees(interop.cnn_to_ref(model), _np(want), 1e-6)
    # the tree mode, against the reference's tree
    want = r_fedavg_stacked(rgparams[0], n_data, survivor_mask=mask,
                            mode="tree", branch=2)
    got = fedavg_stacked(gparams[0], n_data, survivor_mask=mask,
                         mode="tree", branch=2)
    _close_trees(interop.cnn_to_ref(T_cnn.cnn_view(_tspec("cnn1"), got)),
                 _np(want), 1e-6)
    with pytest.raises(ValueError):
        fedavg_stacked(gparams[0], n_data, survivor_mask=[False] * 3)


def test_interop_grouped_round_trip(hetero):
    gspecs, gparams = _port_grouped(hetero)
    _, back = interop.grouped_to_reference(gspecs, gparams)
    _close_trees(back, _np(hetero[1][1]), 0)
    w = gparams[0]["layers.0.conv.w"]
    assert w.shape == (3, 8, 3, 3, 3)
    assert w.reshape(24, 3, 3, 3).is_contiguous(
        memory_format=torch.channels_last)


STEP_FIELDS = dict(n_clients=4, num_classes=4, image_size=8, in_ch=3,
                   client_kinds=("cnn1", "cnn2", "cnn1", "cnn1"),
                   global_kind="cnn1", width=0.25, nz=16, synth_batch=16,
                   loop_mode="python", distill_kl_mode="ref")


@pytest.fixture(scope="module")
def ref_steps(hetero):
    clients, (gspecs, _) = hetero
    spec = _rspec("cnn1")
    scfg = R_cfg.DenseExperimentConfig(**STEP_FIELDS)
    rng = np.random.default_rng(9)
    init = torch.Generator().manual_seed(20)
    gen = interop.generator_to_ref(img_generator_init(
        nz=16, img_size=8, out_ch=3, generator=init, device="cpu"))
    stu = interop.cnn_to_ref(T_cnn.cnn_init(_tspec("cnn1"), generator=init,
                                            device="cpu"))
    z = rng.standard_normal((16, 16)).astype(np.float32)
    y = rng.integers(0, 4, 16).astype(np.int32)
    _, student_step, _, s_opt, gparams, _, _ = r_make_steps(clients, spec,
                                                            scfg)

    @jax.jit
    def gen_grads(gp, gparams):
        """The reference gen_step's loss, parts and gradient."""
        def loss_fn(gp):
            x = R_gen.img_generator(gp, z, img_size=8)
            avg, stats = R_ens.grouped_ensemble_logits(
                gspecs, gparams, x, with_bn_stats=True)
            return R_L.gen_loss(avg, y, stats,
                                R_cnn.cnn_logits(stu, spec, x),
                                lambda_bn=scfg.lambda_bn,
                                lambda_div=scfg.lambda_div)
        return jax.value_and_grad(loss_fn, has_aux=True)(gp)

    (loss, parts), grads = gen_grads(jax.tree.map(jnp.asarray, gen),
                                     gparams)
    new_stu, _, dis = student_step(stu, s_opt.init(stu), gen, gparams, z)
    return dict(gen=gen, student=stu, z=z, y=y, gen_loss=float(loss),
                parts={k: float(v) for k, v in parts.items()},
                gen_grads=_np(grads), dis_loss=float(dis),
                new_student=_np(new_stu))


class _Capture:
    """An optimizer stand-in that keeps the gradients it is given."""

    def __init__(self, params):
        self.params = list(params)

    def step(self, grads):
        self.grads = [g.detach().numpy() for g in grads]


def test_server_steps_over_the_grouped_teacher(hetero, ref_steps):
    """One gen_step and one student step, the port's teacher the
    ClientList of the reference's grouped representation."""
    gspecs, gparams = _port_grouped(hetero)
    views = T_cnn.client_views(gspecs[0][0], gparams[0])
    order = [views[0], gparams[1], views[1], views[2]]
    clients = ClientList([Client(spec=m.spec, model=m) for m in order],
                         gspecs, gparams)
    scfg = T_cfg.DenseExperimentConfig(**STEP_FIELDS)
    gen_step, student_step = make_dense_steps(clients, scfg, device="cpu")
    gen = interop.generator_from_ref(ref_steps["gen"], nz=16, img_size=8,
                                     out_ch=3, device="cpu")
    stu = interop.cnn_from_ref(ref_steps["student"], _tspec("cnn1"),
                               device="cpu")
    cap = _Capture(gen.parameters())
    loss, parts = gen_step(gen, cap, stu, torch.tensor(ref_steps["z"]),
                           torch.tensor(ref_steps["y"]).long())
    np.testing.assert_allclose(float(loss), ref_steps["gen_loss"], rtol=TOL)
    for k, v in ref_steps["parts"].items():
        np.testing.assert_allclose(float(parts[k]), v, rtol=TOL, atol=TOL)
    want = dict(interop._flatten(ref_steps["gen_grads"]))
    for (name, _), got in zip(gen.named_parameters(), cap.grads,
                              strict=True):
        _close(got, interop._to_port(name, want[name]), rel_to_max=True)
    opt = optim.sgd(list(stu.parameters()), scfg.s_lr,
                    momentum=scfg.s_momentum)
    dis = student_step(stu, opt, gen, torch.tensor(ref_steps["z"]))
    np.testing.assert_allclose(float(dis), ref_steps["dis_loss"], rtol=TOL)
    _close_trees(interop.cnn_to_ref(stu), ref_steps["new_student"])


# ---------------------------------------------------------- federation --

FED = T_cfg.DenseExperimentConfig(
    n_clients=3, alpha=0.5, local_epochs=2, batch_size=16, num_classes=4,
    image_size=8, in_ch=1, train_per_class=37, test_per_class=8,
    client_kinds=("cnn1", "cnn2", "cnn1"), global_kind="cnn1", width=0.25,
    nz=16, t_g=1, epochs=1, synth_batch=16)


@pytest.fixture(scope="module")
def federations():
    data = make_classification_data(0, num_classes=4, size=8, ch=1,
                                    train_per_class=37, test_per_class=8)
    out = {}
    for mode in ("python", "grouped"):
        ledger = CommLedger()
        clients, shards = build_federation(
            dataclasses.replace(FED, client_loop_mode=mode), data,
            device="cpu", ledger=ledger)
        out[mode] = (clients, shards, ledger)
    return out


def test_grouped_federation_matches_per_client(federations):
    cp, sp, lp = federations["python"]
    cg, sg, lg = federations["grouped"]
    assert not isinstance(cp, ClientList) and isinstance(cg, ClientList)
    for a, b in zip(cp, cg, strict=True):
        assert a.spec == b.spec and a.n_data == b.n_data
        np.testing.assert_array_equal(a.class_counts, b.class_counts)
        _close_trees(interop.cnn_to_ref(b.model), interop.cnn_to_ref(a.model))
    for (xa, ya), (xb, yb) in zip(sp, sg):
        np.testing.assert_array_equal(ya, yb)
    # the same uploads (the grouped engine records them group by group),
    # one round, nothing down
    key = lambda e: e["who"]                                   # noqa: E731
    assert sorted(lg.events, key=key) == sorted(lp.events, key=key)
    assert lg.rounds == 1 and lg.downlink_bytes == 0
    assert lg.uplink_bytes == sum(param_bytes(c.model) for c in cg)


def test_grouped_federation_is_its_own_teacher(federations):
    cg = federations["grouped"][0]
    gspecs, gparams = stack_grouped(cg)
    assert gspecs == cg.grouped[0]
    assert all(a is b for a, b in zip(gparams, cg.grouped[1]))
    assert [(s.kind, n) for s, n in gspecs] == [("cnn1", 2), ("cnn2", 1)]
    # clients 0 and 2 view rows 0 and 1 of the cnn1 stack: no copy
    w = gparams[0]["layers.0.conv.w"]
    for row, i in enumerate((0, 2)):
        assert cg[i].model.net.layers[0].conv.w.data_ptr() == \
            w[row].data_ptr()
    assert cg[1].model is gparams[1]
    # FedAvg averages the stack's two rows, each once
    with pytest.raises(ValueError):
        fedavg(cg)
    homo = ClientList([cg[0], cg[2]], [gspecs[0]], [gparams[0]])
    got = fedavg(homo)
    want = fedavg([Client(spec=c.spec, model=c.model, n_data=c.n_data)
                   for c in (cg[0], cg[2])])
    _close_trees(interop.cnn_to_ref(got), interop.cnn_to_ref(want), 1e-6)


def test_policy_defaults_to_grouped_and_refuses_the_rest():
    assert backend.resolve_exec_policy(T_cfg.smoke(),
                                       device="cpu").client_loop == "grouped"
    assert backend._PROFILES["cuda"]["client_loop"] == "grouped"
    assert backend.resolve_exec_policy(dataclasses.replace(
        T_cfg.smoke(), client_loop_mode="python"),
        device="cpu").client_loop == "python"
    with pytest.raises(ValueError):
        backend.resolve_exec_policy(dataclasses.replace(
            T_cfg.smoke(), client_loop_mode="nope"), device="cpu")
    # the scaling knobs resolve (off by default), bad values raise
    pol = backend.resolve_exec_policy(T_cfg.smoke(), device="cpu")
    assert (pol.bucketing, pol.stack_chunk, pol.fedavg) == ("off", 0, "flat")
    for knob, field, want in (({"plan_bucketing": "pow2"}, "bucketing",
                               "pow2"),
                              ({"stack_chunk": 4}, "stack_chunk", 4),
                              ({"fedavg_mode": "tree"}, "fedavg", "tree")):
        got = backend.resolve_exec_policy(
            dataclasses.replace(T_cfg.smoke(), **knob), device="cpu")
        assert getattr(got, field) == want
    for knob in ({"plan_bucketing": "nope"}, {"stack_chunk": -1},
                 {"fedavg_mode": "nope"}, {"fedavg_branch": 1}):
        with pytest.raises(ValueError):
            backend.resolve_exec_policy(
                dataclasses.replace(T_cfg.smoke(), **knob), device="cpu")
