"""The port's layers, CNN zoo, generator and optimizers against the JAX
package's, with the reference's weights carried across by
``repro_torch.interop``.

Inputs come from numpy with a seed. Tolerance 1e-5, relative to the
largest entry of each compared tensor: float32 on both sides, summed in
another order. Eval-mode forwards of freshly drawn deep models (wrn40_1)
reach large activations, where an entrywise relative tolerance is the
wrong yardstick for entries near zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro.core import generator as R_gen
from repro.models import cnn as R_cnn
from repro.models import layers as R_L

from repro_torch import interop
from repro_torch import optim as t_optim
from repro_torch.models import cnn as T_cnn
from repro_torch.models import layers as T_L

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("size,k,stride", [
    (8, 3, 1), (8, 3, 2), (7, 3, 2), (8, 1, 2), (9, 1, 1), (16, 3, 2)])
def test_conv2d_same_padding(size, k, stride):
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    want = R_L.conv2d({"w": jnp.asarray(w)}, jnp.asarray(x), stride=stride)
    got = T_L.conv2d(torch.tensor(x).permute(0, 3, 1, 2),
                     torch.tensor(w).permute(3, 2, 0, 1), stride=stride)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_and_running_stats(train):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 5, 5, 4)) * 2 + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 4).astype(np.float32),
         "bias": rng.standard_normal(4).astype(np.float32),
         "mean": rng.standard_normal(4).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, 4).astype(np.float32)}
    want_y, want_new = R_L.batchnorm(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), train=train)
    bn = T_L.BatchNorm(4)
    bn.load_state_dict({k: torch.tensor(v) for k, v in p.items()})
    stats = []
    y = bn(torch.tensor(x).permute(0, 3, 1, 2), train=train, stats=stats)
    _close(y.detach().permute(0, 2, 3, 1).numpy(), want_y)
    _close(bn.mean.numpy(), want_new["mean"])
    _close(bn.var.numpy(), want_new["var"])
    # the recorded running statistics are those from before the batch
    _close(stats[0]["running_mean"].numpy(), p["mean"])
    _close(stats[0]["var"].detach().numpy(), x.var(axis=(0, 1, 2)))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind,size", [
    ("cnn1", 16), ("cnn2", 16), ("lenet", 16), ("resnet18", 8),
    ("wrn16_1", 8), ("wrn40_1", 8), ("cnn2", 8)])
def test_cnn_apply_matches(kind, size, train):
    spec = R_cnn.CNNSpec(kind=kind, num_classes=5, in_ch=3, width=0.25,
                         image_size=size)
    tspec = T_cnn.CNNSpec(kind=kind, num_classes=5, in_ch=3, width=0.25,
                          image_size=size)
    params = R_cnn.cnn_init(jax.random.PRNGKey(7), spec)
    x = np.random.default_rng(2).uniform(-1, 1, (6, size, size, 3)) \
        .astype(np.float32)
    logits, new_params, stats = R_cnn.cnn_apply(params, spec, x, train=train)
    model = interop.cnn_from_ref(_np(params), tspec, device="cpu")
    with torch.no_grad():
        got, got_stats = T_cnn.cnn_apply(model, torch.tensor(x), train=train)
    _close(got.numpy(), logits)
    assert len(got_stats) == len(stats)
    for g, w in zip(got_stats, stats):
        for k in ("mean", "var", "running_mean", "running_var"):
            _close(g[k].numpy(), w[k])
    # train mode moved the running statistics in place, as the reference's
    # returned params do; eval mode left them
    for g, w in zip(jax.tree.leaves(interop.cnn_to_ref(model)),
                    jax.tree.leaves(_np(new_params)), strict=True):
        _close(g, w)


def test_cnn_init_shapes_match_reference():
    for kind in T_cnn.KINDS:
        spec = R_cnn.CNNSpec(kind=kind, width=0.5, image_size=16)
        tspec = T_cnn.CNNSpec(kind=kind, width=0.5, image_size=16)
        want = _np(R_cnn.cnn_init(jax.random.PRNGKey(0), spec))
        got = interop.cnn_to_ref(T_cnn.cnn_init(tspec, device="cpu"))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert [a.shape for a in jax.tree.leaves(got)] == \
            [a.shape for a in jax.tree.leaves(want)]


def test_interop_round_trip_is_exact():
    spec = R_cnn.CNNSpec(kind="resnet18", width=0.25, image_size=8)
    tree = _np(R_cnn.cnn_init(jax.random.PRNGKey(1), spec))
    model = interop.cnn_from_ref(
        tree, T_cnn.CNNSpec(kind="resnet18", width=0.25, image_size=8),
        device="cpu")
    for a, b in zip(jax.tree.leaves(interop.cnn_to_ref(model)),
                    jax.tree.leaves(tree), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("img_size,base", [(8, 8), (16, 16), (32, 8)])
def test_img_generator_matches(img_size, base):
    gp = R_gen.img_generator_init(jax.random.PRNGKey(2), nz=12,
                                  img_size=img_size, out_ch=3, base=base)
    z = np.random.default_rng(3).standard_normal((5, 12)).astype(np.float32)
    want = R_gen.img_generator(gp, jnp.asarray(z), img_size=img_size,
                               base=base)
    gen = interop.generator_from_ref(_np(gp), nz=12, img_size=img_size,
                                     out_ch=3, base=base, device="cpu")
    with torch.no_grad():
        got = gen(torch.tensor(z))
    assert got.shape == (5, img_size, img_size, 3)
    _close(got.numpy(), want)


def _opt_run(r_opt, t_make, steps=6):
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    rp = jax.tree.map(jnp.asarray, params)
    state = r_opt.init(rp)
    tp = [torch.tensor(params["a"]), torch.tensor(params["b"])]
    opt = t_make(tp)
    for g in grads:
        rp, state = r_opt.update(jax.tree.map(jnp.asarray, g), state, rp)
        opt.step([torch.tensor(g["a"]), torch.tensor(g["b"])])
    for got, want in zip(tp, (rp["a"], rp["b"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_over_steps(momentum):
    _opt_run(r_optim.sgd(0.05, momentum=momentum),
             lambda p: t_optim.sgd(p, 0.05, momentum=momentum))


@pytest.mark.parametrize("lr", [1e-3, 0.1])
def test_adam_matches_over_steps(lr):
    _opt_run(r_optim.adam(lr), lambda p: t_optim.adam(p, lr))


def test_global_norm_matches():
    a = np.random.default_rng(5).standard_normal((7, 3)).astype(np.float32)
    b = np.arange(4, dtype=np.float32)
    want = r_optim.global_norm({"a": jnp.asarray(a), "b": jnp.asarray(b)})
    got = t_optim.global_norm([torch.tensor(a), torch.tensor(b)])
    _close(got.numpy(), want)
