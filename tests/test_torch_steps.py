"""One generator step and one student step of the port against the JAX
package's, from the same state, at the paper's learning rates.

Three resnet18 clients (width 0.125, 8x8 images, running statistics
moved off their init by one train-mode batch), a resnet18 student and
the generator are drawn by the reference and carried across with
``repro_torch.interop``. Each port step runs through
``core.dense.make_dense_steps`` in both KL modes:

  * the generator step's loss and its parts are held to the reference
    step's, and its gradient to ``jax.grad`` of the reference's loss
    (the looped ensemble of ``repro/core/ensemble.py``). The gradient and
    not the Adam update is compared: Adam's first step moves each weight
    by ±lr whatever the gradient's size, so a weight whose gradient lies
    within float32 noise of zero may move either way in either
    framework (tests/test_torch_models.py holds Adam itself);
  * the student step's loss, its SGD update and its BN running-statistic
    update are held to the reference step's.

Tolerance 1e-4, relative to each tensor's largest entry for gradients:
the two frameworks differ only in float32 summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_cifar as R_cfg
from repro.core import generator as R_gen
from repro.core import losses as R_L
from repro.core.dense import make_dense_steps as r_make_steps
from repro.core.ensemble import Client as RClient
from repro.core.ensemble import ensemble_logits as r_ensemble
from repro.models import cnn as R_cnn

from repro_torch import interop
from repro_torch.configs import paper_cifar as T_cfg
from repro_torch.core import Client, make_dense_steps
from repro_torch.models.cnn import CNNSpec

TOL = 1e-4
FIELDS = dict(n_clients=3, num_classes=4, image_size=8, in_ch=3,
              client_kinds=("resnet18",) * 3, global_kind="resnet18",
              width=0.125, nz=16, synth_batch=16, loop_mode="python")
R_SPEC = R_cnn.CNNSpec(kind="resnet18", num_classes=4, in_ch=3, width=0.125,
                       image_size=8)
T_SPEC = CNNSpec(kind="resnet18", num_classes=4, in_ch=3, width=0.125,
                 image_size=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(0)
    ks = jax.random.split(jax.random.PRNGKey(3), 5)
    x = rng.uniform(-1, 1, (32, 8, 8, 3)).astype(np.float32)
    clients = []
    for k in ks[:3]:
        p = R_cnn.cnn_init(k, R_SPEC)
        _, p, _ = R_cnn.cnn_apply(p, R_SPEC, x, train=True)
        clients.append(_np(p))
    _, stu, _ = R_cnn.cnn_apply(R_cnn.cnn_init(ks[3], R_SPEC), R_SPEC, x,
                                train=True)
    gen = _np(R_gen.img_generator_init(ks[4], nz=16, img_size=8, out_ch=3))
    z = rng.standard_normal((16, 16)).astype(np.float32)
    y = rng.integers(0, 4, 16).astype(np.int32)
    return dict(clients=clients, student=_np(stu), gen=gen, z=z, y=y)


@pytest.fixture(scope="module")
def ref_steps(state):
    scfg = R_cfg.DenseExperimentConfig(**FIELDS, distill_kl_mode="ref")
    clients = [RClient(spec=R_SPEC, params=p) for p in state["clients"]]
    gen_step, student_step, g_opt, s_opt, gparams, _, _ = r_make_steps(
        clients, R_SPEC, scfg)
    gen, stu, z, y = state["gen"], state["student"], state["z"], state["y"]
    _, _, loss, parts = gen_step(gen, g_opt.init(gen), stu, gparams, z, y)

    def loss_fn(gp):
        x = R_gen.img_generator(gp, z, img_size=8)
        avg, stats = r_ensemble((R_SPEC,) * 3, state["clients"], x,
                                with_bn_stats=True)
        return R_L.gen_loss(avg, y, stats, R_cnn.cnn_logits(stu, R_SPEC, x),
                            lambda_bn=scfg.lambda_bn,
                            lambda_div=scfg.lambda_div)[0]

    grads = _np(jax.grad(loss_fn)(jax.tree.map(jnp.asarray, gen)))
    new_stu, _, dis = student_step(stu, s_opt.init(stu), gen, gparams, z)
    return dict(gen_loss=float(loss), parts={k: float(v) for k, v in
                                             parts.items()},
                gen_grads=grads, dis_loss=float(dis),
                new_student=_np(new_stu))


def _port(state, mode):
    scfg = T_cfg.DenseExperimentConfig(**FIELDS, distill_kl_mode=mode)
    clients = [Client(spec=T_SPEC,
                      model=interop.cnn_from_ref(p, T_SPEC, device="cpu"))
               for p in state["clients"]]
    gen = interop.generator_from_ref(state["gen"], nz=16, img_size=8,
                                     out_ch=3, device="cpu")
    stu = interop.cnn_from_ref(state["student"], T_SPEC, device="cpu")
    gen_step, student_step = make_dense_steps(clients, scfg, device="cpu")
    return scfg, gen, stu, gen_step, student_step


class _Capture:
    """An optimizer stand-in that keeps the gradients it is given."""

    def __init__(self, params):
        self.params = list(params)

    def step(self, grads):
        self.grads = [g.detach().numpy() for g in grads]


@pytest.mark.parametrize("mode", ["ref", "fused"])
def test_generator_step_matches(state, ref_steps, mode):
    _, gen, stu, gen_step, _ = _port(state, mode)
    opt = _Capture(gen.parameters())
    loss, parts = gen_step(gen, opt, stu, torch.tensor(state["z"]),
                           torch.tensor(state["y"]).long())
    np.testing.assert_allclose(float(loss), ref_steps["gen_loss"], rtol=TOL)
    for k, v in ref_steps["parts"].items():
        np.testing.assert_allclose(float(parts[k]), v, rtol=TOL, atol=TOL)
    want = dict(interop._flatten(ref_steps["gen_grads"]))
    for (name, _), got in zip(gen.named_parameters(), opt.grads,
                              strict=True):
        w = interop._to_port(name, want[name])
        np.testing.assert_allclose(got, w, rtol=TOL,
                                   atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("mode", ["ref", "fused"])
def test_student_step_matches(state, ref_steps, mode):
    from repro_torch import optim

    scfg, gen, stu, _, student_step = _port(state, mode)
    opt = optim.sgd(list(stu.parameters()), scfg.s_lr,
                    momentum=scfg.s_momentum)
    loss = student_step(stu, opt, gen, torch.tensor(state["z"]))
    np.testing.assert_allclose(float(loss), ref_steps["dis_loss"], rtol=TOL)
    got = interop.cnn_to_ref(stu)
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(ref_steps["new_student"]), strict=True):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_ablations_zero_their_parts(state):
    scfg = T_cfg.DenseExperimentConfig(**FIELDS, distill_kl_mode="ref")
    clients = [Client(spec=T_SPEC,
                      model=interop.cnn_from_ref(p, T_SPEC, device="cpu"))
               for p in state["clients"]]
    gen_step, _ = make_dense_steps(clients, scfg, use_bn=False,
                                   use_div=False, device="cpu")
    gen = interop.generator_from_ref(state["gen"], nz=16, img_size=8,
                                     out_ch=3, device="cpu")
    stu = interop.cnn_from_ref(state["student"], T_SPEC, device="cpu")
    loss, parts = gen_step(gen, _Capture(gen.parameters()), stu,
                           torch.tensor(state["z"]),
                           torch.tensor(state["y"]).long())
    assert float(parts["bn"]) == 0.0 and float(parts["div"]) == 0.0
    assert float(loss) == pytest.approx(float(parts["ce"]))
