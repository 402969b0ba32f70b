"""The port's one-shot baselines (``repro_torch.fl.baselines``) against the
JAX package's (``repro.fl.baselines``).

A smoke()-like federation (3 cnn1 clients at width 0.25 on 8x8 images,
4 classes) is trained by the reference's per-client engine and carried
across with ``repro_torch.interop``; the reference's inits and
``jax.random`` draws, derived as ``repro/fl/baselines.py`` derives them,
are injected into the port.

  * Single steps at the paper's rates, from the reference's own state:
    the shared distillation step (loss, SGD update, BN running
    statistics; in both KL modes), Fed-DAFL's generator step and
    Fed-ADI's input step (loss and gradient; ADI also its Adam step at
    adi_lr = 0.05 and the clip). The generator's gradient, not its Adam
    update, is compared: Adam's first step moves each weight by about
    ±lr whatever the size of its gradient, so a weight whose gradient
    lies within float32 noise of zero may move either way in either
    framework. The inputs are checked to keep the ensemble's top two
    logits apart (DAFL's pseudo-labels) and ADI's input gradient away
    from zero, so no argmax or sign can flip at float32 noise.
  * ``s_steps > 1``: the extra student steps of DENSE and of the
    baselines held one step at a time, each from the reference's
    parameters and momentum after the step before.
  * Each baseline end to end (3 epochs, s_steps 2, so Fed-DAFL's latent
    order and Fed-ADI's refresh at epochs 0 and 2 both show), in both of
    the port's KL modes, comparing the student's logits on the test set.
    The free runs take g_lr = 1e-5 (DAFL's generator) and adi_lr = 1e-5
    (ADI's inputs), for the reason above; FedDF has no Adam and runs at
    the paper's rates.

Tolerances: 1e-4 a step (gradients relative to their largest entry),
1e-3 end to end, as in tests/test_torch_round.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_cifar as R_cfg
from repro.core import generator as R_gen
from repro.core import losses as R_L
from repro.core.dense import make_dense_steps as r_make_dense_steps
from repro.core.ensemble import grouped_ensemble_logits, stack_grouped
from repro.data import make_classification_data as r_make_data
from repro.fl import baselines as RB
from repro.fl import build_federation as r_build
from repro.models import cnn as R_cnn
from repro import optim as R_optim

from repro_torch import interop, optim
from repro_torch.configs import paper_cifar as T_cfg
from repro_torch.core import Client, make_dense_steps
from repro_torch.fl import baselines as TB
from repro_torch.fl import fed_adi, fed_dafl, fed_df, make_distill_step
from repro_torch.models.cnn import CNNSpec, cnn_logits

STEP_TOL = 1e-4
END_TOL = 1e-3
B, NZ = 16, 16
FIELDS = dict(
    n_clients=3, alpha=0.5, local_epochs=1, batch_size=32, num_classes=4,
    image_size=8, in_ch=3, train_per_class=24, test_per_class=8,
    client_kinds=("cnn1",) * 3, global_kind="cnn1", width=0.25, nz=NZ,
    t_g=2, epochs=3, s_steps=2, synth_batch=B, client_loop_mode="python",
    loop_mode="python", distill_kl_mode="ref")
R_SPEC = R_cnn.CNNSpec(kind="cnn1", num_classes=4, in_ch=3, width=0.25,
                       image_size=8)
T_SPEC = CNNSpec(kind="cnn1", num_classes=4, in_ch=3, width=0.25,
                 image_size=8)
ADI = dict(tv_coef=1e-4, l2_coef=1e-5, bn_coef=1.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data():
    return r_make_data(0, num_classes=4, size=8, ch=3, train_per_class=24,
                       test_per_class=8)


def _assert_model(model, tree, tol):
    got = interop.cnn_to_ref(model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(_np(tree)),
                    strict=True):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _assert_grads(got, want, tol=STEP_TOL):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def fed():
    scfg = R_cfg.DenseExperimentConfig(**FIELDS)
    clients, _ = r_build(jax.random.PRNGKey(0), scfg, _data())
    return scfg, clients


def _port_clients(fed):
    return [Client(spec=T_SPEC,
                   model=interop.cnn_from_ref(_np(c.params), T_SPEC,
                                              device="cpu"))
            for c in fed[1]]


def _tscfg(**kw):
    return T_cfg.DenseExperimentConfig(**{**FIELDS, **kw})


class _Capture:
    """An optimizer stand-in that keeps the gradients it is given."""

    def __init__(self, params):
        self.params = list(params)

    def step(self, grads):
        self.grads = [g.detach().numpy() for g in grads]


def _sgd_from_ref(model, s_state, scfg):
    """The port's SGD over ``model`` holding the reference's momentum."""
    opt = optim.sgd(list(model.parameters()), scfg.s_lr,
                    momentum=scfg.s_momentum)
    bufs = interop.cnn_from_ref(_np(s_state), T_SPEC, device="cpu")
    opt.bufs = [b.detach().clone() for b in bufs.parameters()]
    return opt


def _images(seed, n=B):
    rng = np.random.default_rng(seed)
    return np.tanh(rng.standard_normal((n, 8, 8, 3))).astype(np.float32)


def _top2_gap(logits):
    top = np.sort(np.asarray(logits), -1)
    return float(np.min(top[:, -1] - top[:, -2]))


# ---------------------------------------------- single steps, s_steps > 1 --

@pytest.fixture(scope="module")
def distill_chain(fed):
    """Three steps of the reference's shared distillation step and of its
    DENSE student step, with every state they pass through."""
    scfg, clients = fed
    gspecs, gparams = stack_grouped(clients)
    kd, kg = jax.random.split(jax.random.PRNGKey(7))
    stu = R_cnn.cnn_init(kd, R_SPEC)
    gen = _np(R_gen.img_generator_init(kg, nz=NZ, img_size=8, out_ch=3))
    step, s_opt = RB.make_distill_step(gspecs, R_SPEC, scfg)
    xs = [_images(s) for s in range(3)]
    chain = {"baseline": {"inputs": xs, "states": [(stu, s_opt.init(stu))],
                          "losses": []}}
    for x in xs:
        p, s = chain["baseline"]["states"][-1]
        p, s, loss = step(p, s, gparams, jnp.asarray(x))
        chain["baseline"]["states"].append((p, s))
        chain["baseline"]["losses"].append(float(loss))
    _, student_step, _, d_opt, dparams, _, _ = r_make_dense_steps(
        clients, R_SPEC, scfg)
    zs = [np.random.default_rng(10 + j).standard_normal((B, NZ))
          .astype(np.float32) for j in range(3)]
    chain["dense"] = {"inputs": zs, "states": [(stu, d_opt.init(stu))],
                      "losses": [], "gen": gen}
    for z in zs:
        p, s = chain["dense"]["states"][-1]
        p, s, loss = student_step(p, s, gen, dparams, jnp.asarray(z))
        chain["dense"]["states"].append((p, s))
        chain["dense"]["losses"].append(float(loss))
    return chain


@pytest.mark.parametrize("mode", ["ref", "fused"])
@pytest.mark.parametrize("j", [0, 1, 2])
@pytest.mark.parametrize("which", ["baseline", "dense"])
def test_student_steps_match_one_at_a_time(fed, distill_chain, which, j,
                                           mode):
    """Step j of s_steps = 3 from the reference's state after step j − 1:
    the loss, the SGD update (momentum included) and the BN running
    statistics."""
    scfg = _tscfg(distill_kl_mode=mode)
    c = distill_chain[which]
    p, s = c["states"][j]
    student = interop.cnn_from_ref(_np(p), T_SPEC, device="cpu")
    opt = _sgd_from_ref(student, s, scfg)
    clients = _port_clients(fed)
    inp = torch.tensor(c["inputs"][j])
    if which == "baseline":
        loss = make_distill_step(clients, scfg, device="cpu")(student, opt,
                                                              inp)
    else:
        gen = interop.generator_from_ref(c["gen"], nz=NZ, img_size=8,
                                         out_ch=3, device="cpu")
        _, student_step = make_dense_steps(clients, scfg, device="cpu")
        loss = student_step(student, opt, gen, inp)
    np.testing.assert_allclose(float(loss), c["losses"][j], rtol=STEP_TOL)
    _assert_model(student, c["states"][j + 1][0], STEP_TOL)
    want_m = interop.cnn_from_ref(_np(c["states"][j + 1][1]), T_SPEC,
                                  device="cpu")
    for a, b in zip(opt.bufs, want_m.parameters(), strict=True):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(),
                                   rtol=STEP_TOL, atol=STEP_TOL)


def test_dafl_generator_step_matches(fed):
    """Fed-DAFL's loss and its gradient for the generator, against
    ``jax.grad`` of the reference's loss (``baselines.py:100-109``)."""
    scfg, clients = fed
    gspecs, gparams = stack_grouped(clients)
    gen = _np(R_gen.img_generator_init(jax.random.PRNGKey(3), nz=NZ,
                                       img_size=8, out_ch=3))
    z = np.random.default_rng(4).standard_normal((B, NZ)).astype(np.float32)

    def loss_fn(gp):
        x = R_gen.img_generator(gp, z, img_size=8)
        avg = grouped_ensemble_logits(gspecs, gparams, x)
        mean_p = jnp.mean(jax.nn.softmax(avg, -1), 0)
        return (R_L.ce_loss(avg, jnp.argmax(avg, -1))
                - 0.1 * jnp.mean(jnp.abs(avg))
                + 5.0 * jnp.sum(mean_p * jnp.log(mean_p + 1e-8)))

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree.map(jnp.asarray, gen))
    x = R_gen.img_generator(gen, z, img_size=8)
    assert _top2_gap(grouped_ensemble_logits(gspecs, gparams, x)) > 1e-3
    port_gen = interop.generator_from_ref(gen, nz=NZ, img_size=8, out_ch=3,
                                          device="cpu")
    cap = _Capture(port_gen.parameters())
    loss = TB.make_dafl_gen_step(_port_clients(fed))(port_gen, cap,
                                                     torch.tensor(z))
    np.testing.assert_allclose(float(loss), float(want), rtol=STEP_TOL)
    want_g = dict(interop._flatten(_np(grads)))
    for (name, _), got in zip(port_gen.named_parameters(), cap.grads,
                              strict=True):
        _assert_grads(got, interop._to_port(name, want_g[name]))


@pytest.fixture(scope="module")
def adi_ref(fed):
    """Two reference ADI steps (``baselines.py:135-151``, Adam at 0.05,
    then the clip) from 0.5·N(0, 1) inputs: each step's inputs, loss and
    gradient, the Adam state after the first and the inputs after the
    second."""
    scfg, clients = fed
    gspecs, gparams = stack_grouped(clients)
    rng = np.random.default_rng(5)
    x = jnp.asarray((rng.standard_normal((B, 8, 8, 3)) * 0.5)
                    .astype(np.float32))
    y = rng.integers(0, 4, B).astype(np.int32)

    def loss_fn(xx):
        avg, stats = grouped_ensemble_logits(gspecs, gparams, xx,
                                             with_bn_stats=True)
        dx, dy = jnp.diff(xx, axis=1), jnp.diff(xx, axis=2)
        return (R_L.ce_loss(avg, y) + ADI["bn_coef"] * R_L.bn_loss(stats)
                + ADI["tv_coef"] * (jnp.mean(dx * dx) + jnp.mean(dy * dy))
                + ADI["l2_coef"] * jnp.mean(xx * xx))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    opt = R_optim.adam(0.05)
    state = opt.init(x)
    steps = []
    for _ in range(2):
        loss, g = grad_fn(x)
        steps.append(dict(x=np.asarray(x), loss=float(loss),
                          grad=np.asarray(g), state=_np(state)))
        x, state = opt.update(g, state, x)
        x = jnp.clip(x, -1.0, 1.0)
    return dict(y=y, steps=steps, new_x=np.asarray(x))


@pytest.mark.parametrize("k", [0, 1])
def test_adi_input_step_gradient_matches(fed, adi_ref, k):
    st = adi_ref["steps"][k]
    x = torch.tensor(st["x"], requires_grad=True)
    cap = _Capture([x])
    loss = TB.make_adi_step(_port_clients(fed), **ADI)(
        cap, torch.tensor(adi_ref["y"]).long())
    np.testing.assert_allclose(float(loss), st["loss"], rtol=STEP_TOL)
    _assert_grads(cap.grads[0], st["grad"])


def test_adi_input_step_adam_and_clip_match(fed, adi_ref):
    """The second input step, from the reference's inputs and Adam state
    after the first. (A first step moves each input by ±adi_lr whatever
    its gradient's size, and some of these gradients lie within float32
    noise of zero.) The second moments are checked to keep every entry's
    step away from that noise, and the clip to act."""
    st = adi_ref["steps"][1]
    v = st["state"]["v"] * 0.999 + 0.001 * st["grad"] ** 2
    assert np.sqrt(v.min()) > 1e-3 * np.sqrt(v.max())
    x = torch.tensor(st["x"], requires_grad=True)
    opt = optim.adam([x], 0.05)
    opt.m, opt.v = [torch.tensor(st["state"]["m"])], [
        torch.tensor(st["state"]["v"])]
    opt.t = int(st["state"]["t"])
    TB.make_adi_step(_port_clients(fed), **ADI)(
        opt, torch.tensor(adi_ref["y"]).long())
    got = x.detach().numpy()
    assert np.abs(got).max() <= 1.0 and (np.abs(got) == 1.0).any()
    np.testing.assert_allclose(got, adi_ref["new_x"], rtol=STEP_TOL,
                               atol=STEP_TOL)


# ------------------------------------------------------------ end to end --

def _r_scfg(method):
    kw = {"g_lr": 1e-5} if method == "fed_dafl" else {}
    return R_cfg.DenseExperimentConfig(**{**FIELDS, **kw})


def _df_draws(key, scfg):
    k_s, key = jax.random.split(key)
    xs = []
    for _ in range(scfg.epochs):
        ep = []
        for _ in range(scfg.s_steps):
            key, kx = jax.random.split(key)
            ep.append(np.asarray(jax.random.uniform(
                kx, (B, 8, 8, 3), jnp.float32, -1.0, 1.0)))
        xs.append(np.stack(ep))
    return {"student": _np(R_cnn.cnn_init(k_s, R_SPEC)), "noise": xs}


def _dafl_draws(key, scfg):
    """z at each epoch's start, then a fresh z after every student step,
    the epoch's last one unused (``baselines.py:113-122``)."""
    k_g, k_s, key = jax.random.split(key, 3)
    zs = []
    for _ in range(scfg.epochs):
        ep = []
        for _ in range(scfg.s_steps + 1):
            key, kz = jax.random.split(key)
            ep.append(np.asarray(jax.random.normal(kz, (B, NZ))))
        zs.append(np.stack(ep[:max(scfg.s_steps, 1)]))
    return {"student": _np(R_cnn.cnn_init(k_s, R_SPEC)), "noise": zs,
            "gen": _np(R_gen.img_generator_init(k_g, nz=NZ, img_size=8,
                                                out_ch=3))}


def _adi_draws(key, scfg, refresh_every):
    k_s, key = jax.random.split(key)
    noise = {}
    for epoch in range(0, scfg.epochs, refresh_every):
        key, kx, ky = jax.random.split(key, 3)
        noise[epoch] = (
            np.asarray(jax.random.normal(kx, (B, 8, 8, 3))) * 0.5,
            np.asarray(jax.random.randint(ky, (B,), 0, 4)))
    return {"student": _np(R_cnn.cnn_init(k_s, R_SPEC)), "noise": noise}


KEYS = {"fed_df": 11, "fed_dafl": 12, "fed_adi": 13}
ADI_E2E = dict(adi_lr=1e-5, refresh_every=2)


@pytest.fixture(scope="module")
def ref_runs(fed):
    _, clients = fed
    xt, _ = _data()["test"]
    out = {}
    for method in KEYS:
        scfg = _r_scfg(method)
        key = jax.random.PRNGKey(KEYS[method])
        kw = ADI_E2E if method == "fed_adi" else {}
        stu, spec = getattr(RB, method)(key, clients, scfg, **kw)
        draws = {"fed_df": lambda: _df_draws(key, scfg),
                 "fed_dafl": lambda: _dafl_draws(key, scfg),
                 "fed_adi": lambda: _adi_draws(key, scfg, 2)}[method]()
        out[method] = dict(draws=draws,
                           logits=np.asarray(R_cnn.cnn_logits(stu, spec, xt)))
    return out


def test_reference_draw_order_is_the_one_injected(fed, ref_runs):
    """The injected draws give the reference's own student init."""
    for method, key in KEYS.items():
        stu0 = ref_runs[method]["draws"]["student"]
        k_s = jax.random.split(jax.random.PRNGKey(key),
                               3 if method == "fed_dafl" else 2)[
            1 if method == "fed_dafl" else 0]
        want = _np(R_cnn.cnn_init(k_s, R_SPEC))
        for a, b in zip(jax.tree.leaves(stu0), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["ref", "fused"])
@pytest.mark.parametrize("method", list(KEYS))
def test_baseline_end_to_end_matches(fed, ref_runs, method, mode):
    scfg = _tscfg(distill_kl_mode=mode,
                  **({"g_lr": 1e-5} if method == "fed_dafl" else {}))
    d = ref_runs[method]["draws"]
    student = interop.cnn_from_ref(d["student"], T_SPEC, device="cpu")
    kw = {}
    if method == "fed_df":
        kw["noise"] = lambda e: torch.tensor(d["noise"][e])
    elif method == "fed_dafl":
        kw["noise"] = lambda e: torch.tensor(d["noise"][e])
        kw["gen"] = interop.generator_from_ref(d["gen"], nz=NZ, img_size=8,
                                               out_ch=3, device="cpu")
    else:
        kw["noise"] = lambda e: tuple(map(torch.tensor, d["noise"][e]))
        kw.update(ADI_E2E)
    got, spec = {"fed_df": fed_df, "fed_dafl": fed_dafl,
                 "fed_adi": fed_adi}[method](
        _port_clients(fed), scfg, device="cpu", student=student, **kw)
    assert got is student and spec == T_SPEC
    xt, _ = _data()["test"]
    with torch.no_grad():
        logits = cnn_logits(got, torch.from_numpy(xt)).numpy()
    np.testing.assert_allclose(logits, ref_runs[method]["logits"],
                               rtol=END_TOL, atol=END_TOL)


@pytest.mark.parametrize("method", [fed_df, fed_dafl, fed_adi])
def test_baselines_draw_their_own_inputs(fed, method):
    """Without injected draws each baseline runs from its seeded sources
    and a seed gives the same student twice."""
    scfg = _tscfg(epochs=2, s_steps=1, g_lr=1e-5)
    outs = []
    for _ in range(2):
        stu, spec = method(_port_clients(fed), scfg, device="cpu")
        assert spec == T_SPEC
        outs.append(interop.cnn_to_ref(stu))
    for a, b in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(outs[1])):
        np.testing.assert_array_equal(a, b)


def test_non_finite_loss_raises(fed):
    scfg = _tscfg(epochs=1, s_steps=1)
    nan = torch.full((1, B, 8, 8, 3), float("nan"))
    with pytest.raises(FloatingPointError, match="fed_df.*epoch 0"):
        fed_df(_port_clients(fed), scfg, device="cpu", noise=lambda e: nan)
    with pytest.raises(ValueError, match="refresh_every"):
        fed_adi(_port_clients(fed), scfg, device="cpu", refresh_every=0)


def test_unported_engines_and_other_devices_raise(fed):
    """``loop_mode="fused"`` is accepted and the baseline runs its own
    loop, as the reference's do: the same student as under the python
    driver. The default device, the card, with clients on the CPU
    raises: with no card (RuntimeError) or with one (ValueError),
    nothing runs on the CPU in its place."""
    clients = _port_clients(fed)
    scfg = _tscfg(epochs=1, s_steps=1)
    students = [fed_df(clients, dataclasses.replace(scfg, loop_mode=mode),
                       device="cpu")[0] for mode in ("python", "fused")]
    for a, b in zip(*(s.state_dict().values() for s in students)):
        assert torch.equal(a, b)
    with pytest.raises((RuntimeError, ValueError)):
        fed_dafl(clients, _tscfg())
