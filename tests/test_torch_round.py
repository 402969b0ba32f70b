"""The port's one-shot round against the JAX package's, end to end.

A trimmed ``smoke()``-like federation (3 resnet18 clients at width
0.125, 8x8 images, one local epoch, 2 server epochs of t_g = 2,
synth_batch 16) runs through the reference's per-client engine and
python epoch driver, and through the port on the CPU. The reference's
client, generator and student inits are carried across
(``repro_torch.interop``) and its per-epoch latents and labels, derived
as ``repro/core/dense.py`` derives them, are injected. The port runs
both KL modes; the reference runs its ``ref`` mode (its fused mode is
the same arithmetic, held to it in tests/test_torch_kernels.py).

The round runs free, with g_lr = 1e-5 for the generator's Adam. At the
paper's 1e-3, Adam's first steps move every generator weight by about
±lr whatever the size of its gradient, so the few weights whose gradient
lies within float32 noise of zero move 2·lr apart in the two frameworks,
and two epochs later the losses differ at the percent level. At 1e-5 the
same flips move weights 2e-5 apart. The paper's
learning rates are held step by step, from the reference's own states,
in tests/test_torch_steps.py.

Tolerances: 1e-4 for what one step produces (the local-training steps, a
FedAvg), where the two frameworks differ only in float32 summation
order; 1e-3 end to end, for the per-epoch losses and the student's
logits after the round, where those differences have passed through
every step of both stages.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_cifar as R_cfg
from repro.core import generator as R_gen
from repro.core.dense import train_dense_server as r_train
from repro.data import make_classification_data as r_make_data
from repro.fl import CommLedger as RLedger
from repro.fl import build_federation as r_build
from repro.fl import fedavg as r_fedavg
from repro.fl import param_bytes as r_param_bytes
from repro.models import cnn as R_cnn

from repro_torch import interop
from repro_torch.configs import paper_cifar as T_cfg
from repro_torch.core import evaluate, train_dense_server
from repro_torch.data import make_classification_data
from repro_torch.fl import CommLedger, build_federation, fedavg, param_bytes
from repro_torch.models.cnn import CNNSpec, cnn_logits

STEP_TOL = 1e-4
END_TOL = 1e-3

FIELDS = dict(
    n_clients=3, alpha=0.5, local_epochs=1, batch_size=32, num_classes=4,
    image_size=8, in_ch=3, train_per_class=24, test_per_class=8,
    client_kinds=("resnet18",) * 3, global_kind="resnet18", width=0.125,
    nz=16, t_g=2, epochs=2, synth_batch=16, client_loop_mode="python",
    loop_mode="python", distill_kl_mode="ref", g_lr=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data(make):
    s = R_cfg.DenseExperimentConfig(**FIELDS)
    return make(0, num_classes=s.num_classes, size=s.image_size, ch=s.in_ch,
                train_per_class=s.train_per_class,
                test_per_class=s.test_per_class)


@pytest.fixture(scope="module")
def ref_round():
    scfg = R_cfg.DenseExperimentConfig(**FIELDS)
    data = _data(r_make_data)
    key = jax.random.PRNGKey(0)
    spec = R_cnn.CNNSpec(kind="resnet18", num_classes=scfg.num_classes,
                         in_ch=scfg.in_ch, width=scfg.width,
                         image_size=scfg.image_size)
    # the inits _build_python_federation draws for each client
    client_inits = [_np(R_cnn.cnn_init(k, spec))
                    for k in jax.random.split(key, scfg.n_clients)]
    ledger = RLedger()
    clients, _ = r_build(key, scfg, data, ledger=ledger)
    avg = _np(r_fedavg(clients))

    # the inits and noise train_dense_server draws (core/dense.py)
    skey = jax.random.PRNGKey(1)
    k_gen, k_stu, k_epochs = jax.random.split(skey, 3)
    gen0 = _np(R_gen.img_generator_init(k_gen, nz=scfg.nz,
                                        img_size=scfg.image_size,
                                        out_ch=scfg.in_ch))
    stu0 = _np(R_cnn.cnn_init(k_stu, spec))
    noise = []
    for ek in jax.random.split(k_epochs, scfg.epochs):
        kz, ky, _ = jax.random.split(ek, 3)
        noise.append((np.asarray(jax.random.normal(
            kz, (scfg.synth_batch, scfg.nz))),
            np.asarray(jax.random.randint(ky, (scfg.synth_batch,), 0,
                                          scfg.num_classes))))
    stu, _, hist = r_train(skey, clients, scfg)
    xt, _ = data["test"]
    return dict(client_inits=client_inits, clients=clients, ledger=ledger,
                avg=avg, gen0=gen0, stu0=stu0, noise=noise, hist=hist,
                logits=np.asarray(R_cnn.cnn_logits(stu, spec, xt)))


def _port_federation(ref):
    scfg = T_cfg.DenseExperimentConfig(**FIELDS)
    spec = CNNSpec(kind="resnet18", num_classes=scfg.num_classes,
                   in_ch=scfg.in_ch, width=scfg.width,
                   image_size=scfg.image_size)
    inits = [interop.cnn_from_ref(p, spec, device="cpu")
             for p in ref["client_inits"]]
    ledger = CommLedger()
    clients, _ = build_federation(scfg, _data(make_classification_data),
                                  device="cpu", ledger=ledger,
                                  init_models=inits)
    return scfg, spec, clients, ledger


@pytest.fixture(scope="module")
def port_federation(ref_round):
    return _port_federation(ref_round)


@pytest.fixture(scope="module", params=["ref", "fused"])
def port_round(request, ref_round, port_federation):
    scfg, spec, clients, _ = port_federation
    scfg = dataclasses.replace(scfg, distill_kl_mode=request.param)
    ref = ref_round
    noise = [(torch.tensor(z), torch.tensor(y).long(),
              torch.zeros((0, scfg.synth_batch, scfg.nz)))
             for z, y in ref["noise"]]
    gen = interop.generator_from_ref(ref["gen0"], nz=scfg.nz,
                                     img_size=scfg.image_size,
                                     out_ch=scfg.in_ch, device="cpu")
    stu = interop.cnn_from_ref(ref["stu0"], spec, device="cpu")
    stu, gen, hist = train_dense_server(clients, scfg, device="cpu",
                                        noise=noise.__getitem__, gen=gen,
                                        student=stu)
    xt, _ = _data(make_classification_data)["test"]
    with torch.no_grad():
        logits = cnn_logits(stu, torch.from_numpy(xt)).numpy()
    return dict(mode=request.param, hist=hist, logits=logits, student=stu)


def _assert_trees(got, want, tol):
    gl, gdef = jax.tree.flatten(got)
    wl, wdef = jax.tree.flatten(want)
    assert gdef == wdef
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def test_configs_have_the_same_fields_and_defaults():
    assert dataclasses.asdict(T_cfg.CONFIG) == dataclasses.asdict(R_cfg.CONFIG)
    assert dataclasses.asdict(T_cfg.smoke()) == dataclasses.asdict(R_cfg.smoke())


def test_trained_clients_match(ref_round, port_federation):
    _, _, clients, _ = port_federation
    for c, rc in zip(clients, ref_round["clients"]):
        assert c.n_data == rc.n_data
        np.testing.assert_array_equal(c.class_counts, rc.class_counts)
        _assert_trees(interop.cnn_to_ref(c.model), _np(rc.params), STEP_TOL)


def test_fedavg_matches(ref_round, port_federation):
    _, _, clients, _ = port_federation
    _assert_trees(interop.cnn_to_ref(fedavg(clients)), ref_round["avg"],
                  STEP_TOL)


def test_one_shot_communication_profile(ref_round, port_federation):
    _, _, clients, ledger = port_federation
    assert ledger.rounds == 1 and ledger.downlink_bytes == 0
    assert ledger.uplink_bytes == sum(param_bytes(c.model) for c in clients)
    assert ledger.uplink_bytes == ref_round["ledger"].uplink_bytes
    assert [param_bytes(c.model) for c in clients] == \
        [r_param_bytes(c.params) for c in ref_round["clients"]]


def test_epoch_losses_match(ref_round, port_round):
    want, got = ref_round["hist"], port_round["hist"]
    np.testing.assert_allclose(got.gen_loss, want.gen_loss, rtol=END_TOL,
                               atol=END_TOL)
    np.testing.assert_allclose(got.dis_loss, want.dis_loss, rtol=END_TOL,
                               atol=END_TOL)
    for g, w in zip(got.gen_parts, want.gen_parts, strict=True):
        for part in ("ce", "bn", "div"):
            np.testing.assert_allclose(g[part], w[part], rtol=END_TOL,
                                       atol=END_TOL)


def test_student_logits_match_end_to_end(ref_round, port_round):
    np.testing.assert_allclose(port_round["logits"], ref_round["logits"],
                               rtol=END_TOL, atol=END_TOL)


def test_evaluate_is_top1_accuracy(port_round):
    data = _data(make_classification_data)
    xt, yt = data["test"]
    want = float(np.mean(port_round["logits"].argmax(-1) == yt))
    assert evaluate(port_round["student"], xt, yt, batch=7) == want


def test_non_finite_loss_raises(port_federation):
    """nan_policy="raise" (the default): a non-finite loss stops the run
    at the end of its epoch."""
    scfg, _, clients, _ = port_federation
    z = torch.full((scfg.synth_batch, scfg.nz), float("nan"))
    noise = (z, torch.zeros(scfg.synth_batch, dtype=torch.long),
             torch.zeros((0, scfg.synth_batch, scfg.nz)))
    with pytest.raises(FloatingPointError, match="epoch 0"):
        train_dense_server(clients, dataclasses.replace(scfg, epochs=1,
                                                        t_g=1),
                           device="cpu", noise=lambda epoch: noise)
