"""The port's multi-round DENSE (``repro_torch.fl.dense_multi_round``)
against the JAX package's (``repro.fl.dense_multi_round``), two rounds.

Both run the per-client engine and the python epoch driver (3 cnn1
clients at width 0.25 on 8x8 images, one local epoch a round, 2 server
epochs of t_g = 2); the reference's KL is its ``ref`` mode, the port's
its CPU profile's (also ``ref``). The reference's key layout,
``split(key, n_clients + rounds + 1)``, gives the round-0 client inits
(``keys[:n]``, injected as ``init_models``) and round r's server key
(``keys[n + r]``), from which its generator init, round 0's student
init and the per-epoch latents and labels are derived as
``repro/core/dense.py`` derives them and injected through
``server_inputs``. Each side's ``train_dense_server`` is wrapped to
record the clients it is handed, and ``eval_fn`` returns the global
model's test logits after each round.

The server runs free at g_lr = 1e-5 (tests/test_torch_round.py says
why). Tolerances: round 0's clients 1e-4 (local training from the same
init); round 1's clients, which start from round 0's global model, and
every global model 1e-3, end to end.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_cifar as R_cfg
from repro.core import generator as R_gen
from repro.data import make_classification_data as r_make_data
from repro.fl import CommLedger as RLedger
from repro.fl import dense_multi_round as r_multi_round
from repro.fl import multiround as R_mr
from repro.models import cnn as R_cnn

from repro_torch import interop
from repro_torch.configs import paper_cifar as T_cfg
from repro_torch.fl import CommLedger, dense_multi_round, param_bytes
from repro_torch.fl import multiround as T_mr
from repro_torch.models.cnn import CNNSpec, cnn_logits

STEP_TOL = 1e-4
END_TOL = 1e-3
ROUNDS = 2
FIELDS = dict(
    n_clients=3, alpha=0.5, local_epochs=1, batch_size=32, num_classes=4,
    image_size=8, in_ch=3, train_per_class=24, test_per_class=8,
    client_kinds=("cnn1",) * 3, global_kind="cnn1", width=0.25, nz=16,
    t_g=2, epochs=2, synth_batch=16, client_loop_mode="python",
    loop_mode="python", distill_kl_mode="ref", g_lr=1e-5)
R_SPEC = R_cnn.CNNSpec(kind="cnn1", num_classes=4, in_ch=3, width=0.25,
                       image_size=8)
T_SPEC = CNNSpec(kind="cnn1", num_classes=4, in_ch=3, width=0.25,
                 image_size=8)
SEED = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data():
    return r_make_data(5, num_classes=4, size=8, ch=3, train_per_class=24,
                       test_per_class=8)


def _server_draws(skey, scfg):
    """What ``train_dense_server`` draws from its key (core/dense.py:318,
    359, 405-408): the generator and student inits, and each epoch's z
    and y."""
    k_gen, k_stu, key = jax.random.split(skey, 3)
    noise = []
    for ek in jax.random.split(key, scfg.epochs):
        kz, ky, _ = jax.random.split(ek, 3)
        noise.append((np.asarray(jax.random.normal(
            kz, (scfg.synth_batch, scfg.nz))),
            np.asarray(jax.random.randint(ky, (scfg.synth_batch,), 0,
                                          scfg.num_classes))))
    return dict(gen=_np(R_gen.img_generator_init(
        k_gen, nz=scfg.nz, img_size=scfg.image_size, out_ch=scfg.in_ch)),
        student=_np(R_cnn.cnn_init(k_stu, R_SPEC)), noise=noise)


def _recording(module, calls):
    inner = module.train_dense_server

    def wrapped(*args, **kw):
        calls.append(args)
        return inner(*args, **kw)
    return wrapped


@pytest.fixture(scope="module")
def ref_run():
    scfg = R_cfg.DenseExperimentConfig(**FIELDS)
    xt, _ = _data()["test"]
    key = jax.random.PRNGKey(6)
    ledger, calls = RLedger(), []
    logits_fn = jax.jit(R_cnn.cnn_logits, static_argnums=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R_mr, "train_dense_server", _recording(R_mr, calls))
        _, _, logits = r_multi_round(
            key, scfg, _data(), rounds=ROUNDS, ledger=ledger, seed=SEED,
            eval_fn=lambda p, spec: np.asarray(logits_fn(p, spec, xt)))
    keys = jax.random.split(key, scfg.n_clients + ROUNDS + 1)
    return dict(
        ledger=ledger, logits=logits,
        client_inits=[_np(R_cnn.cnn_init(k, R_SPEC))
                      for k in keys[:scfg.n_clients]],
        server_keys=[np.asarray(k) for k in keys[scfg.n_clients:-1]],
        rounds=[dict(key=np.asarray(a[0]),
                     clients=[_np(c.params) for c in a[1]],
                     draws=_server_draws(a[0], scfg)) for a in calls])


def _server_inputs(ref):
    def inputs(r):
        d = ref["rounds"][r]["draws"]
        out = {"gen": interop.generator_from_ref(d["gen"], nz=16, img_size=8,
                                                 out_ch=3, device="cpu"),
               "noise": [(torch.tensor(z), torch.tensor(y).long(),
                          torch.zeros((0, 16, 16)))
                         for z, y in d["noise"]].__getitem__}
        if r == 0:
            out["student"] = interop.cnn_from_ref(d["student"], T_SPEC,
                                                  device="cpu")
        return out
    return inputs


@pytest.fixture(scope="module")
def port_run(ref_run):
    scfg = T_cfg.DenseExperimentConfig(**FIELDS)
    xt, _ = _data()["test"]
    ledger, calls = CommLedger(), []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T_mr, "train_dense_server", _recording(T_mr, calls))
        model, spec, logits = dense_multi_round(
            scfg, _data(), rounds=ROUNDS, ledger=ledger, seed=SEED,
            device="cpu",
            init_models=[interop.cnn_from_ref(p, T_SPEC, device="cpu")
                         for p in ref_run["client_inits"]],
            server_inputs=_server_inputs(ref_run),
            eval_fn=lambda m, spec: cnn_logits(
                m, torch.from_numpy(xt)).detach().numpy())
    return dict(model=model, spec=spec, ledger=ledger, logits=logits,
                rounds=[[c for c in a[0]] for a in calls])


def test_reference_server_keys_follow_its_layout(ref_run):
    """Round r's server key is keys[n + r]: the draws injected are the
    reference's."""
    assert len(ref_run["rounds"]) == ROUNDS
    for r, rnd in enumerate(ref_run["rounds"]):
        np.testing.assert_array_equal(rnd["key"], ref_run["server_keys"][r])


def test_ledger_matches(ref_run, port_run):
    got, want = port_run["ledger"], ref_run["ledger"]
    assert [(e["dir"], e["who"], e["bytes"], e["what"]) for e in got.events] \
        == [(e["dir"], e["who"], e["bytes"], e["what"])
            for e in want.events]
    assert got.rounds == want.rounds == ROUNDS
    n = FIELDS["n_clients"]
    assert got.downlink_bytes == n * param_bytes(port_run["model"]) \
        * (ROUNDS - 1)


@pytest.mark.parametrize("r,tol", [(0, STEP_TOL), (1, END_TOL)])
def test_round_clients_match(ref_run, port_run, r, tol):
    got = port_run["rounds"][r]
    want = ref_run["rounds"][r]["clients"]
    assert len(got) == len(want) == FIELDS["n_clients"]
    for c, w in zip(got, want):
        assert c.spec == T_SPEC
        for a, b in zip(jax.tree.leaves(interop.cnn_to_ref(c.model)),
                        jax.tree.leaves(w), strict=True):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("r", range(ROUNDS))
def test_global_model_logits_match_each_round(ref_run, port_run, r):
    np.testing.assert_allclose(port_run["logits"][r], ref_run["logits"][r],
                               rtol=END_TOL, atol=END_TOL)


def test_round_one_warm_starts_from_the_global_model(port_run):
    """Every round-1 client and the round-1 student start from copies of
    round 0's global model: the student is returned trained in place,
    and no client shares its tensors."""
    clients = port_run["rounds"][1]
    ptrs = {p.data_ptr() for c in clients for p in c.model.parameters()}
    assert not ptrs & {p.data_ptr() for p in port_run["model"].parameters()}
    assert port_run["spec"] == T_SPEC


@pytest.mark.parametrize("knob,exact", [({"loop_mode": "fused"}, True),
                                        ({"teacher_chunk": 2}, False)])
def test_unported_paths_raise(ref_run, port_run, knob, exact):
    """What was refused until the fused epoch driver and the chunked
    teacher were ported now runs every round: from the same inits and
    draws, the fused driver (chunks of one epoch here) gives the python
    driver's global models bit for bit, and the chunked teacher gives
    the reference's to 1e-3 end to end, with the same ledger."""
    scfg = dataclasses.replace(T_cfg.DenseExperimentConfig(**FIELDS),
                               loop_chunk=1, **knob)
    xt, _ = _data()["test"]
    ledger = CommLedger()
    _, _, logits = dense_multi_round(
        scfg, _data(), rounds=ROUNDS, ledger=ledger, seed=SEED,
        device="cpu",
        init_models=[interop.cnn_from_ref(p, T_SPEC, device="cpu")
                     for p in ref_run["client_inits"]],
        server_inputs=_server_inputs(ref_run),
        eval_fn=lambda m, spec: cnn_logits(
            m, torch.from_numpy(xt)).detach().numpy())
    assert ledger.events == port_run["ledger"].events
    for r in range(ROUNDS):
        if exact:
            np.testing.assert_array_equal(logits[r], port_run["logits"][r])
        np.testing.assert_allclose(logits[r], ref_run["logits"][r],
                                   rtol=END_TOL, atol=END_TOL)


def test_grouped_matches_per_client_two_rounds(ref_run):
    """The grouped local phase (the default engine) against the
    per-client one, from the same round-0 inits and server draws: the
    global model after two rounds to 5e-3, as tests/test_federation.py
    holds the reference's two engines; the same uploads and broadcasts."""
    out = {}
    for mode in ("python", "grouped"):
        scfg = dataclasses.replace(T_cfg.DenseExperimentConfig(**FIELDS),
                                   client_loop_mode=mode)
        ledger = CommLedger()
        model, _, _ = dense_multi_round(
            scfg, _data(), rounds=ROUNDS, ledger=ledger, seed=SEED,
            device="cpu",
            init_models=[interop.cnn_from_ref(p, T_SPEC, device="cpu")
                         for p in ref_run["client_inits"]],
            server_inputs=_server_inputs(ref_run))
        out[mode] = (interop.cnn_to_ref(model), ledger.events)
    for a, b in zip(jax.tree.leaves(out["grouped"][0]),
                    jax.tree.leaves(out["python"][0]), strict=True):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-3)
    assert out["grouped"][1] == out["python"][1]


def test_default_draws_run_and_repeat():
    """Without injected inits or draws: seeded sources, one upload per
    client a round, the same global model twice."""
    scfg = dataclasses.replace(T_cfg.DenseExperimentConfig(**FIELDS),
                               n_clients=2, epochs=1, t_g=1)
    outs = []
    for _ in range(2):
        ledger = CommLedger()
        model, _, accs = dense_multi_round(
            scfg, _data(), rounds=2, ledger=ledger, device="cpu",
            eval_fn=lambda m, spec: 0.5)
        assert ledger.rounds == 2 and accs == [0.5, 0.5]
        outs.append(interop.cnn_to_ref(model))
    for a, b in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(outs[1])):
        np.testing.assert_array_equal(a, b)
