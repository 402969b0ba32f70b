"""The port's fault-tolerant one-shot round against the JAX package's:
upload faults, admission, the masked consumers, ``nan_policy`` and
multi-round delays.

One federation of 5 cnn1 clients (width 0.25, 8x8x1 images, one local
epoch) is trained once by the port and carried into the reference
(``interop.cnn_to_ref``), so both packages screen the same uploads. The
fault plan is numpy-seeded in both, so it is compared as it is. The
corruption is drawn with ``jax.random`` in the reference and a
``torch.Generator`` in the port: the reference's corrupted uploads are
injected into the port (``corrupt=``), and the port's own corruption is
held to its kinds and rates. The server runs use the reference's
generator and student inits and its per-epoch draws, as
tests/test_torch_round.py injects them, at g_lr 1e-5.

Tolerances: the ledger, the plan, the quarantined set and its reasons
exactly (the numbers in an outlier's reason to 1e-2, the precision it
prints); the masked teacher bit for bit against the port's federation
built without the quarantined clients, and to 1e-5 of its largest logit
against the reference's; FedAvg over the survivors 1e-6; the per-epoch
losses of a poisoned run 1e-4 relative, NaN where the reference's are.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_cifar as R_cfg
from repro.core import generator as R_gen
from repro.core.dense import train_dense_server as r_train
from repro.core.ensemble import Client as RClient
from repro.core.ensemble import grouped_ensemble_logits as r_logits
from repro.core.ensemble import stack_grouped as r_stack
from repro.fl import CommLedger as RLedger
from repro.fl import QuorumError as RQuorumError
from repro.fl import UploadError as RUploadError
from repro.fl import admit_uploads as r_admit
from repro.fl import build_fault_plan as r_plan
from repro.fl import fedavg as r_fedavg
from repro.fl import faults as R_faults
from repro.fl.faults import apply_upload_faults as r_apply
from repro.models import cnn as R_cnn

from repro_torch import interop
from repro_torch.configs import paper_cifar as T_cfg
from repro_torch.core import (grouped_ensemble_logits, img_generator_init,
                              stack_grouped, train_dense_server)
from repro_torch.core.dense import load_server_models
from repro_torch.data import make_classification_data
from repro_torch.fl import (ClientList, CommLedger, Fault, QuorumError,
                            UploadError, admit_uploads, apply_upload_faults,
                            build_fault_plan, build_federation,
                            corrupt_params, dense_multi_round, fed_adi,
                            fed_dafl, fed_df, fedavg, fedavg_stacked)
from repro_torch.fl import multiround as T_mr
from repro_torch.fl import protocol as T_protocol
from repro_torch.fl.faults import fault_seed
from repro_torch.models.cnn import CNNSpec, cnn_init

FIELDS = dict(
    n_clients=5, alpha=0.5, local_epochs=1, batch_size=16, num_classes=4,
    image_size=8, in_ch=1, train_per_class=37, test_per_class=8,
    client_kinds=("cnn1",) * 5, global_kind="cnn1", width=0.25, nz=16,
    t_g=1, epochs=3, synth_batch=16, g_lr=1e-5, loop_mode="python",
    distill_kl_mode="ref")
T_SPEC = CNNSpec(kind="cnn1", num_classes=4, in_ch=1, width=0.25,
                 image_size=8)
R_SPEC = R_cnn.CNNSpec(kind="cnn1", num_classes=4, in_ch=1, width=0.25,
                       image_size=8)
TAG = "round0-model-upload"
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size tensors gain nothing from torch's thread pool, and its
    threads and XLA's slow each other down tenfold in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scfgs(**kw):
    return (T_cfg.DenseExperimentConfig(**{**FIELDS, **kw}),
            R_cfg.DenseExperimentConfig(**{**FIELDS, **kw}))


def _data():
    return make_classification_data(0, num_classes=4, size=8, ch=1,
                                    train_per_class=37, test_per_class=8)


@pytest.fixture(scope="module")
def fed():
    """The port's trained federation (a grouped ClientList) and the same
    uploads as reference clients."""
    scfg, _ = _scfgs()
    clients, _ = build_federation(scfg, _data(), device="cpu")
    ref = [RClient(spec=R_SPEC, params=jax.tree.map(
               jnp.asarray, interop.cnn_to_ref(c.model)), n_data=c.n_data,
               class_counts=c.class_counts) for c in clients]
    return clients, ref


def _boundary(fed, source="reference", **kw):
    """One round's upload boundary in both packages on the same uploads:
    (port admitted, its ledger, reference admitted, its ledger), or the
    exception each admission raised. The corrupted uploads are the
    reference's (``source="reference"``, injected into the port) or the
    port's own seeded ones (``"port"``, injected into the reference in
    place of its ``corrupt_params``)."""
    clients, ref = fed
    tscfg, rscfg = _scfgs(**kw)
    rled, tled = RLedger(), CommLedger()
    plan = build_fault_plan(tscfg)
    if source == "reference":
        r_clients, arrived, _ = r_apply(
            ref, r_plan(rscfg), key=jax.random.PRNGKey(fault_seed(rscfg, 0)),
            ledger=rled, upload_tag=TAG)

        def corrupt(i, model, fault):
            return interop.cnn_from_ref(jax.tree.map(np.asarray,
                                                     r_clients[i].params),
                                        T_SPEC, device="cpu")
    else:
        corrupt = None
    t_clients, t_arrived, _ = apply_upload_faults(
        clients, plan, seed=fault_seed(tscfg, 0), ledger=tled,
        upload_tag=TAG, corrupt=corrupt)
    if source == "port":
        ours = [interop.cnn_to_ref(t_clients[i].model) for i in sorted(plan)
                if plan[i].kind not in ("drop", "delay")]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(R_faults, "corrupt_params",
                       lambda params, kind, **_: jax.tree.map(
                           jnp.asarray, ours.pop(0)))
            r_clients, arrived, _ = r_apply(
                ref, r_plan(rscfg), key=jax.random.PRNGKey(0), ledger=rled,
                upload_tag=TAG)
        assert not ours
    np.testing.assert_array_equal(t_arrived, arrived)
    out = []
    for admit, cl, scfg, led in ((admit_uploads, t_clients, tscfg, tled),
                                 (r_admit, r_clients, rscfg, rled)):
        try:
            out += [admit(cl, arrived=arrived, scfg=scfg, ledger=led), led]
        except (UploadError, QuorumError, RUploadError, RQuorumError) as e:
            out += [e, led]
    return out


_NUM = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")


def _same_reasons(got: dict, want: dict):
    assert got.keys() == want.keys()
    for i in want:
        assert _NUM.sub("#", got[i]) == _NUM.sub("#", want[i]), (got, want)
        np.testing.assert_allclose(
            [float(v) for v in _NUM.findall(got[i])],
            [float(v) for v in _NUM.findall(want[i])], rtol=1e-2)


# ------------------------------------------------------------ fault plan ---

@pytest.mark.parametrize("kw", [
    dict(fault_plan=((1, "nan"), (3, "drop"))),
    dict(n_clients=10, dropout_frac=0.3, fault_seed=4,
         fault_plan=((1, "nan"),)),
    dict(n_clients=10, dropout_frac=0.5, fault_seed=7,
         fault_plan=((2, "noise", 50.0), (4, "delay", 10.0, 1))),
    dict(n_clients=20, dropout_frac=0.25, fault_seed=1)])
@pytest.mark.parametrize("rnd", [0, 1])
def test_fault_plan_is_the_references(kw, rnd):
    tscfg, rscfg = _scfgs(**kw)
    got = build_fault_plan(tscfg, round=rnd)
    want = r_plan(rscfg, round=rnd)
    assert {i: (f.client, f.kind, f.scale, f.round) for i, f in got.items()} \
        == {i: (f.client, f.kind, f.scale, f.round) for i, f in want.items()}
    assert list(got) == list(want)


def test_fault_plan_validates():
    with pytest.raises(ValueError):
        Fault(client=0, kind="gremlin")
    with pytest.raises(ValueError):
        build_fault_plan(_scfgs(fault_plan=((7, "drop"),))[0])
    with pytest.raises(ValueError):
        build_fault_plan(_scfgs(dropout_frac=1.5)[0])


def test_corrupt_params_kinds():
    """Every tensor of the upload, BN statistics included, is hit at the
    reference's rates; the upload itself is left as it is; one seed gives
    one corruption."""
    model = cnn_init(T_SPEC, device="cpu")
    state = {k: v.clone() for k, v in model.net.state_dict().items()}

    def run(kind, seed=1):
        return corrupt_params(model, kind, scale=10.0,
                              generator=torch.Generator().manual_seed(seed))

    for kind, test in (("nan", torch.isnan), ("inf", torch.isinf)):
        got = run(kind).net.state_dict()
        hits = {k: test(v) for k, v in got.items()}
        for k, v in got.items():
            assert torch.equal(v[~hits[k]], state[k][~hits[k]]), k
        # max(1%, 1/numel) of each tensor's elements: the weights at about
        # 1%, the BatchNorm running statistics hit too
        big = [h for k, h in hits.items() if h.numel() >= 1000]
        share = float(sum(h.sum() for h in big) / sum(h.numel() for h in big))
        assert 0.005 < share < 0.02
        assert any(h.any() for k, h in hits.items()
                   if k.endswith((".bn.mean", ".bn.var")))
    for k, v in run("signflip").net.state_dict().items():
        assert torch.equal(v, -state[k])
    noisy = run("noise").net.state_dict()
    assert all(torch.isfinite(v).all() for v in noisy.values())
    assert not torch.equal(noisy["fc.w"], state["fc.w"])
    for a, b in zip(noisy.values(), run("noise").net.state_dict().values()):
        assert torch.equal(a, b)
    assert not torch.equal(noisy["fc.w"], run("noise", 2).net.state_dict()[
        "fc.w"])
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, state[k])
    with pytest.raises(ValueError):
        run("drop")


# --------------------------------------------- the boundary and admission ---

@pytest.mark.parametrize("source,kw", [
    ("reference", dict(fault_plan=((1, "nan"), (3, "drop")))),
    ("reference", dict(fault_plan=((2, "inf"),))),
    ("reference", dict(fault_plan=((4, "delay"),))),
    ("port", dict(fault_plan=((2, "noise", 50.0), (4, "inf")),
                  norm_screen=6.0)),
    ("reference", dict(fault_plan=((2, "signflip"),), norm_screen=6.0)),
    ("reference", dict(fault_plan=((2, "signflip"),), cos_screen=0.0)),
    ("port", dict(fault_plan=((0, "signflip"), (3, "nan")),
                  cos_screen=0.0)),
    ("reference", dict(dropout_frac=0.4, fault_seed=3))],
    ids=["nan_drop", "inf", "delay", "noise_norm", "signflip_norm",
         "signflip_cos", "own_signflip_nan", "dropout"])
def test_admission_is_the_references(fed, source, kw):
    """The ledger event for event, and the same quarantined clients for
    the same reasons: the finite screen (nan, inf), a missing upload
    (drop, delay, dropout_frac), the norm screen (noise; a sign flip
    keeps its norm and passes it) and the cosine screen (sign flip), on
    the reference's corrupted uploads and on the port's own."""
    got, tled, want, rled = _boundary(fed, source, **kw)
    assert tled.events == rled.events
    assert tled.uplink_bytes == rled.uplink_bytes and tled.rounds == 1
    _same_reasons(got.quarantined, want.quarantined)
    np.testing.assert_array_equal(got.survivor_mask, want.survivor_mask)
    assert [None if m is None else m.tolist() for m in got.group_masks] == \
        [None if m is None else m.tolist() for m in want.group_masks]
    if "signflip" in str(kw) and "cos_screen" not in kw:
        assert got.quarantined == {}
    else:
        assert got.quarantined


def test_strict_and_quorum_raise(fed):
    got, _, want, _ = _boundary(fed, fault_plan=((1, "nan"),),
                                upload_policy="strict")
    assert isinstance(got, UploadError) and isinstance(want, RUploadError)
    assert str(got) == str(want)
    got, _, want, _ = _boundary(fed, fault_plan=((1, "drop"),),
                                upload_policy="strict")
    assert got.quarantined.keys() == want.quarantined.keys() == {1}
    got, _, want, _ = _boundary(fed, fault_plan=((1, "nan"), (3, "drop")),
                                quorum=0.9)
    assert isinstance(got, QuorumError) and isinstance(want, RQuorumError)
    with pytest.raises(ValueError, match="upload_policy"):
        admit_uploads(fed[0], upload_policy="lenient")


def test_build_federation_with_its_own_faults():
    """The port's own seeded corruption end to end: a NaN upload is
    quarantined with a zero-filled slot, a drop never lands, and the
    ledger says so."""
    scfg, _ = _scfgs(n_clients=3, client_kinds=("cnn1",) * 3,
                     fault_plan=((0, "nan"), (2, "drop")), quorum=0.3)
    led = CommLedger()
    clients, _, (arrived, delayed) = build_federation(
        scfg, _data(), device="cpu", ledger=led, return_faults=True)
    assert isinstance(clients, ClientList) and not delayed
    assert arrived.tolist() == [True, True, False]
    assert clients.quarantined == {0: "non-finite parameters",
                                   2: "upload never arrived"}
    assert clients.survivor_mask.tolist() == [False, True, False]
    assert [(e["who"], e["kind"]) for e in led.events] == [
        ("client2", "dropped"), ("client0", "delivered"),
        ("client1", "delivered"), ("client0", "rejected")]
    raw = clients.grouped[1][0]
    assert all(float(v[0].abs().max()) == 0 for v in raw.values())
    assert stack_grouped(clients)[0] == ((T_SPEC, 1),)


def test_build_federation_lands_a_pending_upload():
    """``build_federation(round=, pending=)``: round 0 holds client 1's
    upload back (``return_faults``), and round 1 (trained on another
    split, ``seed=1``) lands it as client 1's upload, under round 1's
    tag."""
    scfg, _ = _scfgs(n_clients=3, client_kinds=("cnn1",) * 3,
                     fault_plan=(Fault(client=1, kind="delay", round=0),),
                     quorum=0.4)
    led = CommLedger()
    r0, _, (arrived0, delayed0) = build_federation(
        scfg, _data(), device="cpu", ledger=led, return_faults=True)
    assert arrived0.tolist() == [True, False, True] and list(delayed0) == [1]
    assert r0.quarantined == {1: "upload never arrived"}
    held = {k: v.clone() for k, v in delayed0[1].net.state_dict().items()}
    r1, _, (arrived1, delayed1) = build_federation(
        scfg, _data(), device="cpu", ledger=led, seed=1, round=1,
        pending=delayed0, return_faults=True)
    assert arrived1.all() and not delayed1 and r1.quarantined == {}
    got = r1[1].model.net.state_dict()
    assert all(torch.equal(got[k], v) for k, v in held.items())
    kinds = {(e["who"], e["what"]): e["kind"] for e in led.events
             if e["dir"] == "up"}
    assert kinds == {(f"client{i}", f"round{r}-model-upload"):
                     "delayed" if (i, r) == (1, 0) else "delivered"
                     for i in range(3) for r in range(2)}


# ------------------------------------------------------ masked consumers ---

@pytest.fixture(scope="module")
def admitted(fed):
    got, _, want, _ = _boundary(fed, fault_plan=((1, "nan"), (3, "drop")))
    return got, want


def test_masked_teacher_is_the_federation_without_them(fed, admitted):
    got, want = admitted
    without = [c for i, c in enumerate(fed[0]) if i not in (1, 3)]
    x = np.random.default_rng(0).uniform(-1, 1, (16, 8, 8, 1)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    masked = stack_grouped(got)
    assert masked[0] == ((T_SPEC, 3),)
    a, sa = grouped_ensemble_logits(*masked, xt, with_bn_stats=True)
    b, sb = grouped_ensemble_logits(*stack_grouped(without), xt,
                                    with_bn_stats=True)
    assert torch.equal(a, b)
    for ca, cb in zip(sa, sb, strict=True):
        for la, lb in zip(ca, cb, strict=True):
            for k in la:
                assert torch.equal(la[k], lb[k])
    gs, gp = r_stack(want)
    r = np.asarray(jax.jit(lambda p, x: r_logits(gs, p, x))(gp,
                                                             jnp.asarray(x)))
    assert np.abs(a.numpy() - r).max() <= 1e-5 * np.abs(r).max()


def test_fedavg_over_the_survivors(fed, admitted):
    got, want = admitted
    avg = interop.cnn_to_ref(fedavg(got))
    for a, b in zip(jax.tree.leaves(avg), jax.tree.leaves(
            jax.tree.map(np.asarray, r_fedavg(want))), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    # a federation without a grouped stack averages the same survivors
    class Masked(list):
        survivor_mask = got.survivor_mask

    assert all(torch.equal(u, v) for u, v in zip(
        fedavg(Masked(got)).state_dict().values(),
        fedavg(got).state_dict().values()))
    with pytest.raises(ValueError, match="zero surviving"):
        fedavg_stacked(got.grouped[1][0], [c.n_data for c in got],
                       survivor_mask=[False] * 5)


@pytest.mark.parametrize("baseline", [fed_df, fed_dafl, fed_adi],
                         ids=["fed_df", "fed_dafl", "fed_adi"])
def test_baselines_read_the_survivors_only(fed, admitted, baseline):
    """FedDF, Fed-DAFL and Fed-ADI on the admitted federation give what
    they give on a federation built without the quarantined clients."""
    got, _ = admitted
    without = [c for i, c in enumerate(fed[0]) if i not in (1, 3)]
    scfg, _ = _scfgs(epochs=1)
    out = [baseline(clients, scfg, device="cpu")[0].state_dict()
           for clients in (got, without)]
    for a, b in zip(out[0].values(), out[1].values(), strict=True):
        assert torch.equal(a, b)


# ----------------------------------------------------------- nan_policy ---

@pytest.fixture(scope="module")
def ref_poisoned(admitted, tmp_path_factory):
    """The reference's skip run on the admitted federation, epoch 1
    poisoned, with a server checkpoint every epoch, and the inits and
    draws its key gives."""
    _, want = admitted
    ckpt = str(tmp_path_factory.mktemp("ref") / "server")
    _, rscfg = _scfgs(nan_policy="skip", checkpoint_every=1,
                      checkpoint_path=ckpt)
    key = jax.random.PRNGKey(3)
    k_gen, k_stu, k_ep = jax.random.split(key, 3)
    noise = []
    for ek in jax.random.split(k_ep, rscfg.epochs):
        kz, ky, _ = jax.random.split(ek, 3)
        noise.append((np.asarray(jax.random.normal(kz, (16, 16))),
                      np.asarray(jax.random.randint(ky, (16,), 0, 4))))
    _, _, hist = r_train(key, want, rscfg, _poison_epochs=[1])
    return dict(hist=hist, noise=noise, ckpt=ckpt,
                gen=jax.tree.map(np.asarray, R_gen.img_generator_init(
                    k_gen, nz=16, img_size=8, out_ch=1)),
                stu=jax.tree.map(np.asarray, R_cnn.cnn_init(k_stu, R_SPEC)))


def _port_server(clients, ref, poison=(1,), **kw):
    scfg, _ = _scfgs(**kw)
    noise = [(torch.tensor(z), torch.tensor(y).long(),
              torch.zeros((0, 16, 16))) for z, y in ref["noise"]]
    gen = interop.generator_from_ref(ref["gen"], nz=16, img_size=8,
                                     out_ch=1, device="cpu")
    stu = interop.cnn_from_ref(ref["stu"], T_SPEC, device="cpu")
    return train_dense_server(clients, scfg, device="cpu",
                              noise=noise.__getitem__, gen=gen, student=stu,
                              _poison_epochs=poison)


@pytest.mark.parametrize("kl", ["ref", "fused"])
def test_skip_and_rollback_match_the_reference(admitted, ref_poisoned, kl):
    """Epoch 1's latents are NaN: its losses are NaN in both packages,
    and the epochs around it agree with the reference's skip run (whose
    rollback gives the same losses); skip and rollback give the same
    generator and student, the whole epoch having been poisoned."""
    got, _ = admitted
    want = ref_poisoned["hist"]
    out = {}
    for policy in ("skip", "rollback"):
        stu, gen, hist = _port_server(got, ref_poisoned, nan_policy=policy,
                                      distill_kl_mode=kl)
        for g, w in ((hist.gen_loss, want.gen_loss),
                     (hist.dis_loss, want.dis_loss)):
            g, w = np.asarray(g), np.asarray(w)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            assert np.isnan(g[1])
            ok = ~np.isnan(w)
            np.testing.assert_allclose(g[ok], w[ok], rtol=LOSS_RTOL, atol=0)
        out[policy] = [v.clone() for v in (*stu.state_dict().values(),
                                           *gen.state_dict().values())]
    assert all(torch.equal(a, b) for a, b in zip(out["skip"],
                                                 out["rollback"]))


def test_skip_guard_leaves_a_healthy_run_as_it_was(admitted, ref_poisoned):
    """Without a poisoned step the guarded steps give exactly what the
    unguarded ones give; "raise" raises at the poisoned epoch."""
    got, _ = admitted
    runs = [_port_server(got, ref_poisoned, nan_policy=p, poison=[])
            for p in ("raise", "skip")]
    for a, b in zip(*(list(s.state_dict().values())
                      + list(g.state_dict().values()) for s, g, _ in runs)):
        assert torch.equal(a, b)
    with pytest.raises(FloatingPointError, match="epoch 1"):
        _port_server(got, ref_poisoned, nan_policy="raise")


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_guarded_optimizer_steps(name):
    """``step_if`` gives ``step``'s values bit for bit where the guard
    passes and moves nothing where it fails, Adam's count included."""
    from repro_torch import optim

    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(40, 7, generator=gen) for _ in range(3)]

    def make(ps):
        return optim.adam(ps, 1e-3) if name == "adam" else \
            optim.sgd(ps, 0.1, momentum=0.9)

    p1, p2 = [p.clone() for p in params], [p.clone() for p in params]
    o1, o2 = make(p1), make(p2)
    for step in range(30):
        grads = [torch.randn(p.shape, generator=gen) for p in params]
        o1.step(grads)
        o2.step_if(grads, torch.tensor(True))
        if step == 10:              # a skipped step between two good ones
            o2.step_if([torch.full_like(p, float("nan")) for p in p2],
                       torch.tensor(False))
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
    if name == "adam":
        assert o1.count() == o2.count() == 30
        with pytest.raises(ValueError, match="constant"):
            optim.adam(p2, lambda t: 1e-3).step_if(grads, torch.tensor(True))


def test_reference_server_checkpoint_loads_into_the_port(
        admitted, ref_poisoned, tmp_path):
    """The reference run's last checkpoint: its generator and student load
    into the port's modules; the port's own server checkpoint has the
    reference's names, with the latent source's state where the
    reference keeps its key; resuming the reference's run is refused."""
    got, _ = admitted
    path = ref_poisoned["ckpt"]
    gen = img_generator_init(nz=16, img_size=8, out_ch=1, device="cpu")
    stu = cnn_init(T_SPEC, device="cpu")
    load_server_models(path, gen, stu)
    with np.load(path + ".npz") as f:
        want = {k: f[k] for k in f.files}
    assert int(want["epoch"]) == 3
    for prefix, tree in (("gen_p", interop.generator_to_ref(gen)),
                         ("stu_p", interop.cnn_to_ref(stu))):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert len(flat) == sum(k.startswith(prefix + "/") for k in want)
        for keys, leaf in flat:
            key = "/".join([prefix] + [f"[{p.idx}]" if hasattr(p, "idx")
                                       else str(p.key) for p in keys])
            np.testing.assert_allclose(leaf, want[key], rtol=0, atol=1e-6)
    scfg, _ = _scfgs(epochs=1, checkpoint_every=1,
                     checkpoint_path=str(tmp_path / "ours"))
    train_dense_server(got, scfg, device="cpu")
    ours = set(np.load(tmp_path / "ours.npz").files)
    assert ours - {"rng"} == set(want) - {"key"}
    with pytest.raises(ValueError, match="JAX reference"):
        train_dense_server(got, dataclasses.replace(scfg,
                                                    checkpoint_path=path),
                           device="cpu")


# ----------------------------------------------------------- multi-round ---

def test_multiround_delay_lands_one_round_stale():
    """A round-0 delay holds client 1's upload back: round 0's server
    ensemble masks it out, round 1's server gets its round-0 model as
    its upload, and every round records one up event a client."""
    scfg, _ = _scfgs(n_clients=3, client_kinds=("cnn1",) * 3, epochs=1,
                     fault_plan=(Fault(client=1, kind="delay", round=0),),
                     quorum=0.4)
    calls, held, led = [], [], CommLedger()
    inner, boundary = T_mr.train_dense_server, T_protocol.apply_upload_faults

    def state(model):
        return {k: v.clone() for k, v in model.net.state_dict().items()}

    def recording(clients, *a, **kw):
        calls.append((clients, [state(c.model) for c in clients]))
        return inner(clients, *a, **kw)

    def holding(clients, *a, **kw):
        out = boundary(clients, *a, **kw)
        held.append(([state(c.model) for c in clients],
                     {i: state(m) for i, m in out[2].items()}))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T_mr, "train_dense_server", recording)
        mp.setattr(T_protocol, "apply_upload_faults", holding)
        model, _, _ = dense_multi_round(scfg, _data(), rounds=2, ledger=led,
                                        device="cpu")
    (r0, _), (r1, s1) = calls
    (trained0, delayed0), (trained1, delayed1) = held
    assert r0.quarantined == {1: "upload never arrived"}
    assert stack_grouped(r0)[0] == ((T_SPEC, 2),)
    assert r1.quarantined == {} and stack_grouped(r1)[0] == ((T_SPEC, 3),)
    assert list(delayed0) == [1] and not delayed1
    for k, v in trained0[1].items():
        assert torch.equal(delayed0[1][k], v)
        assert torch.equal(s1[1][k], v)       # round 0's model, in round 1
    assert not torch.equal(s1[1]["fc.w"], trained1[1]["fc.w"])
    assert torch.equal(s1[0]["fc.w"], trained1[0]["fc.w"])
    kinds = {(e["who"], e["what"]): e["kind"] for e in led.events
             if e["dir"] == "up"}
    assert kinds[("client1", "round0-model-upload")] == "delayed"
    assert kinds[("client1", "round1-model-upload")] == "delivered"
    assert len(kinds) == 6 and led.rounds == 2
    assert all(torch.isfinite(v).all() for v in model.state_dict().values())
