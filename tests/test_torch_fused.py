"""The fused epoch driver (``loop_mode="fused"``) on the CPU: the port's
against the JAX package's, and against the port's own python driver.

A federation of 3 cnn1 clients at width 0.25 on 8x8 images is trained by
the reference's grouped engine and carried across
(``repro_torch.interop``); both servers start from the reference's
generator and student inits. What is held:

  * ``_chunk_bounds``: the reference's, exactly, over a sweep of
    (epochs, chunk, eval_every, ckpt_every, start);
  * the port's fused driver (eager chunks on the CPU) against the
    reference's fused driver (one ``lax.scan`` a chunk), 4 epochs in
    chunks of 3 with an eval every 2 (so chunks [0, 2) and [2, 4)), the
    reference's per-epoch draws injected through ``noise``, free-running
    at g_lr = 1e-5 as tests/test_torch_round.py runs it: the losses to
    1e-3, the student to 1e-4, the evals after epochs 2 and 4;
  * fused against python in the port, bit for bit: the student, the
    generator, Adam's state and every loss;
  * ``nan_policy="rollback"`` at chunk granularity, ``"raise"`` naming
    the chunk, and a resumed run at a chunk boundary, bit for bit;
  * Adam's device-count step against its host-count step, bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_cifar as R_cfg
from repro.core import generator as R_gen
from repro.core.dense import _chunk_bounds as r_chunk_bounds
from repro.core.dense import train_dense_server as r_train
from repro.data import make_classification_data as r_make_data
from repro.fl import build_federation as r_build
from repro.models import cnn as R_cnn

from repro_torch import interop, optim
from repro_torch.configs import paper_cifar as T_cfg
from repro_torch.core import Client, train_dense_server
from repro_torch.core.dense import _chunk_bounds
from repro_torch.models.cnn import CNNSpec

STEP_TOL = 1e-4
END_TOL = 1e-3
FIELDS = dict(
    n_clients=3, alpha=0.5, local_epochs=1, batch_size=32, num_classes=4,
    image_size=8, in_ch=3, train_per_class=24, test_per_class=8,
    client_kinds=("cnn1",) * 3, global_kind="cnn1", width=0.25, nz=16,
    t_g=2, epochs=4, synth_batch=16, loop_mode="fused", loop_chunk=3,
    distill_kl_mode="ref", g_lr=1e-5)
R_SPEC = R_cnn.CNNSpec(kind="cnn1", num_classes=4, in_ch=3, width=0.25,
                       image_size=8)
T_SPEC = CNNSpec(kind="cnn1", num_classes=4, in_ch=3, width=0.25,
                 image_size=8)
EVAL_EVERY = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: smoke tensors gain nothing from the pool, and
    its threads and XLA's slow each other in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data():
    return r_make_data(0, num_classes=4, size=8, ch=3, train_per_class=24,
                       test_per_class=8)


def _probe():
    """Fixed images the evals read the student's logits on."""
    return np.random.default_rng(5).standard_normal(
        (8, 8, 8, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def ref_run():
    scfg = R_cfg.DenseExperimentConfig(**FIELDS)
    clients, _ = r_build(jax.random.PRNGKey(0), scfg, _data())
    skey = jax.random.PRNGKey(1)
    k_gen, k_stu, key = jax.random.split(skey, 3)
    noise = []
    for ek in jax.random.split(key, scfg.epochs):
        kz, ky, _ = jax.random.split(ek, 3)
        noise.append((np.asarray(jax.random.normal(
            kz, (scfg.synth_batch, scfg.nz))),
            np.asarray(jax.random.randint(ky, (scfg.synth_batch,), 0,
                                          scfg.num_classes))))
    x = _probe()
    logits_fn = jax.jit(R_cnn.cnn_logits, static_argnums=1)
    stu, _, hist = r_train(
        skey, clients, scfg, eval_every=EVAL_EVERY,
        eval_fn=lambda p, spec: np.asarray(logits_fn(p, spec, x)))
    return dict(
        clients=[_np(c.params) for c in clients],
        gen0=_np(R_gen.img_generator_init(k_gen, nz=scfg.nz,
                                          img_size=scfg.image_size,
                                          out_ch=scfg.in_ch)),
        stu0=_np(R_cnn.cnn_init(k_stu, R_SPEC)), noise=noise,
        student=_np(stu), hist=hist)


def _tscfg(**kw):
    return T_cfg.DenseExperimentConfig(**{**FIELDS, **kw})


def _clients(ref):
    return [Client(spec=T_SPEC, model=interop.cnn_from_ref(p, T_SPEC,
                                                           device="cpu"))
            for p in ref["clients"]]


def _models(ref, scfg):
    gen = interop.generator_from_ref(ref["gen0"], nz=scfg.nz,
                                     img_size=scfg.image_size,
                                     out_ch=scfg.in_ch, device="cpu")
    return gen, interop.cnn_from_ref(ref["stu0"], T_SPEC, device="cpu")


def _ref_noise(ref, scfg):
    return [(torch.tensor(z), torch.tensor(y).long(),
             torch.zeros((0, scfg.synth_batch, scfg.nz)))
            for z, y in ref["noise"]]


def _run(ref, scfg, **kw):
    gen, stu = _models(ref, scfg)
    return train_dense_server(_clients(ref), scfg, device="cpu", gen=gen,
                              student=stu, **kw)


def _state(student, gen) -> list:
    return [v.clone() for m in (student, gen)
            for v in m.state_dict().values()]


def _assert_same(a: list, b: list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("epochs,chunk,eval_every,ckpt_every,start", [
    (10, 8, 0, 0, 0), (10, 3, 0, 0, 0), (10, 3, 4, 0, 0), (10, 8, 3, 4, 0),
    (10, 4, 0, 3, 6), (7, 1, 2, 0, 0), (200, 8, 10, 25, 50), (5, 8, 0, 0, 5),
    (9, 4, 6, 4, 1), (3, 100, 0, 0, 0)])
def test_chunk_bounds_are_the_references(epochs, chunk, eval_every,
                                         ckpt_every, start):
    assert _chunk_bounds(epochs, chunk, eval_every, ckpt_every, start) == \
        r_chunk_bounds(epochs, chunk, eval_every, ckpt_every, start)


def test_fused_driver_matches_the_references(ref_run):
    scfg = _tscfg()
    x = torch.from_numpy(_probe())
    stu, _, hist = _run(ref_run, scfg, noise=_ref_noise(ref_run, scfg)
                        .__getitem__, eval_every=EVAL_EVERY,
                        eval_fn=lambda m, spec: m(x, train=False)[0]
                        .detach().numpy())
    want = ref_run["hist"]
    assert hist.loop == "fused" and hist.host_reads == 2
    np.testing.assert_allclose(hist.gen_loss, want.gen_loss, rtol=END_TOL,
                               atol=END_TOL)
    np.testing.assert_allclose(hist.dis_loss, want.dis_loss, rtol=END_TOL,
                               atol=END_TOL)
    for g, w in zip(hist.gen_parts, want.gen_parts, strict=True):
        for part in ("ce", "bn", "div"):
            np.testing.assert_allclose(g[part], float(w[part]),
                                       rtol=END_TOL, atol=END_TOL)
    assert [e for e, _ in hist.acc] == [e for e, _ in want.acc] == [2, 4]
    for (_, a), (_, b) in zip(hist.acc, want.acc):
        np.testing.assert_allclose(a, b, rtol=END_TOL, atol=END_TOL)
    for a, b in zip(jax.tree.leaves(interop.cnn_to_ref(stu)),
                    jax.tree.leaves(ref_run["student"]), strict=True):
        np.testing.assert_allclose(a, b, rtol=STEP_TOL, atol=STEP_TOL)


@pytest.mark.parametrize("policy", ["raise", "skip"])
def test_fused_equals_python_bit_for_bit(ref_run, policy):
    """The same epochs, chunked or not: the same student, generator,
    Adam state and losses, bit for bit (the default latent source)."""
    out = {}
    for loop in ("python", "fused"):
        scfg = _tscfg(loop_mode=loop, epochs=5, loop_chunk=2,
                      nan_policy=policy)
        gen, stu = _models(ref_run, scfg)
        stu, gen, hist = train_dense_server(_clients(ref_run), scfg,
                                            device="cpu", gen=gen,
                                            student=stu)
        out[loop] = (_state(stu, gen), hist)
    _assert_same(out["python"][0], out["fused"][0])
    for field in ("gen_loss", "gen_parts", "dis_loss"):
        assert getattr(out["python"][1], field) == \
            getattr(out["fused"][1], field)
    assert out["fused"][1].host_reads == 3          # chunks of 2, 2 and 1
    assert out["python"][1].host_reads == 5


def test_rollback_undoes_the_whole_chunk(ref_run):
    """Epoch 1 poisoned in chunk [0, 2): the chunk is undone whole (the
    state is the pre-chunk one bit for bit), the history keeps both its
    epochs, and the run goes on from it: the state after 4 epochs is
    that of a fresh run over epochs 2 and 3's draws."""
    scfg = _tscfg(loop_chunk=2, nan_policy="rollback")
    noise = _ref_noise(ref_run, scfg)
    gen0, stu0 = _models(ref_run, scfg)
    stu, gen, hist = _run(ref_run, dataclasses.replace(scfg, epochs=2),
                          noise=noise.__getitem__, _poison_epochs=(1,))
    _assert_same(_state(stu, gen), _state(stu0, gen0))
    assert np.isfinite(hist.gen_loss[0]) and not np.isfinite(
        hist.gen_loss[1])
    stu, gen, hist = _run(ref_run, scfg, noise=noise.__getitem__,
                          _poison_epochs=(1,))
    assert len(hist.gen_loss) == 4 and hist.host_reads == 2
    assert np.all(np.isfinite(np.array(hist.gen_loss)[[0, 2, 3]]))
    stu2, gen2, hist2 = _run(ref_run, dataclasses.replace(scfg, epochs=2),
                             noise=lambda e: noise[e + 2])
    _assert_same(_state(stu, gen), _state(stu2, gen2))
    assert hist.gen_loss[2:] == hist2.gen_loss


def test_skip_under_the_fused_driver(ref_run):
    """A poisoned epoch's steps change nothing under ``skip``: a 3-epoch
    run with epoch 1 poisoned ends where a run over epochs 0 and 2's
    draws ends, bit for bit."""
    scfg = _tscfg(epochs=3, loop_chunk=2, nan_policy="skip")
    noise = _ref_noise(ref_run, scfg)
    stu, gen, hist = _run(ref_run, scfg, noise=noise.__getitem__,
                          _poison_epochs=(1,))
    assert not np.isfinite(hist.gen_loss[1])
    stu2, gen2, _ = _run(ref_run, dataclasses.replace(scfg, epochs=2),
                         noise=lambda e: noise[2 * e])
    _assert_same(_state(stu, gen), _state(stu2, gen2))


def test_raise_names_the_chunk(ref_run):
    scfg = _tscfg(loop_chunk=2)
    with pytest.raises(FloatingPointError, match=r"epochs \[2, 4\)"):
        _run(ref_run, scfg, noise=_ref_noise(ref_run, scfg).__getitem__,
             _poison_epochs=(3,))


def test_resume_at_a_chunk_boundary(ref_run, tmp_path):
    """Checkpoints every 2 epochs in chunks of 3 (bounds [0, 2), [2, 4),
    [4, 5)): a run killed after epoch 4 resumes from its epoch-2
    checkpoint and ends where the uninterrupted run ends, bit for bit."""
    def scfg(name):
        return _tscfg(epochs=5, loop_chunk=3, checkpoint_every=2,
                      checkpoint_path=str(tmp_path / name))

    stu, gen, _ = _run(ref_run, scfg("whole"))
    _, _, killed = _run(ref_run, scfg("killed"), _stop_after_epoch=4)
    assert len(killed.gen_loss) == 4
    stu2, gen2, resumed = _run(ref_run, scfg("killed"))
    assert len(resumed.gen_loss) == 3 and resumed.host_reads == 2
    _assert_same(_state(stu, gen), _state(stu2, gen2))


def test_adam_device_count_step_is_step():
    """The step on the device count (the fused driver's, and step_if's)
    is the host-count step, bit for bit; the count moves with it, and
    set_count restores it in place."""
    g = torch.Generator().manual_seed(0)
    p_host = [torch.randn(7, 5, generator=g), torch.randn(3, generator=g)]
    p_dev = [p.clone() for p in p_host]
    host = optim.adam(p_host, 1e-3, weight_decay=1e-4)
    dev = optim.adam(p_dev, 1e-3, weight_decay=1e-4)
    t_dev = dev.count_on_device()
    for _ in range(4):
        grads = [torch.randn(p.shape, generator=g) for p in p_host]
        host.step(grads)
        dev.step(grads)
    for a, b in zip(host.params + host.m + host.v,
                    dev.params + dev.m + dev.v):
        assert torch.equal(a, b)
    assert host.count() == dev.count() == 4 and dev.t_dev is t_dev
    dev.set_count(2)
    assert dev.t_dev is t_dev and float(t_dev) == 2.0
    with pytest.raises(ValueError, match="schedule"):
        optim.adam([torch.zeros(2)], lambda t: 1e-3).count_on_device()
