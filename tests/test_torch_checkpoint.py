"""The port's checkpoints (``repro_torch.checkpoint``, the DENSE server's
resume, ``launch/train.py --ckpt``) against the JAX package's files.

Both packages flatten a tree the same way (``/``-joined keys, ``[i]`` for
a list index), so each reads the other's npz files. The server's resume
is held bit for bit against the uninterrupted run, on the CPU, with the
run's own seeded latents (their source's state is in the file) and with
a poisoned epoch under ``nan_policy="skip"``. A reference ``--ckpt`` LM
file loads into the port to 1e-6 (float32 both sides, so exactly), and
the port's ``--ckpt`` file restores in the reference. (A reference
server checkpoint's generator and student: tests/test_torch_faults.py,
from its reference server run.)
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as r_restore
from repro.checkpoint import save_checkpoint as r_save
from repro.configs import paper_cifar as R_cfg
from repro.configs.base import get_smoke_config as r_smoke_config
from repro.launch import steps as R_steps
from repro.launch.train import train as r_lm_train

from repro_torch import interop
from repro_torch.checkpoint import (checkpoint_exists, load_meta, load_tree,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import paper_cifar as T_cfg
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import Client, train_dense_server
from repro_torch.launch.train import train as lm_train
from repro_torch.models import transformer as T_lm
from repro_torch.models.cnn import CNNSpec, cnn_init

FIELDS = dict(
    n_clients=3, alpha=0.5, local_epochs=1, batch_size=16, num_classes=4,
    image_size=8, in_ch=1, train_per_class=37, test_per_class=8,
    client_kinds=("cnn1",) * 3, global_kind="cnn1", width=0.25, nz=16,
    t_g=1, epochs=4, synth_batch=16, loop_mode="python",
    distill_kl_mode="ref")
T_SPEC = CNNSpec(kind="cnn1", num_classes=4, in_ch=1, width=0.25,
                 image_size=8)
LM_ARCH = "llama3.2-3b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size tensors gain nothing from torch's thread pool, and its
    threads and XLA's slow each other down tenfold in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "b": torch.ones(3, dtype=torch.float16),
                       "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)},
            "opt": [{"m": torch.zeros(2, 3), "t": torch.tensor(7,
                                                             dtype=torch.int32)},
                    torch.tensor([1, 2], dtype=torch.int64)],
            "rng": torch.arange(16, dtype=torch.uint8)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ------------------------------------------------------------ round trip ---

def test_roundtrip_nested_tree_and_dtypes(tmp_path):
    """A nested dict and list of tensors comes back in ``like``'s
    structure, dtypes (bfloat16 through its exact float32 widening) and
    values."""
    tree = _tree()
    path = os.path.join(tmp_path, "ck")
    save_checkpoint(path, tree)
    assert checkpoint_exists(path) and checkpoint_exists(path + ".npz")
    like = {"params": {k: torch.zeros_like(v)
                       for k, v in tree["params"].items()},
            "opt": [{"m": torch.ones(2, 3), "t": torch.tensor(0,
                                                            dtype=torch.int32)},
                    torch.zeros(2, dtype=torch.int64)],
            "rng": torch.zeros(16, dtype=torch.uint8)}
    back = restore_checkpoint(path, like)
    assert isinstance(back["opt"], list)
    for a, b in zip(_leaves(back), _leaves(tree), strict=True):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    assert sorted(np.load(path + ".npz").files) == sorted(
        ["params/w", "params/b", "params/h", "opt/[0]/m", "opt/[0]/t",
         "opt/[1]", "rng"])


def test_restore_casts_to_like_dtypes(tmp_path):
    path = os.path.join(tmp_path, "ck")
    save_checkpoint(path, {"w": np.ones((2,), np.float64)})
    back = restore_checkpoint(path, {"w": torch.zeros(2,
                                                      dtype=torch.float16)})
    assert back["w"].dtype == torch.float16
    back = restore_checkpoint(path, {"w": np.zeros(2, np.float32)})
    assert back["w"].dtype == np.float32


def test_meta_json(tmp_path):
    path = os.path.join(tmp_path, "ck")
    save_checkpoint(path, {"w": torch.zeros(2)}, meta={"epoch": 4,
                                                       "note": "x"})
    assert load_meta(path) == {"epoch": 4, "note": "x"}
    assert not checkpoint_exists(os.path.join(tmp_path, "nope"))


def test_mismatched_keys_raise_value_error(tmp_path):
    path = os.path.join(tmp_path, "ck")
    save_checkpoint(path, {"a": torch.zeros(2), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(path, {"a": torch.zeros(2), "c": torch.ones(3)})
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(path, {"a": torch.zeros(2)})


def test_files_cross_between_the_packages(tmp_path):
    """The port's file restores in the reference and the reference's in
    the port, nested lists included."""
    tree = _tree()
    ours = os.path.join(tmp_path, "ours")
    save_checkpoint(ours, tree)
    like = jax.tree.map(lambda t: np.zeros(t.shape, np.float32
                                           if t.dtype == torch.bfloat16
                                           else t.numpy().dtype),
                        tree)
    back = r_restore(ours, like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            jax.tree.map(lambda t: t.float().numpy(), tree)), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    theirs = os.path.join(tmp_path, "theirs")
    r_save(theirs, jax.tree.map(np.asarray, back))
    assert sorted(np.load(theirs + ".npz").files) == \
        sorted(np.load(ours + ".npz").files)
    again = restore_checkpoint(theirs, tree)
    for a, b in zip(_leaves(again), _leaves(tree), strict=True):
        assert torch.equal(a, b)
    assert load_tree(theirs, "opt")[0]["t"] == 7


# ------------------------------------------------- DENSE server resume ---

@pytest.fixture(scope="module")
def clients():
    init = torch.Generator().manual_seed(5)
    return [Client(spec=T_SPEC, model=cnn_init(T_SPEC, generator=init,
                                               device="cpu"), n_data=10)
            for _ in range(3)]


def _state(*models):
    return [v.clone() for m in models for v in m.state_dict().values()]


@pytest.mark.parametrize("policy,poison", [("raise", ()), ("skip", (1,))])
def test_resume_matches_the_uninterrupted_run(tmp_path, clients, policy,
                                              poison):
    """Killed after epoch 3 (its last checkpoint: epoch 2), then resumed:
    the student and generator equal the uninterrupted run's bit for bit,
    the history covers only the resumed epochs."""
    scfg = T_cfg.DenseExperimentConfig(**FIELDS, nan_policy=policy)
    ck = os.path.join(tmp_path, "server")
    scfg_ck = dataclasses.replace(scfg, checkpoint_every=2,
                                  checkpoint_path=ck)
    s_full, g_full, h_full = train_dense_server(clients, scfg, device="cpu",
                                                _poison_epochs=poison)
    train_dense_server(clients, scfg_ck, device="cpu", _poison_epochs=poison,
                       _stop_after_epoch=3)
    assert load_meta(ck) == {"epoch": 2, "epochs": 4}
    s_res, g_res, hist = train_dense_server(clients, scfg_ck, device="cpu",
                                            _poison_epochs=poison)
    assert len(hist.dis_loss) == 2
    np.testing.assert_array_equal(hist.gen_loss, h_full.gen_loss[2:])
    for a, b in zip(_state(s_res, g_res), _state(s_full, g_full),
                    strict=True):
        assert torch.equal(a, b)
    assert load_meta(ck)["epoch"] == 4


def test_no_checkpoint_path_writes_nothing(tmp_path, clients, monkeypatch):
    """checkpoint_every without checkpoint_path saves and reads nothing."""
    monkeypatch.chdir(tmp_path)
    scfg = T_cfg.DenseExperimentConfig(**{**FIELDS, "epochs": 1},
                                       checkpoint_every=1)
    train_dense_server(clients, scfg, device="cpu")
    assert not os.listdir(tmp_path)


# ------------------------------------------------------ LM --ckpt files ---

def test_lm_ckpt_files_cross_between_the_packages(tmp_path):
    """The reference's ``--ckpt`` file restores into the port's parameter
    tree, and the port's into the reference's, with the same meta."""
    theirs = os.path.join(tmp_path, "theirs")
    r_state, r_losses = r_lm_train(LM_ARCH, steps=1, batch=2, seq=16,
                                   smoke=True, ckpt=theirs, log_every=100)
    cfg = get_smoke_config(LM_ARCH)
    like = T_lm.init_model(cfg, device="cpu")
    got = restore_checkpoint(theirs, like)
    want = interop.lm_params_from_reference(
        jax.tree.map(np.asarray, r_state["params"]), cfg, device="cpu")
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)

    ours = os.path.join(tmp_path, "ours")
    state, hist = lm_train(LM_ARCH, steps=2, batch=2, seq=16, smoke=True,
                           ckpt=ours, log_every=100, device="cpu")
    assert load_meta(ours) == {"arch": LM_ARCH, "steps": 2,
                               "final_loss": hist[-1]["loss"]}
    assert set(load_meta(theirs)) == set(load_meta(ours))
    r_like = R_steps.make_train_state(jax.random.PRNGKey(0),
                                      r_smoke_config(LM_ARCH))["params"]
    back = r_restore(ours, r_like)
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(interop.lm_params_to_reference(
                        state["params"])), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
