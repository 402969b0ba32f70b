"""LDAM local training (paper Table 4, DENSE+LDAM) in the port against
the JAX package: one LDAM LocalUpdate step from the same state (loss and
update, 1e-5 relative: s = 30 scales the logit differences), and a
whole ``build_federation(use_ldam=True)`` on the per-client engine from
the reference's client inits (the trained clients, their class counts
and the ledger; 1e-4, as tests/test_torch_round.py holds CE training).
Then one DENSE epoch on the LDAM clients runs on the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R_optim
from repro.configs import paper_cifar as R_cfg
from repro.data import make_classification_data as r_make_data
from repro.fl import CommLedger as RLedger
from repro.fl import build_federation as r_build
from repro.fl.client import make_local_step as r_make_local_step
from repro.models import cnn as R_cnn

from repro_torch import interop, optim
from repro_torch.configs import paper_cifar as T_cfg
from repro_torch.core import train_dense_server
from repro_torch.data import make_classification_data
from repro_torch.fl import CommLedger, build_federation, make_local_step
from repro_torch.models.cnn import CNNSpec

LDAM_TOL = 1e-5
STEP_TOL = 1e-4
FIELDS = dict(
    n_clients=3, alpha=0.3, local_epochs=2, batch_size=32, num_classes=4,
    image_size=8, in_ch=3, train_per_class=24, test_per_class=8,
    client_kinds=("cnn1",) * 3, global_kind="cnn1", width=0.25, nz=16,
    t_g=1, epochs=1, synth_batch=16, client_loop_mode="python",
    loop_mode="python", use_ldam=True)
R_SPEC = R_cnn.CNNSpec(kind="cnn1", num_classes=4, in_ch=3, width=0.25,
                       image_size=8)
T_SPEC = CNNSpec(kind="cnn1", num_classes=4, in_ch=3, width=0.25,
                 image_size=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data(make):
    return make(2, num_classes=4, size=8, ch=3, train_per_class=24,
                test_per_class=8)


def _assert_model(model, tree, tol):
    for a, b in zip(jax.tree.leaves(interop.cnn_to_ref(model)),
                    jax.tree.leaves(_np(tree)), strict=True):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def test_ldam_local_step_matches():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (32, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, 32).astype(np.int32)
    counts = np.asarray([30, 1, 6, 0])
    p0 = R_cnn.cnn_init(jax.random.PRNGKey(1), R_SPEC)
    step, opt = r_make_local_step(R_SPEC, lr=0.01, momentum=0.9,
                                  use_ldam=True)
    p1, s1, loss = step(p0, opt.init(p0), jnp.asarray(x), jnp.asarray(y),
                        R_optim.class_margins(jnp.asarray(counts)))
    model = interop.cnn_from_ref(_np(p0), T_SPEC, device="cpu")
    t_step, _ = make_local_step(model, lr=0.01, momentum=0.9, use_ldam=True,
                                margins=optim.class_margins(counts))
    got = t_step(torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(float(got), float(loss), rtol=LDAM_TOL)
    _assert_model(model, p1, LDAM_TOL)


def test_ldam_needs_margins():
    model = interop.cnn_from_ref(
        _np(R_cnn.cnn_init(jax.random.PRNGKey(1), R_SPEC)), T_SPEC,
        device="cpu")
    with pytest.raises(ValueError, match="margins"):
        make_local_step(model, lr=0.01, momentum=0.9, use_ldam=True)


@pytest.fixture(scope="module")
def federations():
    key = jax.random.PRNGKey(4)
    r_scfg = R_cfg.DenseExperimentConfig(**FIELDS)
    inits = [_np(R_cnn.cnn_init(k, R_SPEC))
             for k in jax.random.split(key, r_scfg.n_clients)]
    r_ledger = RLedger()
    r_clients, _ = r_build(key, r_scfg, _data(r_make_data), ledger=r_ledger)
    scfg = T_cfg.DenseExperimentConfig(**FIELDS)
    ledger = CommLedger()
    clients, _ = build_federation(
        scfg, _data(make_classification_data), device="cpu", ledger=ledger,
        init_models=[interop.cnn_from_ref(p, T_SPEC, device="cpu")
                     for p in inits])
    return scfg, clients, ledger, r_clients, r_ledger


def test_ldam_federation_matches(federations):
    _, clients, ledger, r_clients, r_ledger = federations
    assert ledger.uplink_bytes == r_ledger.uplink_bytes
    assert ledger.rounds == 1 and ledger.downlink_bytes == 0
    for c, rc in zip(clients, r_clients, strict=True):
        assert c.n_data == rc.n_data
        np.testing.assert_array_equal(c.class_counts, rc.class_counts)
        _assert_model(c.model, rc.params, STEP_TOL)
    # the split is imbalanced: each client trains at its own margins
    assert len({tuple(optim.class_margins(c.class_counts).tolist())
                for c in clients}) == len(clients)


def test_dense_runs_on_the_ldam_federation(federations):
    scfg, clients, _, _, _ = federations
    _, _, hist = train_dense_server(
        clients, dataclasses.replace(scfg, epochs=2), device="cpu")
    assert len(hist.dis_loss) == 2
    assert np.all(np.isfinite(hist.gen_loss + hist.dis_loss))
