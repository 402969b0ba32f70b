"""The pod distillation cell (``make_pod_distill_step``, both loss routes)
and ``forward(..., return_hidden=True)`` against the JAX package's, at
smoke sizes on the CPU.

Two llama3.2-3b smoke clients stacked on a leading dim and a smoke
student (float32, vocab 256, 2 layers), drawn by the port's
``init_model`` and carried across with ``interop``; the soft embeddings
come from a numpy seed. The reference's step runs on a one-device mesh
(``repro.launch.mesh.make_host_mesh``) with its own Adam, and once more
with a stand-in optimizer that hands back the gradient it computed.
What is held:

  * ``forward(return_hidden=True)``: the final norm's output, 1e-5, for
    a dense and an ssm trunk; the logits are its readout;
  * one step of each route: the loss at 1e-5 relative, the student's
    gradient at 1e-5 of each tensor's largest entry, and the Adam update
    as ``tests/test_torch_steps.py`` holds a single step: Adam's first
    step moves a weight by ±lr whatever its gradient's size, so the new
    weights are held to 1e-4 of lr (and two float32 ulps) where the
    reference's gradient stands clear of float32 noise (above 1e-4 of
    its tensor's largest entry);
  * the chunked route's loss equals the materialized route's at 1e-5,
    and ``launch.steps.make_distill_step`` is the same step;
  * a ``kl_chunk`` that does not divide the sequence, and "autodiff",
    are refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as R_base
from repro.core import dense_llm as R_DL
from repro.launch.mesh import make_host_mesh as r_host_mesh
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.configs import base as T_base
from repro_torch.core import dense_llm as T_DL
from repro_torch.launch import steps as T_steps
from repro_torch.models import transformer as T_T

TOL = 1e-5
STEP_TOL = 1e-4         # tests/test_torch_steps.py's
VOCAB, LAYERS, N_CLIENTS = 256, 2, 2
BATCH, SEQ, KL_CHUNK = 2, 32, 8
S_LR = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(base, arch="llama3.2-3b"):
    return base.get_smoke_config(arch).replace(
        vocab_size=VOCAB, n_layers=LAYERS, dtype="float32",
        param_dtype="float32")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _close_rel(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)),
                                                    1e-30)


class _GradOut:
    """Stands in for the reference's Adam inside its step: ``update``
    returns the gradient in place of the new parameters."""

    def __init__(self, lr):
        pass

    def init(self, params):
        return ()

    def update(self, grads, state, params, step=None):
        return grads, state


@pytest.fixture(scope="module")
def world():
    tc = _cfg(T_base)
    clients = [interop.lm_params_to_reference(
        T_T.init_model(tc, seed=i, device="cpu")) for i in range(N_CLIENTS)]
    student = interop.lm_params_to_reference(
        T_T.init_model(tc, seed=9, device="cpu"))
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *clients)
    embeds = np.random.default_rng(3).standard_normal(
        (BATCH, SEQ, tc.d_model)).astype(np.float32)
    return dict(stacked=stacked, student=student, embeds=embeds)


def _ref_step(world, chunked, opt=None):
    rc = _cfg(R_base)
    mesh = r_host_mesh()
    kw = dict(n_clients=N_CLIENTS, s_lr=S_LR, chunked_kl=chunked,
              kl_chunk=KL_CHUNK, distill_kl_mode="ref",
              kernel_vjp_mode="ref")
    if opt is not None:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(R_DL.optim, "adam", opt)
            step = R_DL.make_pod_distill_step(rc, mesh, **kw)
    else:
        step = R_DL.make_pod_distill_step(rc, mesh, **kw)
    from repro import optim as R_optim
    p = _j(world["student"])
    state = {"params": p, "opt": () if opt is not None
             else R_optim.adam(S_LR).init(p), "step": jnp.zeros((), jnp.int32)}
    new, out = jax.jit(step)(state, _j(world["stacked"]),
                             jnp.asarray(world["embeds"]))
    return _np(new["params"]), float(out["dis_loss"])


@pytest.fixture(scope="module", params=["materialized", "chunked"])
def ref_route(request, world):
    chunked = request.param == "chunked"
    grads, loss = _ref_step(world, chunked, opt=_GradOut)
    new, loss2 = _ref_step(world, chunked)
    assert loss == loss2
    return dict(chunked=chunked, grads=grads, new=new, loss=loss)


def _port_state(world, step):
    tc = _cfg(T_base)
    params = interop.lm_params_from_reference(world["student"], tc,
                                              device="cpu")
    return step.make_state(params)


def _port_stacked(world):
    return interop.tree_from_reference(world["stacked"], device="cpu")


class _Capture:
    """Stands in for the port's Adam: keeps the gradients it is given."""

    def __init__(self, params):
        self.params = list(params)

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]


def _port_step(world, chunked, make=T_DL.make_pod_distill_step):
    step = make(_cfg(T_base), None, n_clients=N_CLIENTS, s_lr=S_LR,
                chunked_kl=chunked, kl_chunk=KL_CHUNK, device="cpu")
    state = _port_state(world, step)
    return step, state


def test_pod_distill_step_matches_reference(world, ref_route):
    chunked = ref_route["chunked"]
    step, state = _port_step(world, chunked)
    old = {k: v.detach().clone() for k, v in _flat(state["params"])}
    cap = _Capture(state["opt"].params)
    real = state["opt"]
    state["opt"] = cap
    _, out = step(state, _port_stacked(world), torch.from_numpy(
        world["embeds"]))
    np.testing.assert_allclose(float(out["dis_loss"]), ref_route["loss"],
                               rtol=TOL, atol=0)
    names = [k for k, _ in _flat(state["params"])]
    grads = dict(zip(names, cap.grads))
    want = dict(_flat(ref_route["grads"]))
    assert set(grads) == set(want)
    for k in names:
        _close_rel(grads[k].numpy(), want[k])
    # the real Adam step from the same state
    state["opt"] = real
    with torch.no_grad():
        for (k, v) in _flat(state["params"]):
            v.copy_(old[k])
    step(state, _port_stacked(world), torch.from_numpy(world["embeds"]))
    assert state["step"] == 2
    new_ref = dict(_flat(ref_route["new"]))
    for k, v in _flat(state["params"]):
        g = np.abs(want[k])
        clear = g > 1e-4 * g.max()
        np.testing.assert_allclose(v.detach().numpy()[clear],
                                   new_ref[k][clear], rtol=2 * 2.0 ** -23,
                                   atol=STEP_TOL * S_LR)


def test_chunked_loss_equals_materialized_and_steps_route_it(world):
    losses = {}
    for chunked, make in ((False, T_DL.make_pod_distill_step),
                          (True, T_DL.make_pod_distill_step),
                          (True, T_steps.make_distill_step)):
        step, state = _port_step(world, chunked, make)
        _, out = step(state, _port_stacked(world),
                      torch.from_numpy(world["embeds"]))
        losses.setdefault(chunked, []).append(float(out["dis_loss"]))
    np.testing.assert_allclose(losses[True][0], losses[False][0], rtol=TOL)
    assert losses[True][0] == losses[True][1]


def test_pod_step_refusals(world):
    step, state = _port_step(world, True)
    with pytest.raises(ValueError, match="kl_chunk"):
        step(state, _port_stacked(world),
             torch.from_numpy(world["embeds"][:, :SEQ - 4]))
    with pytest.raises(ValueError, match="autodiff"):
        T_DL.make_pod_distill_step(_cfg(T_base), None, n_clients=2,
                                   kernel_vjp_mode="autodiff", device="cpu")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-130m"])
def test_forward_return_hidden_matches_reference(arch):
    tc, rc = _cfg(T_base, arch), _cfg(R_base, arch)
    params = T_T.init_model(tc, seed=4, device="cpu")
    rp = _j(interop.lm_params_to_reference(params))
    toks = np.random.default_rng(5).integers(0, VOCAB, (BATCH, SEQ))
    want, _, _ = jax.jit(lambda p, t: R_T.forward(
        p, rc, tokens=t, return_hidden=True))(rp, jnp.asarray(toks))
    got, _ = T_T.forward(params, tc, tokens=torch.from_numpy(toks),
                         return_hidden=True)
    assert tuple(got.shape) == (BATCH, SEQ, tc.d_model)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    logits, _ = T_T.forward(params, tc, tokens=torch.from_numpy(toks))
    torch.testing.assert_close(logits, got @ params["embed"]["table"].T,
                               rtol=0, atol=0)
