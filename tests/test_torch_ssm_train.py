"""The LM train step (``launch/steps.make_train_step``) of the ssm
(mamba2) and hybrid (zamba2, 3 mamba blocks) families against the JAX
package's, at smoke widths in float32: two steps from the same weights
on the same batches, with remat, on the port's plain route
(``ssd_chunked``, ``_sdpa``) and its kernel route (``SSDScan`` and
``FlashAttention``, whose CPU wrappers run their plain pairs): loss,
grad_norm and every clipped gradient. Each port step starts from the
reference's parameters of that step, so the comparison holds the step
and not Adam's amplification of float32 noise (ROADMAP.md Queue 3).
Tolerance 1e-4, gradients relative to each tensor's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as R_data
from repro import optim as R_optim
from repro.configs import base as R_base
from repro.launch import steps as R_ST
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.configs import base as T_base
from repro_torch.launch import steps as T_ST
from repro_torch.models import transformer as T_T

TOL = 1e-4
SEQ = 32
ARCHS = ("mamba2-130m", "zamba2-7b")
# zamba2 at 3 mamba blocks: one super-block with the shared block and one
# tail block, every part of the hybrid at less compile time
DEPTH = {"zamba2-7b": 3}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _close_rel(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= tol * scale


class _Recorder:
    """Adam that also keeps the (clipped) gradients of its last step."""

    def __init__(self, opt):
        self.opt, self.params = opt, opt.params

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]
        self.opt.step(grads)


@pytest.fixture(scope="module", params=ARCHS)
def ref_steps(request):
    """The reference's two train steps: per step its batch, parameters
    before the step, loss, grad_norm and clipped gradients."""
    arch = request.param
    rc = R_base.get_smoke_config(arch)
    rc = rc.replace(remat=True, n_layers=DEPTH.get(arch, rc.n_layers))
    rp = _np(R_T.init_model(jax.random.PRNGKey(7), rc))
    lr = 3e-3
    rstate = {"params": _j(rp), "opt": R_optim.adam(lr).init(_j(rp)),
              "step": jnp.zeros((), jnp.int32)}
    rstep = jax.jit(R_ST.make_train_step(rc, None, lr=lr, clip=1.0))
    clipped = jax.jit(lambda p, b: R_optim.clip_by_global_norm(
        jax.grad(lambda q: R_T.loss_fn(q, rc, b)[0])(p), 1.0)[0])
    toks = R_data.make_lm_data(1, vocab=rc.vocab_size, n_tokens=4000)
    steps = []
    for x, y in R_data.lm_batches(toks, 2, SEQ, seed=1, steps=2):
        rb = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
        before = _np(rstate["params"])
        grads = _np(clipped(rstate["params"], rb))
        rstate, rm = rstep(rstate, rb)
        steps.append((x, y, before, float(rm["loss"]),
                      float(rm["grad_norm"]), grads))
    return arch, rp, lr, steps


@pytest.mark.parametrize("mode", ["ref", "fused"])
def test_train_step_matches_reference(ref_steps, mode):
    """Two steps from the same weights on the same batches (each port
    step from the reference's parameters of that step), with remat."""
    arch, rp, lr, steps = ref_steps
    tc = T_base.get_smoke_config(arch)
    tc = tc.replace(remat=True, kernel_vjp_mode=mode,
                    n_layers=DEPTH.get(arch, tc.n_layers))
    tstate = T_ST.make_train_state(
        tc, lr=lr, params=interop.lm_params_from_reference(rp, tc,
                                                           device="cpu"),
        device="cpu")
    tstate["opt"] = _Recorder(tstate["opt"])
    tstep = T_ST.make_train_step(tc, clip=1.0)
    for x, y, before, loss, gnorm, grads in steps:
        with torch.no_grad():
            for t, r in zip(T_T.leaves(tstate["params"]), T_T.leaves(
                    interop.tree_from_reference(before, device="cpu"))):
                t.copy_(r)
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(x),
                                    "labels": torch.from_numpy(y)})
        _close(tm["loss"], loss)
        _close(tm["grad_norm"], gnorm)
        assert gnorm > 1.0                       # the clip is active
        for g, w in zip(tstate["opt"].grads, T_T.leaves(
                interop.tree_from_reference(grads, device="cpu"))):
            _close_rel(g, w.numpy())
    assert tstate["step"] == 2
