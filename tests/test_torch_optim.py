"""The port's optimizer extras against ``repro.optim``: the learning-rate
schedules, a schedule as the lr of SGD and Adam (SGD evaluates it at the
step its caller passes, Adam at its own count from 1), weight decay
added to the gradient before momentum, and the LDAM margins and loss,
with and without a sample mask, with their gradients.

The same numpy inputs, from a seed, go through both. Tolerance 1e-6 for
the schedules (float64 on the host against float32 in JAX), 1e-5
relative for the LDAM loss and its gradient (s = 30 scales the logits,
so float32 noise in the softmax shows at a few 1e-7) and 1e-6 for the
optimizer steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R

from repro_torch import optim as T

TOL = 1e-6
LDAM_TOL = 1e-5


@pytest.mark.parametrize("name,args", [
    ("constant", (0.1,)),
    ("cosine", (0.1, 50)),
    ("cosine", (0.1, 50, 0.2)),
    ("warmup_cosine", (0.1, 5, 50)),
    ("warmup_cosine", (0.1, 0, 40, 0.1)),
])
def test_schedules_match(name, args):
    want, got = getattr(R, name)(*args), getattr(T, name)(*args)
    for step in (0, 1, 3, 4, 5, 6, 25, 49, 50, 60):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))),
                                   rtol=TOL, atol=TOL)


def _params(rng):
    return [rng.standard_normal((3, 4)).astype(np.float32),
            rng.standard_normal((5,)).astype(np.float32)]


def _run(opt_ref, opt_port, steps, *, pass_step):
    """Both optimizers over the same gradient sequence; SGD's caller
    passes the step index when ``pass_step``."""
    rng = np.random.default_rng(0)
    p_ref = [jnp.asarray(p) for p in _params(rng)]
    p_port = [torch.tensor(np.asarray(p)) for p in p_ref]
    opt_port = opt_port(p_port)
    state = opt_ref.init(p_ref)
    for k in range(steps):
        g = [rng.standard_normal(p.shape).astype(np.float32) for p in p_ref]
        kw = {"step": k} if pass_step else {}
        p_ref, state = opt_ref.update([jnp.asarray(a) for a in g], state,
                                      p_ref, **kw)
        opt_port.step([torch.tensor(a) for a in g], **kw)
        for a, b in zip(p_port, p_ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("pass_step", [False, True])
def test_sgd_schedule_and_weight_decay_match(momentum, pass_step):
    lr = R.cosine(0.1, 4)
    _run(R.sgd(lr, momentum=momentum, weight_decay=0.05),
         lambda ps: T.sgd(ps, T.cosine(0.1, 4), momentum=momentum,
                          weight_decay=0.05), 5, pass_step=pass_step)


def test_adam_schedule_and_weight_decay_match():
    """Adam evaluates the schedule at t = 1, 2, ...: at warm-up 3 its
    first step takes a third of lr, not 0."""
    _run(R.adam(R.warmup_cosine(1e-2, 3, 10), weight_decay=0.01),
         lambda ps: T.adam(ps, T.warmup_cosine(1e-2, 3, 10),
                           weight_decay=0.01), 6, pass_step=False)


def test_float_lr_without_weight_decay_is_unchanged():
    """A float lr and no decay take the path the rest of the port uses."""
    _run(R.sgd(0.05, momentum=0.9),
         lambda ps: T.sgd(ps, 0.05, momentum=0.9), 3, pass_step=False)
    _run(R.adam(1e-3), lambda ps: T.adam(ps, 1e-3), 3, pass_step=False)


@pytest.mark.parametrize("counts", [
    [50, 3, 0, 7, 120, 1], [10, 10, 10, 10, 10, 10], [0, 0, 0, 0, 0, 9]])
@pytest.mark.parametrize("max_margin", [0.5, 1.0])
def test_class_margins_match(counts, max_margin):
    c = np.asarray(counts, np.int64)
    want = np.asarray(R.class_margins(jnp.asarray(c), max_margin))
    for arg in (c, torch.tensor(c)):
        got = T.class_margins(arg, max_margin)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)
    assert float(T.class_margins(c, max_margin).max()) == pytest.approx(
        max_margin)


def _ldam_inputs(mask):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((12, 6)) * 2).astype(np.float32)
    labels = rng.integers(0, 6, 12).astype(np.int32)
    counts = np.asarray([40, 2, 9, 0, 17, 5])
    m = rng.random(12) < 0.6 if mask == "mask" else None
    if mask == "empty":
        m = np.zeros(12, bool)
    return logits, labels, counts, m


@pytest.mark.parametrize("mask", ["none", "mask", "empty"])
@pytest.mark.parametrize("s", [30.0, 1.0])
def test_ldam_loss_and_grad_match(mask, s):
    logits, labels, counts, m = _ldam_inputs(mask)
    r_margins = R.class_margins(jnp.asarray(counts))
    r_mask = None if m is None else jnp.asarray(m)

    def r_loss(lg):
        return R.ldam_loss(lg, jnp.asarray(labels), r_margins, s=s,
                           sample_mask=r_mask)

    want, want_g = jax.value_and_grad(r_loss)(jnp.asarray(logits))
    lg = torch.tensor(logits, requires_grad=True)
    got = T.ldam_loss(lg, torch.tensor(labels), T.class_margins(counts), s=s,
                      sample_mask=None if m is None else torch.tensor(m))
    (got_g,) = torch.autograd.grad(got, lg)
    got = float(got.detach())
    np.testing.assert_allclose(got, float(want), rtol=LDAM_TOL,
                               atol=LDAM_TOL)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=LDAM_TOL,
                               atol=LDAM_TOL * np.abs(want_g).max() + 1e-12)
    if mask == "empty":
        assert got == 0.0


def test_ldam_with_zero_margins_is_scaled_ce():
    logits, labels, _, _ = _ldam_inputs("none")
    lg, lb = torch.tensor(logits), torch.tensor(labels).long()
    got = T.ldam_loss(lg, lb, torch.zeros(6), s=2.0)
    want = torch.nn.functional.cross_entropy(2.0 * lg, lb)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
