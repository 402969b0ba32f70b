"""K1, the distill-KL pair, on its CPU route against the JAX package.

On the CPU the port's K1 route (``kernels.ops.distill_kl``, i.e. the
plain versions of the kernels' arithmetic inside ``DistillKL``, which is
what ``mode="fused"`` runs there) is held to:

  * the JAX package's ``kernels.ops.distill_kl`` (the Pallas pair),
    run in interpret mode through the reference's CPU policy with small
    blocks, as tests/test_kernels.py runs it: values and both gradients,
    with and without the teacher gradient;
  * torch autograd of the port's ``mode="ref"`` formula, as a second
    oracle.

The Triton kernels themselves run only on a CUDA device; ``chip_smoke.py``
holds them to these plain versions there. Inputs come from numpy with a
seed. Tolerance 1e-5 in float32: the computations differ only in
summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import backend as B
from repro.kernels import ops as r_ops

from repro_torch.core import losses as T_L
from repro_torch.kernels import distill_kl as K
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

TOL = 1e-5
_POL = B.resolve_exec_policy(None)      # the cpu profile: interpret mode


def _ref_pair(t, s, g, br, bv, with_teacher_grad):
    pol = _POL.override_blocks("distill_kl", block_rows=br, block_v=bv)
    out, pull = jax.vjp(
        lambda a, b: r_ops.distill_kl(a, b, with_teacher_grad=with_teacher_grad,
                                      policy=pol),
        jnp.asarray(t), jnp.asarray(s))
    dt, ds = pull(jnp.asarray(g))
    return np.asarray(out), np.asarray(dt), np.asarray(ds)


def _port_pair(t, s, g, with_teacher_grad):
    tt = torch.tensor(t, requires_grad=True)
    ts = torch.tensor(s, requires_grad=True)
    out = t_ops.distill_kl(tt, ts, with_teacher_grad=with_teacher_grad)
    dt, ds = torch.autograd.grad(out, (tt, ts), torch.tensor(g),
                                 materialize_grads=True)
    return out.detach().numpy(), dt.numpy(), ds.numpy()


def _inputs(R, V, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    t = (rng.standard_normal((R, V)) * scale).astype(np.float32)
    s = (rng.standard_normal((R, V)) * scale).astype(np.float32)
    g = rng.uniform(0.1, 1.0, R).astype(np.float32)
    return t, s, g


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("with_teacher_grad", [True, False])
@pytest.mark.parametrize("R,V,br,bv", [
    (16, 10, 8, 16),            # the main path's rows of 10 classes
    (8, 512, 4, 128),
    (8, 384, 8, 100),           # ragged vocab tail
    (10, 250, 4, 128),          # ragged rows and vocab
    (7, 300, 4, 96),
])
def test_k1_matches_reference_pair(R, V, br, bv, with_teacher_grad):
    t, s, g = _inputs(R, V)
    want = _ref_pair(t, s, g, br, bv, with_teacher_grad)
    got = _port_pair(t, s, g, with_teacher_grad)
    for a, b in zip(got, want):
        _close(a, b)
    if not with_teacher_grad:
        assert not got[1].any()


@pytest.mark.parametrize("R,V", [(16, 10), (10, 250), (3, 1000)])
def test_k1_matches_autograd_of_ref_mode(R, V):
    t, s, g = _inputs(R, V, seed=1)
    got = _port_pair(t, s, g, True)
    want_kl = t_ref.distill_kl(torch.tensor(t), torch.tensor(s))
    want_dt, want_ds = t_ref.distill_kl_grads(torch.tensor(t), torch.tensor(s),
                                              torch.tensor(g))
    for a, b in zip(got, (want_kl, want_dt, want_ds)):
        _close(a, b.numpy())


def test_k1_neg_inf_padding_columns():
    """Columns padded with NEG_INF in both inputs carry no mass and get
    zero gradient."""
    t, s, g = _inputs(6, 200, seed=2)
    t[:, 150:] = K.NEG_INF
    s[:, 150:] = K.NEG_INF
    want = _ref_pair(t, s, g, 4, 64, True)
    got = _port_pair(t, s, g, True)
    for a, b in zip(got, want):
        _close(a, b)
    short = _port_pair(t[:, :150].copy(), s[:, :150].copy(), g, True)
    _close(got[0], short[0])
    assert not got[1][:, 150:].any() and not got[2][:, 150:].any()


def test_k1_extreme_logits():
    """±1e4 logits: the stabilized sums stay finite and match."""
    t, s, g = _inputs(5, 130, seed=3)
    t[:, 0], s[:, 1] = 1e4, -1e4
    t[:, 2], s[:, 3] = -1e4, 1e4
    want = _ref_pair(t, s, g, 4, 64, True)
    got = _port_pair(t, s, g, True)
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        _close(a, b)


@pytest.mark.parametrize("temperature", [1.0, 4.0])
def test_softmax_kl_modes_agree(temperature):
    """``core.losses.softmax_kl``: the fused route equals the ref formula
    through the temperature and any leading shape, gradients included."""
    t, s, _ = _inputs(12, 10, seed=4)
    grads = {}
    for mode in ("ref", "fused"):
        tt = torch.tensor(t.reshape(3, 4, 10), requires_grad=True)
        ts = torch.tensor(s.reshape(3, 4, 10), requires_grad=True)
        kl = T_L.softmax_kl(tt, ts, temperature, mode=mode)
        assert kl.shape == (3, 4)
        grads[mode] = (kl.detach().numpy(),
                       *torch.autograd.grad(kl.sum(), (tt, ts)))
    for a, b in zip(grads["fused"], grads["ref"]):
        _close(np.asarray(a), np.asarray(b))


def test_plain_versions_are_the_wrappers_cpu_route():
    t, s, g = (torch.tensor(a) for a in _inputs(9, 33, seed=5))
    kl, lse_t, lse_s = K.distill_kl_fwd(t, s)
    for a, b in zip((kl, lse_t, lse_s), K.distill_kl_fwd_plain(t, s)):
        assert torch.equal(a, b)
    dt, ds = K.distill_kl_bwd(t, s, lse_t, lse_s, kl, g)
    pdt, pds = K.distill_kl_bwd_plain(t, s, lse_t, lse_s, kl, g)
    assert torch.equal(dt, pdt) and torch.equal(ds, pds)
    _close(lse_t.numpy(), torch.logsumexp(t, 1).numpy())
    assert K.launches == {"distill_kl_fwd": 0, "distill_kl_bwd": 0}


def test_bf16_inputs_compute_in_float32():
    t, s, g = (torch.tensor(a) for a in _inputs(4, 64, seed=6))
    tb, sb = t.bfloat16(), s.bfloat16()
    kl, lse_t, lse_s = K.distill_kl_fwd(tb, sb)
    assert kl.dtype == torch.float32
    _close(kl.numpy(), K.distill_kl_fwd_plain(tb.float(), sb.float())[0].numpy())
    dt, ds = K.distill_kl_bwd(tb, sb, lse_t, lse_s, kl, g)
    assert dt.dtype == ds.dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["shape", "dtype", "layout", "device"])
def test_wrappers_refuse_what_the_kernel_does_not_take(case):
    t, s, _ = (torch.tensor(a) for a in _inputs(4, 8))
    if case == "shape":
        args, err = (t, s[:, :4]), ValueError
    elif case == "dtype":
        args, err = (t.double(), s.double()), TypeError
    elif case == "layout":
        args, err = (t.t(), s.t()), ValueError
    else:       # neither cpu nor cuda: no route, no silent fallback
        args, err = (t.to("meta"), s.to("meta")), ValueError
    with pytest.raises(err):
        K.distill_kl_fwd(*args)
