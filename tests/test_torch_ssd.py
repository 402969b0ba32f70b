"""K3's plain versions (``repro_torch/kernels/ssd_scan.py``) against the
JAX package: the Pallas kernels themselves (``ssd_scan`` and
``ssd_scan_bwd``, run in interpret mode as the reference's own tests run
them on the CPU) and the sequential-recurrence oracle
(``repro.kernels.ref.ssd`` and ``ssd_grads``). Also the port's own
oracle (``kernels/ref.py``), ``SSDScan`` on the CPU, the prefill→decode
handoff, and ``ops.ssd_scan``'s routing. The plain forward with K3f's
sm90 rounding points emulated (``emulate=dtype``) against the
interpret-mode kernel and against the bound those roundings give; the
route rule, and a named route refused on the CPU.

Shapes: the reference's ``test_kernels.py:231-236``, a ragged S (the
tail chunk masked), groups G > 1 and a nonzero initial state. Inputs come
from numpy with a seed. Tolerance: rtol = atol = 1e-4 in float32 (float32
on both sides, summed in another order); bfloat16 inputs atol 5e-2 and
rtol 2e-2, as ``test_kernels.py`` holds its bfloat16 cells; float32
states from emulated 16-bit roundings: 1e-4 of their largest entry.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R_ref

from repro_torch.configs.backend import ExecPolicy
from repro_torch.kernels import ops
from repro_torch.kernels import ref as T_ref
from repro_torch.kernels import ssd_scan as K3

R_SSD = importlib.import_module("repro.kernels.ssd_scan")

TOL = 1e-4
TOL_BF16 = (2e-2, 5e-2)             # rtol, atol

# (B, S, H, P, G, N, chunk, with an initial state)
CASES = {
    "ref_a": (2, 64, 4, 16, 1, 32, 16, False),
    "ref_b": (1, 128, 8, 32, 2, 16, 32, True),
    "ref_c": (1, 64, 4, 64, 1, 64, 64, False),
    "ref_d": (2, 96, 6, 16, 3, 8, 32, True),
    "ragged": (2, 50, 4, 8, 2, 8, 16, True),
    "ragged_short": (1, 37, 2, 8, 1, 8, 64, True),
}


def _inputs(B, S, H, P, G, N, init, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, S, H, P)
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32)     # softplus
    a = -np.exp(f(H) * 0.3).astype(np.float32)
    b, c = f(B, S, G, N) * 0.3, f(B, S, G, N) * 0.3
    s0 = f(B, H, P, N) * 0.5 if init else np.zeros((B, H, P, N), np.float32)
    return x, dt, a, b, c, s0, f(B, S, H, P), f(B, H, P, N)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The case, its inputs, and the interpret-mode kernels' forward (with
    the chunk states) and backward."""
    B, S, H, P, G, N, cl, init = CASES[request.param]
    arrs = _inputs(B, S, H, P, G, N, init, sum(CASES[request.param][:7]))
    x, dt, a, b, c, s0, dy, dfin = (jnp.asarray(v) for v in arrs)
    y, fin, st = R_SSD.ssd_scan(x, dt, a, b, c, chunk=cl, interpret=True,
                                initial_state=s0, return_chunk_states=True)
    grads = R_SSD.ssd_scan_bwd(x, dt, a, b, c, st, dy, dfin, chunk=cl,
                               interpret=True)
    return dict(shape=CASES[request.param], arrs=arrs,
                fwd=[np.asarray(v) for v in (y, fin, st)],
                grads=[np.asarray(g) for g in grads])


def test_forward_plain_matches_interpret_kernel(case):
    x, dt, a, b, c, s0, _, _ = _t(*case["arrs"])
    cl = case["shape"][6]
    got = K3.ssd_scan_fwd(x, dt, a, b, c, s0, chunk=cl,
                          return_chunk_states=True)       # the CPU route
    for g, w in zip(got, case["fwd"]):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_backward_plain_matches_interpret_kernel(case):
    x, dt, a, b, c, _, dy, dfin = _t(*case["arrs"])
    st = torch.from_numpy(np.array(case["fwd"][2]))
    got = K3.ssd_scan_bwd(x, dt, a, b, c, st, dy, dfin,
                          chunk=case["shape"][6])
    for g, w in zip(got, case["grads"]):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w)


def test_plain_pair_matches_sequential_oracles(case):
    """The plain pair against ``repro.kernels.ref.ssd`` and its autodiff
    ``ssd_grads``, and the port's own oracle against the reference's."""
    arrs = case["arrs"]
    x, dt, a, b, c, s0, dy, dfin = _t(*arrs)
    jx = [jnp.asarray(v) for v in arrs]
    y_r, fin_r = R_ref.ssd(*jx[:5], initial_state=jx[5])
    g_r = R_ref.ssd_grads(*jx[:6], jx[6], jx[7])
    y, fin, st = K3.ssd_scan_fwd_plain(x, dt, a, b, c, s0,
                                       chunk=case["shape"][6])
    _close(y, y_r)
    _close(fin, fin_r)
    for g, w in zip(K3.ssd_scan_bwd_plain(x, dt, a, b, c, st, dy, dfin,
                                          chunk=case["shape"][6]), g_r):
        _close(g, w)
    y_t, fin_t = T_ref.ssd(x, dt, a, b, c, initial_state=s0)
    _close(y_t, y_r)
    _close(fin_t, fin_r)
    for g, w in zip(T_ref.ssd_grads(x, dt, a, b, c, s0, dy, dfin), g_r):
        _close(g, w)


def test_bf16_plain_matches_interpret_kernel():
    """bfloat16 x, b, c and dt (the reference's kernel tests pass dt in
    bfloat16 too): y in bfloat16, states and gradients in float32."""
    arrs = _inputs(1, 40, 4, 16, 2, 16, True, 3)
    x, dt, a, b, c, s0, dy, dfin = arrs
    bf = jnp.bfloat16
    jx = [jnp.asarray(v, bf) for v in (x, dt)] + [jnp.asarray(a)] + \
        [jnp.asarray(v, bf) for v in (b, c)]
    y, fin, st = R_SSD.ssd_scan(*jx, chunk=16, interpret=True,
                                initial_state=jnp.asarray(s0),
                                return_chunk_states=True)
    grads = R_SSD.ssd_scan_bwd(*jx, st, jnp.asarray(dy), jnp.asarray(dfin),
                               chunk=16, interpret=True)
    tx = [torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16) for v in (jx[0], jx[1])]
    tb = [torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16) for v in (jx[3], jx[4])]
    ty, tfin, tst = K3.ssd_scan_fwd(tx[0], tx[1], torch.from_numpy(a), *tb,
                                    torch.from_numpy(s0), chunk=16,
                                    return_chunk_states=True)
    rtol, atol = TOL_BF16
    assert ty.dtype == torch.bfloat16
    for g, w in zip((ty, tfin, tst), (y, fin, st)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=rtol, atol=atol)
    tg = K3.ssd_scan_bwd(tx[0], tx[1], torch.from_numpy(a), *tb, tst,
                         torch.from_numpy(dy), torch.from_numpy(dfin),
                         chunk=16)
    for g, w in zip(tg, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


def test_prefill_decode_handoff():
    """A sequence split at a non-chunk boundary, the carried state
    threaded into the second part, equals one pass (``test_kernels.py:
    462``); on the plain route and through ``SSDScan``."""
    x, dt, a, b, c, _, _, _ = _t(*_inputs(1, 56, 2, 8, 2, 8, False, 5))
    cut = 24
    y_full, st_full = K3.ssd_scan_fwd(x, dt, a, b, c, chunk=16)
    y1, st1 = K3.ssd_scan_fwd(x[:, :cut], dt[:, :cut], a, b[:, :cut],
                              c[:, :cut], chunk=16)
    y2, st2 = K3.SSDScan.apply(x[:, cut:], dt[:, cut:], a, b[:, cut:],
                               c[:, cut:], st1, 16)
    _close(torch.cat([y1, y2], dim=1), y_full.numpy())
    _close(st2, st_full.numpy())
    # a cold start disagrees: the state is honoured
    y0, _ = K3.ssd_scan_fwd(x[:, cut:], dt[:, cut:], a, b[:, cut:],
                            c[:, cut:], chunk=16)
    assert float((y0 - y2).abs().max()) > 1e-3


def test_ssd_scan_function_gradients_and_dtypes():
    """``SSDScan`` on the CPU (the plain pair): its gradients against the
    port's sequential oracle, in the inputs' dtypes, d(initial_state) in
    float32."""
    x, dt, a, b, c, s0, dy, dfin = _t(*_inputs(2, 50, 4, 8, 2, 8, True, 9))
    leaves = [t.requires_grad_(True) for t in (x, dt, a, b, c, s0)]
    y, fin = K3.SSDScan.apply(*leaves, 16)
    got = torch.autograd.grad((y, fin), leaves, (dy, dfin))
    for g, w in zip(got, T_ref.ssd_grads(x, dt, a, b, c, s0, dy, dfin)):
        assert g.dtype == torch.float32
        _close(g, w.numpy())


def test_ssd_scan_function_without_initial_state():
    """``SSDScan`` given no initial state (as a training step calls it)
    gives the outputs and gradients it gives from zeros."""
    x, dt, a, b, c, _, dy, dfin = _t(*_inputs(2, 50, 4, 8, 2, 8, False, 10))
    leaves = [t.requires_grad_(True) for t in (x, dt, a, b, c)]
    zeros = torch.zeros(dfin.shape, requires_grad=True)
    outs = K3.SSDScan.apply(*leaves, None, 16)
    want = K3.SSDScan.apply(*leaves, zeros, 16)
    for g, w in zip(outs, want):
        assert torch.equal(g, w)
    got = torch.autograd.grad(outs, leaves, (dy, dfin))
    for g, w in zip(got, torch.autograd.grad(want, leaves, (dy, dfin))):
        assert torch.equal(g, w)


def test_ops_ssd_scan_routing_and_checks():
    x, dt, a, b, c, s0, _, _ = _t(*_inputs(1, 40, 4, 8, 2, 8, True, 11))
    want, want_fin = T_ref.ssd(x, dt, a, b, c, initial_state=s0)
    for mode in ("ref", "fused", "autodiff"):
        y, fin = ops.ssd_scan(x, dt, a, b, c, s0, chunk=16,
                              policy=ExecPolicy(kernel_vjp=mode))
        _close(y, want.numpy())
        _close(fin, want_fin.numpy())
    y0, _ = ops.ssd_scan(x, dt, a, b, c, chunk=64,
                         policy=ExecPolicy(kernel_vjp="fused"))
    _close(y0, T_ref.ssd(x, dt, a, b, c)[0].numpy())   # chunk clamped to S
    # a hand-built policy with an unknown mode raises in every routed
    # entry point instead of falling through to a kernel
    bogus = ExecPolicy(kernel_vjp="pallas")
    q = torch.zeros((1, 2, 4, 8))
    for call in (lambda: ops.ssd_scan(x, dt, a, b, c, chunk=16,
                                      policy=bogus),
                 lambda: ops.flash_attention(q, q, q, policy=bogus),
                 lambda: ops.paged_attention(
                     q[0], torch.zeros((2, 4, 2, 8)), torch.zeros((2, 4, 2, 8)),
                     torch.zeros((2, 1), dtype=torch.int32),
                     torch.ones(2, dtype=torch.int32), policy=bogus)):
        with pytest.raises(ValueError, match="unknown kernel_vjp mode"):
            call()
    with pytest.raises(ValueError, match="autodiff"):
        ops.ssd_scan(x.clone().requires_grad_(True), dt, a, b, c, chunk=16,
                     policy=ExecPolicy(kernel_vjp="autodiff"))
    with pytest.raises(TypeError, match="share"):
        K3.ssd_scan_fwd(x.double(), dt, a, b, c, chunk=16)
    with pytest.raises(TypeError, match="dt must be"):
        K3.ssd_scan_fwd(x, dt.double(), a, b, c, chunk=16)
    with pytest.raises(ValueError, match="multiple of G"):
        K3.ssd_scan_fwd(x[:, :, :3], dt[:, :, :3], a[:3], b, c, chunk=16)
    with pytest.raises(ValueError, match="initial_state"):
        K3.ssd_scan_fwd(x, dt, a, b, c, s0[:, :2], chunk=16)
    # the kernel's shared memory is checked before a launch
    assert K3.smem_bytes("fwd", 64, 128, 256) <= K3.SMEM_LIMIT
    assert K3.smem_bytes("bwd", 64, 128, 256) <= K3.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        K3._check_cuda("bwd", 128, 256, 256)


# ------------------------------------------------ K3f's sm90 route --

def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_emulated_route_matches_interpret_kernel(case, dtype):
    """The plain forward with the sm90 route's 16-bit rounding points
    against the reference's ``ssd_scan`` in interpret mode: y at the
    bfloat16 cells' tolerance, the float32 states (the hi + lo deposit)
    to 1e-4 of their largest entry."""
    x, dt, a, b, c, s0, _, _ = _t(*case["arrs"])
    y, fin, st = K3.ssd_scan_fwd_plain(x, dt, a, b, c, s0,
                                       chunk=case["shape"][6], emulate=dtype)
    rtol, atol = TOL_BF16
    np.testing.assert_allclose(y.numpy(), case["fwd"][0], rtol=rtol,
                               atol=atol)
    for g, w in zip((fin, st), case["fwd"][1:]):
        assert tuple(g.shape) == w.shape
        assert _rel(g, torch.from_numpy(np.array(w))) <= 1e-4


# (B, S, H, P, G, N, chunk): a ragged tail with groups, and a chunk clamped
# to S at the route's widths
EMULATED = {"ragged_grouped": (2, 80, 4, 16, 2, 16, 32),
            "clamped": (1, 40, 2, 64, 1, 128, 256)}


@pytest.mark.parametrize("name", sorted(EMULATED))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_emulation_within_its_bound(name, dtype):
    """The kernel's rounding points (w . X split into hi + lo, att and
    S_in rounded to 16 bits) move y by at most 2u (sum|terms| + |y|)
    elementwise from the unrounded phases (u = 2^-9 bfloat16, 2^-12
    float16; sum|terms| is the plain forward on |x|, |b|, |c| and
    |initial state|), and the float32 states by under 1e-4 of their
    largest entry."""
    B, S, H, P, G, N, cl = EMULATED[name]
    x, dt, a, b, c, s0, _, _ = _t(*_inputs(B, S, H, P, G, N, True, S + N))
    x, b, c = (t.to(dtype) for t in (x, b, c))
    u = 2.0 ** -9 if dtype == torch.bfloat16 else 2.0 ** -12
    want = K3.ssd_scan_fwd_plain(x, dt, a, b, c, s0, chunk=cl)
    got = K3.ssd_scan_fwd_plain(x, dt, a, b, c, s0, chunk=cl,
                                emulate=dtype)
    terms = K3.ssd_scan_fwd_plain(x.float().abs(), dt, a, b.float().abs(),
                                  c.float().abs(), s0.abs(), chunk=cl)[0]
    err = (got[0].float() - want[0].float()).abs()
    assert got[0].dtype == dtype
    assert bool((err <= 2 * u * (terms + want[0].float().abs())).all())
    assert _rel(got[1], want[1]) <= 1e-4 and _rel(got[2], want[2]) <= 1e-4
    # the split keeps the deposit: one rounding of w . X would not
    assert _rel(got[1], want[1]) < 0.1 * u


def test_fwd_route_and_its_shared_memory():
    """One rule for float32, bfloat16 and float16: sm90 at P 64 and N 64
    or 128 alone; its CTAs (float32's and 16 bits') fit in shared memory
    at every chunk up to 256."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert K3.fwd_route(dtype, 64, 64) == "sm90"
        assert K3.fwd_route(dtype, 64, 128) == "sm90"
        for P, N in ((32, 64), (64, 32), (64, 256), (128, 128), (64, 16)):
            assert K3.fwd_route(dtype, P, N) == "simt"
        for N in (64, 128):
            for cl in (1, 48, 100, 256):
                assert K3.smem_bytes("fwd", 64, N, cl, "sm90", dtype) \
                    <= K3.SMEM_LIMIT


@pytest.mark.parametrize("route", ["sm90", "simt"])
def test_named_route_on_cpu_raises(route):
    """A named route is a kernel's: on a CPU tensor the wrapper refuses it
    rather than run the plain version under the kernel's name."""
    x, dt, a, b, c, _, _, _ = _t(*_inputs(1, 40, 2, 64, 1, 64, False, 13))
    x, b, c = (t.to(torch.bfloat16) for t in (x, b, c))
    before = dict(K3.fwd_routes)
    with pytest.raises(ValueError, match="names a CUDA kernel"):
        K3.ssd_scan_fwd(x, dt, a, b, c, chunk=16, route=route)
    assert K3.fwd_routes == before
