"""K3b's chunked plain version (``repro_torch/kernels/ssd_scan.py``'s
``ssd_scan_bwd_chunked_plain``: the sm90 route's phases written out in
PyTorch) against the JAX package: the reference's ``ssd_scan_bwd`` run in
interpret mode, as its own tests run it on the CPU, and the sequential
recurrence's autodiff (``repro.kernels.ref.ssd_grads``); against the
port's float32 oracle (``ssd_scan_bwd_plain``, autograd through the
forward) too. With the route's 16-bit rounding points emulated
(``emulate=dtype``): within the bound those roundings give, and to 1e-2 of
each gradient's largest entry. The route rule, its CTAs' shared memory,
and a named route refused on the CPU.

Shapes: ``tests/test_torch_ssd.py``'s CASES (several chunks, a ragged
tail, groups G 2 and 3, a chunk clamped into S, with and without an
initial state) and two at the route's widths. Inputs come from numpy with
a seed. Tolerance: float32 on both sides, summed in another order: 1e-5
of each gradient's largest entry, da 2e-5 (a sum over every position with
cancellation: the reference's interpret-mode kernel and the port's
autograd oracle differ from each other by 1.0e-5 of it at ref_c).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R_ref

from repro_torch.kernels import ssd_scan as K3

R_SSD = importlib.import_module("repro.kernels.ssd_scan")

GRADS = ("dx", "ddt", "da", "db", "dc", "dinit")
TOL = dict.fromkeys(GRADS, 1e-5) | {"da": 2e-5}

# (B, S, H, P, G, N, chunk, with an initial state): test_torch_ssd.py's
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


def _rel(got, want) -> float:
    got, want = (torch.from_numpy(np.array(t, np.float32))
                 if not isinstance(t, torch.Tensor) else t.float()
                 for t in (got, want))
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The case, its inputs, the chunk states, and the reference's
    gradients: the interpret-mode ``ssd_scan_bwd`` and ``ssd_grads``."""
    B, S, H, P, G, N, cl, init = CASES[request.param]
    arrs = _inputs(B, S, H, P, G, N, init, 7 * S + N)
    jx = [jnp.asarray(v) for v in arrs]
    _, _, st = R_SSD.ssd_scan(*jx[:5], chunk=cl, interpret=True,
                              initial_state=jx[5], return_chunk_states=True)
    kernel = R_SSD.ssd_scan_bwd(*jx[:5], st, jx[6], jx[7], chunk=cl,
                                interpret=True)
    seq = R_ref.ssd_grads(*jx[:6], jx[6], jx[7])
    return dict(shape=CASES[request.param], arrs=arrs, states=np.asarray(st),
                kernel=[np.asarray(g) for g in kernel],
                seq=[np.asarray(g) for g in seq])


def test_chunked_plain_matches_reference_and_autograd(case):
    """float32: every gradient within 1e-5 of its largest entry (da 2e-5)
    of the interpret-mode kernel, the sequential recurrence's autodiff and
    the port's autograd oracle."""
    x, dt, a, b, c, _, dy, dfin = (torch.from_numpy(np.array(v))
                                   for v in case["arrs"])
    st = torch.from_numpy(np.array(case["states"]))
    cl = case["shape"][6]
    got = K3.ssd_scan_bwd_chunked_plain(x, dt, a, b, c, st, dy, dfin,
                                        chunk=cl)
    oracle = K3.ssd_scan_bwd_plain(x, dt, a, b, c, st, dy, dfin, chunk=cl)
    for name, g, wk, ws, wo in zip(GRADS, got, case["kernel"], case["seq"],
                                   oracle):
        assert g.dtype == torch.float32 and tuple(g.shape) == wk.shape, name
        assert _rel(g, wk) <= TOL[name], name
        assert _rel(g, ws) <= TOL[name], name
        assert _rel(g, wo) <= TOL[name], name


# (B, S, H, P, G, N, chunk): the route's widths with a ragged tail and an
# initial state, and with groups and a chunk of 48
ROUTE_SHAPES = {"zamba2_ragged": (1, 150, 4, 64, 1, 64, 64),
                "grouped_chunk48": (1, 100, 4, 64, 2, 128, 48)}


def _route_inputs(name, dtype):
    B, S, H, P, G, N, cl = ROUTE_SHAPES[name]
    x, dt, a, b, c, s0, dy, dfin = (torch.from_numpy(v) for v in
                                    _inputs(B, S, H, P, G, N, True, S + N))
    x, b, c, dy = (t.to(dtype) for t in (x, b, c, dy))
    _, _, st = K3.ssd_scan_fwd_plain(x, dt, a, b, c, s0, chunk=cl)
    return (x, dt, a, b, c, st, dy, dfin), cl


@pytest.mark.parametrize("name", sorted(CASES) + sorted(ROUTE_SHAPES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_emulation_within_its_rounding_bound(name, dtype):
    """x, b, c and dy in 16 bits: the route's rounding points (S_in,
    dS_out, att and dcb rounded before their products, ecs . dY split
    into hi + lo) move dx, db, dc and d(initial_state) by at most
    2u (sum|terms| + |g|) elementwise from the float32 phases (u = 2^-9
    bfloat16, 2^-12 float16; sum|terms| is the float32 phases on |x|,
    |b|, |c|, |dy|, |dfinal| and |states|, every product there
    nonnegative), and every gradient by at most 1e-2 of its largest
    entry (ddt and da take differences, so only the latter)."""
    if name in CASES:
        B, S, H, P, G, N, cl, init = CASES[name]
        x, dt, a, b, c, s0, dy, dfin = (torch.from_numpy(v) for v in
                                        _inputs(B, S, H, P, G, N, init, S))
        x, b, c, dy = (t.to(dtype) for t in (x, b, c, dy))
        _, _, st = K3.ssd_scan_fwd_plain(x, dt, a, b, c, s0, chunk=cl)
        args = (x, dt, a, b, c, st, dy, dfin)
    else:
        args, cl = _route_inputs(name, dtype)
    x, dt, a, b, c, st, dy, dfin = args
    u = 2.0 ** -9 if dtype == torch.bfloat16 else 2.0 ** -12
    want = K3.ssd_scan_bwd_chunked_plain(*args, chunk=cl)
    got = K3.ssd_scan_bwd_chunked_plain(*args, chunk=cl, emulate=dtype)
    terms = K3.ssd_scan_bwd_chunked_plain(
        x.float().abs(), dt, a, b.float().abs(), c.float().abs(), st.abs(),
        dy.float().abs(), dfin.abs(), chunk=cl)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) <= 1e-2, GRADS[i]
        if GRADS[i] in ("dx", "db", "dc", "dinit"):
            err = (g - w).abs()
            assert bool((err <= 2 * u * (terms[i] + w.abs())).all()), \
                GRADS[i]
    # the hi + lo deposit keeps d(initial_state) at float32's level
    assert _rel(got[5], want[5]) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_emulation_reads_a_float32_dy_rounded_once(dtype):
    """A float32 dy is taken as its 16-bit rounding, as the route reads
    it: the same gradients, bit for bit."""
    args, cl = _route_inputs("zamba2_ragged", dtype)
    dy32 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(args[6].shape)).astype(np.float32))
    got32 = K3.ssd_scan_bwd_chunked_plain(*args[:6], dy32, args[7],
                                          chunk=cl, emulate=dtype)
    got16 = K3.ssd_scan_bwd_chunked_plain(*args[:6], dy32.to(dtype),
                                          args[7], chunk=cl, emulate=dtype)
    assert not torch.equal(dy32, dy32.to(dtype).float())
    for g, w in zip(got32, got16):
        assert torch.equal(g, w)


def test_bwd_route_and_its_shared_memory():
    """K3f's rule, one for float32, bfloat16 and float16: sm90 at P 64 and
    N 64 or 128 alone; its CTAs (the deposit, column and row kernels,
    float32's and 16 bits') fit in shared memory at every chunk up to
    256."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for N in (64, 128):
            assert K3.bwd_route(dtype, 64, N) == "sm90"
        for P, N in ((32, 64), (64, 32), (64, 256), (128, 128), (64, 16)):
            assert K3.bwd_route(dtype, P, N) == "simt"
        for N in (64, 128):
            for cl in (1, 48, 100, 256):
                need = K3.smem_bytes("bwd", 64, N, cl, "sm90", dtype)
                assert need <= K3.SMEM_LIMIT
                assert need > K3.smem_bytes("fwd", 64, N, cl, "sm90", dtype)


@pytest.mark.parametrize("route", ["sm90", "simt"])
def test_named_bwd_route_on_cpu_raises(route):
    """A named route is a kernel's: on a CPU tensor ``ssd_scan_bwd``
    refuses it rather than run the plain version under the kernel's name,
    and counts nothing."""
    args, cl = _route_inputs("zamba2_ragged", torch.bfloat16)
    before = (dict(K3.bwd_routes), dict(K3.launches))
    with pytest.raises(ValueError, match="names a CUDA kernel"):
        K3.ssd_scan_bwd(*args, chunk=cl, route=route)
    assert (K3.bwd_routes, K3.launches) == before
    # unnamed, the CPU route is the float32 oracle
    got = K3.ssd_scan_bwd(*args, chunk=cl)
    for g, w in zip(got, K3.ssd_scan_bwd_plain(*args, chunk=cl)):
        assert torch.equal(g, w)
