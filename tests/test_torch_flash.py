"""K2's plain versions (``repro_torch/kernels/flash_attention.py``) against
the JAX package: the materialized oracle (``repro.kernels.ref.attention``
and ``attention_grads``) and the Pallas kernels themselves, run in
interpret mode with 16-wide blocks so that every shape has ragged tails.
Also ``FlashAttention`` on the CPU against torch autograd of the port's
materialized oracle, ``ops.flash_attention``'s routing, the three
kernels' routes and the dO each backward kernel reads, and the algebra of
the sm90 kernels at D 112, which store and multiply tiles padded to 128
with zero columns: the plain pair on the padded inputs, cut back, against
the plain pair and the reference's interpret-mode kernels at D 112; and
the plain backward (the float32 sm90 kernels' oracle on the card) against
the interpret-mode K2q and K2kv at D 64 and 128.

Inputs are float32 from numpy with a seed. Tolerance rtol = atol = 1e-5:
float32 on both sides, summed in another order. Rows with no live key
(causal with Sq > Sk) are held to the interpret-mode kernel exactly
(o = 0, lse = NEG_INF, zero gradients); the materialized oracle averages
v uniformly there, so it is compared on the live rows only.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R_ref

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as T_ref

R_FA = importlib.import_module("repro.kernels.flash_attention")

TOL = 1e-5
BLOCK = 16

# (B, Hq, Hkv, Sq, Sk, causal, window): GQA g ∈ {1, 2, 3}, Sq = Sk ∈
# {24, 40}, Sq < Sk, causal Sq > Sk (dead rows), a window, causal=False
CASES = {
    "g1_s24": (2, 2, 2, 24, 24, True, 0),
    "g2_s40": (1, 4, 2, 40, 40, True, 0),
    "g3_s40": (1, 3, 1, 40, 40, True, 0),
    "sq_lt_sk": (1, 4, 2, 24, 40, True, 0),
    "dead_rows": (1, 2, 1, 40, 24, True, 0),
    "window": (1, 4, 2, 40, 40, True, 7),
    "not_causal": (1, 3, 1, 24, 40, False, 0),
}
D = 32


def _inputs(B, hq, hkv, sq, sk, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, hq, sq, D), f(B, hkv, sk, D), f(B, hkv, sk, D), \
        f(B, hq, sq, D)


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _live_rows(sq, sk, causal):
    rows = np.arange(sq)
    return rows + (sk - sq) >= 0 if causal else np.ones(sq, bool)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The case, its inputs, and the interpret-mode kernels' forward
    statistics and gradients."""
    B, hq, hkv, sq, sk, causal, window = CASES[request.param]
    q, k, v, do = _inputs(B, hq, hkv, sq, sk, sum(CASES[request.param][:5]))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, o_f32, lse = R_FA.flash_attention(
        jq, jk, jv, causal=causal, window=window, block_q=BLOCK,
        block_k=BLOCK, interpret=True, return_stats=True)
    grads = R_FA.flash_attention_bwd(
        jq, jk, jv, o_f32, lse, jnp.asarray(do), causal=causal,
        window=window, block_q=BLOCK, block_k=BLOCK, interpret=True)
    return dict(shape=CASES[request.param], q=q, k=k, v=v, do=do,
                out=np.asarray(out), o_f32=np.asarray(o_f32),
                lse=np.asarray(lse), grads=[np.asarray(g) for g in grads])


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_forward_plain_matches_interpret_kernel(case):
    B, hq, hkv, sq, sk, causal, window = case["shape"]
    o, lse = FA.flash_attention_fwd_plain(*_t(case["q"], case["k"],
                                              case["v"]),
                                          causal=causal, window=window)
    assert tuple(o.shape) == (B * hq, sq, D) and tuple(lse.shape) == (
        B * hq, sq)
    _close(o, case["o_f32"])
    _close(lse, case["lse"])
    dead = ~_live_rows(sq, sk, causal)
    # rows with no live key: exactly NEG_INF and exact zeros, as the kernel
    np.testing.assert_array_equal(lse.numpy()[:, dead], FA.NEG_INF)
    np.testing.assert_array_equal(case["lse"][:, dead], FA.NEG_INF)
    assert not o.numpy()[:, dead].any()


def test_backward_plain_matches_interpret_kernel(case):
    _, _, _, sq, sk, causal, window = case["shape"]
    q, k, v, do = _t(case["q"], case["k"], case["v"], case["do"])
    o, lse = _t(case["o_f32"], case["lse"])
    got = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    for a, b in zip(got, case["grads"]):
        _close(a, b)
    dead = ~_live_rows(sq, sk, causal)
    assert not got[0].numpy()[:, :, dead].any()


# The float32 backward's oracle on the card (the plain pair, which
# chip_smoke.py and the card tests hold the float32 sm90 K2q and K2kv to)
# at the head dims the D 32 cases above leave out: (B, Hq, Hkv, Sq, Sk, D,
# causal, window) with GQA, a window and dead rows (causal Sq > Sk)
WIDE_CASES = {
    "d64_window_dead_rows": (1, 4, 2, 40, 24, 64, True, 7),
    "d128_g3_dead_rows": (1, 3, 1, 40, 24, 128, True, 0),
    "d128_window": (1, 4, 2, 24, 40, 128, True, 9),
}


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_backward_plain_matches_interpret_kernel_at_wide_head_dims(name):
    """The plain backward from the reference's o_f32 and lse against the
    reference's interpret-mode K2q and K2kv at D 64 and 128: dq, dk, dv to
    TOL, dq exactly 0 on dead rows."""
    B, hq, hkv, sq, sk, d, causal, window = WIDE_CASES[name]
    rng = np.random.default_rng(sq + sk + d)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = f(B, hq, sq, d), f(B, hkv, sk, d), f(B, hkv, sk, d), \
        f(B, hq, sq, d)
    jq, jk, jv, jdo = map(jnp.asarray, arrays)
    _, jo, jlse = R_FA.flash_attention(
        jq, jk, jv, causal=causal, window=window, block_q=BLOCK,
        block_k=BLOCK, interpret=True, return_stats=True)
    jgrads = R_FA.flash_attention_bwd(
        jq, jk, jv, jo, jlse, jdo, causal=causal, window=window,
        block_q=BLOCK, block_k=BLOCK, interpret=True)
    q, k, v, do = _t(*arrays)
    o, lse = _t(np.asarray(jo), np.asarray(jlse))
    got = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    for a, b in zip(got, jgrads):
        assert a.dtype == torch.float32
        _close(a, b)
    dead = ~_live_rows(sq, sk, causal)
    assert dead.any() == (sq > sk)
    assert not got[0].numpy()[:, :, dead].any()


def test_plain_matches_materialized_oracle_on_live_rows(case):
    """The plain pair against ``repro.kernels.ref``'s oracle and its
    autodiff, on the rows that see a key (the oracle's cotangent is zero
    on the others, so its gradients compare in full)."""
    B, hq, hkv, sq, sk, causal, window = case["shape"]
    live = _live_rows(sq, sk, causal)
    do = case["do"] * live[None, None, :, None]
    jargs = [jnp.asarray(a) for a in (case["q"], case["k"], case["v"])]
    want = np.asarray(R_ref.attention(*jargs, causal=causal, window=window))
    want_g = R_ref.attention_grads(*jargs, jnp.asarray(do), causal=causal,
                                   window=window)
    q, k, v = _t(case["q"], case["k"], case["v"])
    o, lse = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    _close(o.reshape(B, hq, sq, D)[:, :, live], want[:, :, live])
    got_g = FA.flash_attention_bwd(q, k, v, o, lse,
                                   torch.from_numpy(do), causal=causal,
                                   window=window)
    for a, b in zip(got_g, want_g):
        _close(a, b)
    # the port's oracle is the reference's, dead rows included
    _close(T_ref.attention(q, k, v, causal=causal, window=window), want)
    for a, b in zip(T_ref.attention_grads(q, k, v, torch.from_numpy(do),
                                          causal=causal, window=window),
                    want_g):
        _close(a, b)


@pytest.mark.parametrize("name", ["g3_s40", "window", "sq_lt_sk"])
def test_flash_attention_function_matches_autograd_of_oracle(name):
    """``FlashAttention`` on the CPU (its plain pair) against torch autograd
    of the materialized oracle, under a non-uniform cotangent; the
    cotangent arrives strided (a transposed view) as the trunk's does."""
    B, hq, hkv, sq, sk, causal, window = CASES[name]
    q, k, v, do = _t(*_inputs(B, hq, hkv, sq, sk, 7))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FA.FlashAttention.apply(*leaves, causal, window, None)
    g_strided = do.transpose(2, 3).contiguous().transpose(2, 3)
    got = torch.autograd.grad(out, leaves, g_strided)
    want_out = T_ref.attention(q, k, v, causal=causal, window=window)
    _close(out, want_out)
    for a, b in zip(got, T_ref.attention_grads(q, k, v, do, causal=causal,
                                               window=window)):
        _close(a, b)


def test_ops_routes_by_policy():
    from repro_torch.configs.backend import ExecPolicy

    q, k, v, _ = _t(*_inputs(1, 4, 2, 24, 24, 3))
    want = T_ref.attention(q, k, v)
    for mode in ("ref", "fused", "autodiff"):
        got = ops.flash_attention(q, k, v, policy=ExecPolicy(
            kernel_vjp=mode))
        _close(got, want)
    with pytest.raises(ValueError, match="autodiff"):
        ops.flash_attention(q.requires_grad_(True), k, v,
                            policy=ExecPolicy(kernel_vjp="autodiff"))


def test_wrapper_checks_its_inputs():
    q, k, v, do = _t(*_inputs(1, 4, 2, 24, 24, 3))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        FA.flash_attention_fwd(q, k[:, :1].repeat(1, 3, 1, 1).contiguous(),
                               v[:, :1].repeat(1, 3, 1, 1).contiguous())
    with pytest.raises(TypeError, match="share one of"):
        FA.flash_attention_fwd(q, k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3),
                               k, v)
    o, lse = FA.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse must be"):
        FA.flash_attention_bwd(q, k, v, o, lse[:, :3], do)


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_fwd_route_by_dtype_and_head_dim(dtype, d):
    """K2f's sm90 route takes the 16-bit dtypes at D 64, 112 and 128 (the
    tensor cores) and float32 at every head dim (the CUDA-core kernel);
    only the 16-bit dtypes at D 32 stay on the simt one."""
    want = "sm90" if dtype == torch.float32 or d in (64, 112, 128) \
        else "simt"
    assert FA.route("fwd", dtype, d) == want


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float16, 128),
                                     (torch.float32, 128)])
def test_cpu_forward_takes_plain_version_and_counts_no_launch(dtype, d):
    """On a CPU tensor the wrapper runs the plain forward, whatever route
    its dtype and head dim would take on the card, and counts nothing."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in ((1, 4, 20, d), (1, 2, 20, d),
                                    (1, 2, 20, d)))
    before, routes = dict(FA.launches), dict(FA.fwd_routes)
    o, lse = FA.flash_attention_fwd(q, k, v, window=5)
    po, plse = FA.flash_attention_fwd_plain(q, k, v, window=5)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert FA.launches == before and FA.fwd_routes == routes


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_bwd_route_by_dtype_and_head_dim(dtype, d):
    """K2q's and K2kv's sm90 route takes the 16-bit dtypes at D 64, 112
    and 128 (the tensor cores) and float32 at every head dim (the CUDA-core
    kernels), exactly where K2f's takes them; only the 16-bit dtypes at
    D 32 stay on the simt one."""
    want = "sm90" if dtype == torch.float32 or d in (64, 112, 128) \
        else "simt"
    assert FA.route("dq", dtype, d) == FA.route("dkv", dtype, d) == want
    assert FA.route("fwd", dtype, d) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dq_and_dkv_routes_part_only_at_d112(dtype):
    """The two backward kernels take one route at every head dim, D 112
    included (K2q's tensor-core kernel is built there too), and in 16 bits
    it is K2f's."""
    for d in FA.HEAD_DIMS:
        routes = (FA.route("dq", dtype, d), FA.route("dkv", dtype, d))
        assert routes == (FA.route("fwd", dtype, d),) * 2
    assert FA.route("dq", dtype, 112) == "sm90"
    assert FA.SM90_HEAD_DIMS == (64, 112, 128)


@pytest.mark.parametrize("dtype,d,types", [
    (torch.bfloat16, 112, (torch.bfloat16, torch.bfloat16)),
    (torch.float16, 112, (torch.float16, torch.float16)),
    (torch.bfloat16, 128, (torch.bfloat16, torch.bfloat16)),
    (torch.float16, 64, (torch.float16, torch.float16)),
    (torch.bfloat16, 32, (torch.float32, torch.float32)),
    (torch.float32, 112, (torch.float32, torch.float32))])
def test_bwd_operands_give_each_kernel_do_in_its_route_type(dtype, d, types):
    """``bwd_operands``: delta = Σ_d dO·o_f32 in float32 from the float32
    dO, and the one dO that K2q and K2kv both read, in their shared
    route's type (float32 for simt, the input's type for sm90: 16 bits,
    or float32 for a float32 input),
    contiguous (B·Hq, Sq, D), from a strided cotangent; at 16-bit D 112
    both kernels read the 16-bit dO."""
    rng = np.random.default_rng(d)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    q = f(2, 4, 20, d).to(dtype)
    do = f(2, 4, d, 20).to(dtype).transpose(2, 3)      # strided
    o = f(8, 20, d)
    delta, do_k = FA.bwd_operands(q, o, do)
    assert (do_k.dtype, do_k.dtype) == types
    assert FA.route("dq", dtype, d) == FA.route("dkv", dtype, d)
    assert do_k.shape == (8, 20, d) and do_k.is_contiguous()
    torch.testing.assert_close(do_k, do.reshape(8, 20, d).to(do_k.dtype),
                               rtol=0, atol=0)
    assert delta.dtype == torch.float32
    torch.testing.assert_close(
        delta, (do.float().contiguous().reshape(8, 20, d) * o).sum(-1),
        rtol=0, atol=0)


def _pad128(t):
    """t's last axis zero-padded to 128, as the sm90 kernels store a D 112
    tile (TMA fills columns 112-127 with zeros)."""
    return torch.nn.functional.pad(t, (0, 128 - t.shape[-1]))


@pytest.mark.parametrize("name", ["window", "dead_rows"])
def test_d112_padded_to_128_matches_plain_and_reference(name):
    """The sm90 kernels' arithmetic at D 112: q, k, v (and dO) zero-padded
    to 128 columns, the products taken at 128 with D 112's softmax scale,
    and cut back after them. The padded columns of o, dq, dk and dv come
    out exactly 0 (so the kernels need not store them), and the rest
    equals the plain pair at D 112 and the reference's interpret-mode
    kernels at D 112, forward and gradients."""
    B, hq, hkv, sq, sk, causal, window = CASES[name]
    d = 112
    rng = np.random.default_rng(sq + sk + d)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = f(B, hq, sq, d), f(B, hkv, sk, d), f(B, hkv, sk, d), \
        f(B, hq, sq, d)
    q, k, v, do = _t(*arrays)
    kw = {"causal": causal, "window": window, "scale": d ** -0.5}
    o, lse = FA.flash_attention_fwd_plain(q, k, v, **kw)
    op, lsep = FA.flash_attention_fwd_plain(_pad128(q), _pad128(k),
                                            _pad128(v), **kw)
    assert not op[..., d:].any()
    _close(op[..., :d], o)
    _close(lsep, lse)
    grads = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    padded = FA.flash_attention_bwd_plain(
        _pad128(q), _pad128(k), _pad128(v), _pad128(o), lsep, _pad128(do),
        **kw)
    for a, b in zip(padded, grads):
        assert not a[..., d:].any()
        _close(a[..., :d], b)

    jq, jk, jv, jdo = map(jnp.asarray, arrays)
    _, jo, jlse = R_FA.flash_attention(
        jq, jk, jv, causal=causal, window=window, block_q=BLOCK,
        block_k=BLOCK, interpret=True, return_stats=True)
    _close(op[..., :d], np.asarray(jo))
    _close(lsep, np.asarray(jlse))
    jgrads = R_FA.flash_attention_bwd(
        jq, jk, jv, jo, jlse, jdo, causal=causal, window=window,
        block_q=BLOCK, block_k=BLOCK, interpret=True)
    for a, b in zip(padded, jgrads):
        _close(a[..., :d], np.asarray(b))


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float16, 128),
                                     (torch.float32, 128)])
def test_cpu_backward_takes_plain_version_and_counts_no_launch(dtype, d):
    """On CPU tensors the backward runs the plain version, whatever route
    its dtype and head dim would take on the card, and counts nothing."""
    rng = np.random.default_rng(d + 1)
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        .to(dtype) for s in ((1, 4, 20, d), (1, 2, 20, d), (1, 2, 20, d),
                             (1, 4, 20, d)))
    o, lse = FA.flash_attention_fwd_plain(q, k, v, window=5)
    before, routes = dict(FA.launches), dict(FA.bwd_routes)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, window=5)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, window=5)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
    assert FA.launches == before and FA.bwd_routes == routes


def test_launch_and_route_counters_keep_their_keys():
    assert set(FA.launches) == {"flash_attention_fwd",
                                "flash_attention_bwd_dq",
                                "flash_attention_bwd_dkv"}
    assert set(FA.fwd_routes) == {"sm90", "simt"}
    assert set(FA.bwd_routes) == {"sm90", "simt"}
