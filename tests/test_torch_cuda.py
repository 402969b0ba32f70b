"""The kernels on the card against their plain versions, and the launch
counts: K1 (Triton) against torch autograd too, K4 (CUDA C++, both
routes, every dtype, head dims 32 to 128, split and unsplit contexts)
against both plain versions, through one paged decode step on the sm90
route and its refusal of misaligned pools, K2 (CUDA C++: K2f,
K2q, K2kv) with dead rows, windows and ragged tails, at D = 112 and
through one train step, the tensor-core routes of K2f, K2q and K2kv
(bfloat16, float16 at D 64, 112 and 128; D 112 stored padded to 128, in
a subprocess with a timeout first), the float32 sm90 kernels of K2f, K2q
and K2kv against the plain version and the first version (simt) at D 32
to 128 (the backward bit for bit between two calls), their route counts
and their refusal of misaligned tensors, K3 (CUDA C++: K3f and K3b on
both routes, the sm90 ones also against their emulated roundings) with
ragged tails, clamped chunks, groups and an initial state, through ``SSDScan``
and one mamba train step; the distillation step of DENSE and the
one-shot baselines on K1 against the plain route; the grouped LocalUpdate
engine and the grouped teacher at resnet18's full width against the
per-client loop and the looped ensemble, in full float32. Skips without
a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import distill_kl as K
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as PK

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Triton and CUDA C++ kernels "
                    "run only there")
    return torch.device("cuda")


def _inputs(R, V, dtype, device):
    gen = torch.Generator(device=device).manual_seed(R * 7 + V)
    t = (torch.randn(R, V, generator=gen, device=device) * 3).to(dtype)
    s = (torch.randn(R, V, generator=gen, device=device) * 3).to(dtype)
    return t, s, torch.rand(R, generator=gen, device=device)


@pytest.mark.parametrize("R,V", [(128, 10), (7, 300), (33, 2049)])
def test_kernels_match_plain_versions(cuda, R, V):
    t, s, g = _inputs(R, V, torch.float32, cuda)
    got = K.distill_kl_fwd(t, s)
    torch.cuda.synchronize()
    for a, b in zip(got, K.distill_kl_fwd_plain(t, s)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    kl, lse_t, lse_s = got
    for wtg in (True, False):
        out = K.distill_kl_bwd(t, s, lse_t, lse_s, kl, g,
                               with_teacher_grad=wtg)
        torch.cuda.synchronize()
        want = K.distill_kl_bwd_plain(t, s, lse_t, lse_s, kl, g,
                                      with_teacher_grad=wtg)
        assert (out[0] is None) == (not wtg)
        for a, b in zip(out, want):
            if b is not None:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_autograd_matches_ref_and_counts_launches(cuda):
    t, s, g = _inputs(64, 500, torch.float32, cuda)
    t.requires_grad_(True)
    s.requires_grad_(True)
    before = dict(K.launches)
    kl = ops.distill_kl(t, s)
    dt, ds = torch.autograd.grad(kl, (t, s), g)
    torch.cuda.synchronize()
    assert K.launches["distill_kl_fwd"] == before["distill_kl_fwd"] + 1
    assert K.launches["distill_kl_bwd"] == before["distill_kl_bwd"] + 1
    torch.testing.assert_close(kl, ref.distill_kl(t, s), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip((dt, ds), ref.distill_kl_grads(t, s, g)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _paged_inputs(R, hq, hkv, d, page, m, dtype, device):
    """Pools with a full table per request, ragged seq_lens including 0
    and a full one; the table rows of empty requests on block 0."""
    gen = torch.Generator(device=device).manual_seed(R * 31 + d)
    n_blocks = 1 + R * m
    q = torch.randn(R, hq, d, generator=gen, device=device).to(dtype)
    kp, vp = (torch.randn(n_blocks, page, hkv, d, generator=gen,
                          device=device).to(dtype) for _ in range(2))
    bt = (torch.arange(R * m, dtype=torch.int32, device=device)
          + 1).reshape(R, m)
    seq = torch.randint(1, m * page + 1, (R,), generator=gen, device=device,
                        dtype=torch.int32)
    seq[0], seq[-1] = 0, m * page
    bt[0] = 0
    return q, kp, vp, bt, seq


# (R, Hq, Hkv, D, page, M): the serve shape (8 splits of 4 slots on an
# H100's 132 SMs), small tables, zamba2's D 112 (3 splits of 11: M not a
# multiple), the long shape (9 splits of 29), a page of 8 (3 splits of 8
# over M 20), and G = 8 and 5, which the sm90 route takes in query-head
# groups of 4 and 1
@pytest.mark.parametrize("R,hq,hkv,d,page,m", [
    (8, 24, 8, 128, 16, 32), (5, 4, 2, 32, 8, 4), (3, 8, 8, 64, 4, 7),
    (4, 32, 32, 112, 16, 5), (8, 32, 32, 112, 16, 32),
    (8, 24, 8, 128, 16, 256), (5, 4, 2, 32, 8, 20), (2, 16, 2, 64, 16, 9),
    (3, 5, 1, 64, 16, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("route", ["sm90", "simt"])
def test_paged_attention_kernel_matches_plain_version(cuda, R, hq, hkv, d,
                                                      page, m, dtype, route):
    args = _paged_inputs(R, hq, hkv, d, page, m, dtype, cuda)
    got = PK.paged_attention(*args, route=route)
    torch.cuda.synchronize()
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, pps = PK.split_plan(R, hkv, m, page, n_sm)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for want in (PK.paged_attention_plain(*args),
                 PK.paged_attention_split_plain(*args, pps=pps)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    seq = args[4]
    assert bool((got[seq == 0] == 0).all()) and bool((got[0] == 0).all())
    # a fixed order of sums: the same bits from run to run
    assert torch.equal(got, PK.paged_attention(*args, route=route))


def test_forward_paged_launches_k4_once_per_layer(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import paging
    from repro_torch.models import transformer as T

    cfg = get_smoke_config("llama3.2-3b")
    params = T.init_model(cfg, seed=0, device=cuda)
    pools = paging.init_paged_cache(cfg, max_reqs=3, n_blocks=7, page=4,
                                    device=cuda)
    bt = torch.tensor([[1, 2], [0, 0], [3, 4]], dtype=torch.int32,
                      device=cuda)
    pos = torch.tensor([5, 0, 2], dtype=torch.int32, device=cuda)
    before = PK.launches["paged_attention"]
    with torch.inference_mode():
        logits, _ = T.forward_paged(params, cfg,
                                    tokens=torch.ones((3, 1), dtype=torch.int32,
                                                      device=cuda),
                                    positions=pos, cache=pools,
                                    block_tables=bt)
    torch.cuda.synchronize()
    assert PK.launches["paged_attention"] - before == cfg.n_layers
    assert logits.shape == (3, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def test_forward_paged_takes_sm90_and_misaligned_pools_raise(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import paging
    from repro_torch.models import transformer as T

    cfg = get_smoke_config("llama3.2-3b")
    params = T.init_model(cfg, seed=0, device=cuda)
    pools = paging.init_paged_cache(cfg, max_reqs=3, n_blocks=7, page=4,
                                    device=cuda)
    bt = torch.tensor([[1, 2], [0, 0], [3, 4]], dtype=torch.int32,
                      device=cuda)
    before = dict(PK.routes)
    with torch.inference_mode():
        T.forward_paged(params, cfg,
                        tokens=torch.ones((3, 1), dtype=torch.int32,
                                          device=cuda),
                        positions=torch.tensor([5, 0, 2], dtype=torch.int32,
                                               device=cuda),
                        cache=pools, block_tables=bt)
    torch.cuda.synchronize()
    assert PK.routes["sm90"] - before["sm90"] == cfg.n_layers
    assert PK.routes["simt"] == before["simt"]

    q, kp, vp, bt, seq = _paged_inputs(3, 4, 2, 32, 8, 4, torch.bfloat16,
                                       cuda)
    flat = torch.empty(kp.numel() + 1, dtype=kp.dtype, device=cuda)
    shifted = flat[1:].view(kp.shape)     # contiguous, 2 bytes off
    shifted.copy_(kp)
    with pytest.raises(ValueError, match="16-byte"):
        PK.paged_attention(q, shifted, vp, bt, seq)
    # the first version reads by scalars and takes it
    torch.testing.assert_close(
        PK.paged_attention(q, shifted, vp, bt, seq, route="simt").float(),
        PK.paged_attention_plain(q, kp, vp, bt, seq).float(), rtol=1e-2,
        atol=1e-2)
    with pytest.raises(ValueError, match="unknown K4 route"):
        PK.paged_attention(q, kp, vp, bt, seq, route="tma")


# (B, Hq, Hkv, Sq, Sk, D, causal, window): the server's heads, dead rows
# (causal Sq > Sk), a window, causal=False, ragged tails at every D; then
# cases for the sm90 routes (bfloat16, float16 at D 64 and 128): Sq and
# Sk off their tiles (K2f and K2q: 128 q rows, 128 keys at D 64, 64 at
# D 128; K2kv: 128 keys, 128 q rows at D 64, 64 at D 128), Sq > Sk,
# windows, causal=False, GQA groups of 3 and 4
K2_CASES = [(2, 24, 8, 256, 256, 128, True, 0),
            (1, 3, 1, 100, 37, 32, True, 0),
            (1, 4, 2, 150, 150, 32, True, 20),
            (1, 4, 4, 70, 130, 64, True, 0),
            (1, 4, 2, 50, 90, 64, False, 16),
            (1, 32, 32, 200, 200, 112, True, 0),
            (2, 4, 4, 70, 100, 112, True, 30),
            (1, 6, 2, 200, 333, 128, True, 0),
            (1, 8, 2, 300, 170, 64, True, 0),
            (2, 4, 4, 257, 257, 128, True, 100),
            (1, 6, 2, 129, 75, 64, False, 0),
            (1, 3, 1, 1000, 1000, 64, True, 200),
            (1, 8, 2, 77, 300, 128, False, 50),
            (1, 4, 1, 64, 64, 128, True, 0)]


def _k2_inputs(B, hq, hkv, sq, sk, d, dtype, device):
    gen = torch.Generator(device=device).manual_seed(sq * 7 + sk + d)
    q = torch.randn(B, hq, sq, d, generator=gen, device=device).to(dtype)
    k, v = (torch.randn(B, hkv, sk, d, generator=gen,
                        device=device).to(dtype) for _ in range(2))
    do = torch.randn(B, hq, sq, d, generator=gen, device=device).to(dtype)
    return q, k, v, do


def _assert_fwd_close(o, lse, po, plse, v):
    """K2f's output against the plain version's. Float32 (either route)
    and the simt route compute in float32 and hold o to 1e-4. The 16-bit
    sm90 route rounds P to the input's 16-bit type before the PV product,
    so each o entry may move by Σ p_j ε_j v_j / l with |ε_j| ≤ u (2^-9
    bfloat16, 2^-12 float16), at most u·max|v|: o is held to atol =
    2u·max|v|, rtol = 0. lse comes from float32 scores and a float32 l on
    both routes: 1e-4. Rows with no live key are exact on both."""
    d = o.shape[-1]
    if v.dtype != torch.float32 and FA.route("fwd", v.dtype, d) == "sm90":
        u = 2.0 ** -9 if v.dtype == torch.bfloat16 else 2.0 ** -12
        torch.testing.assert_close(
            o, po, rtol=0, atol=2 * u * float(v.float().abs().max()))
    else:
        torch.testing.assert_close(o, po, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    dead = plse == FA.NEG_INF
    assert bool((lse[dead] == FA.NEG_INF).all())
    assert bool((o[dead] == 0).all())
    return dead


@pytest.mark.parametrize("B,hq,hkv,sq,sk,d,causal,window", K2_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_kernels_match_plain_versions(
        cuda, B, hq, hkv, sq, sk, d, causal, window, dtype):
    """K2f, K2q and K2kv against the plain pair; K2f to the bounds of
    ``_assert_fwd_close``; float32 gradients to 1e-4 (no TF32 in either),
    16-bit gradients, stored in the input dtype, to 1e-2 of each tensor's
    largest entry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _k2_inputs(B, hq, hkv, sq, sk, d, dtype, cuda)
    kw = {"causal": causal, "window": window}
    o, lse = FA.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    po, plse = FA.flash_attention_fwd_plain(q, k, v, **kw)
    dead = _assert_fwd_close(o, lse, po, plse, v)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = FA.flash_attention_bwd_plain(q, k, v, po, plse, do, **kw)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype
        err = (a.float() - b.float()).abs().max()
        assert float(err) <= tol * float(b.float().abs().max())
    assert bool((got[0].reshape(B * hq, sq, d)[dead] == 0).all())


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, "sm90"), (torch.float16, 64, "sm90"),
    (torch.bfloat16, 112, "sm90"), (torch.float32, 128, "sm90"),
    (torch.float16, 112, "sm90"), (torch.float32, 112, "sm90"),
    (torch.float32, 32, "sm90"), (torch.bfloat16, 32, "simt")])
def test_flash_attention_fwd_counts_its_route(cuda, dtype, d, route):
    """One K2f launch counts once in ``launches`` and once under its route
    in ``fwd_routes``."""
    q, k, v, _ = _k2_inputs(1, 4, 2, 70, 70, d, dtype, cuda)
    before, routes = dict(FA.launches), dict(FA.fwd_routes)
    FA.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in FA.launches.items()} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkv": 0}
    assert {n: c - routes[n] for n, c in FA.fwd_routes.items()} == {
        "sm90": int(route == "sm90"), "simt": int(route == "simt")}


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, ("sm90", "sm90")),
    (torch.float16, 64, ("sm90", "sm90")),
    (torch.bfloat16, 112, ("sm90", "sm90")),
    (torch.float32, 128, ("sm90", "sm90")),
    (torch.float16, 112, ("sm90", "sm90")),
    (torch.bfloat16, 32, ("simt", "simt"))])
def test_flash_attention_bwd_counts_its_route(cuda, dtype, d, route):
    """One backward launches K2q and K2kv once each, each counting once in
    ``launches``, once under its own route (``route``: K2q's, K2kv's) in
    ``bwd_routes`` and once in its own ``dq_routes`` or ``dkv_routes``."""
    q, k, v, do = _k2_inputs(1, 4, 2, 70, 70, d, dtype, cuda)
    o, lse = FA.flash_attention_fwd(q, k, v)
    before, routes = dict(FA.launches), dict(FA.bwd_routes)
    dq, dkv = dict(FA.dq_routes), dict(FA.dkv_routes)
    FA.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in FA.launches.items()} == {
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1}
    assert {n: c - routes[n] for n, c in FA.bwd_routes.items()} == {
        r: route.count(r) for r in ("sm90", "simt")}
    for counts, old, r in ((FA.dq_routes, dq, route[0]),
                           (FA.dkv_routes, dkv, route[1])):
        assert {n: c - old[n] for n, c in counts.items()} == {
            "sm90": int(r == "sm90"), "simt": int(r == "simt")}


# D 112 on the sm90 routes of K2f, K2q and K2kv (B, Hq, Hkv, Sq, Sk, causal,
# window): zamba2-7b's shared block at its train batch, Sq > Sk (dead rows)
# with a window and GQA groups of 4, not causal with Sq < Sk, ragged tails
# past 128 and past 64, not causal with a window and Sq > Sk
K2_D112_CASES = [(2, 32, 32, 512, 512, True, 0),
                 (1, 8, 2, 301, 230, True, 90),
                 (1, 4, 1, 200, 333, False, 0),
                 (2, 4, 4, 129, 129, True, 0),
                 (1, 4, 1, 65, 65, True, 0),
                 (1, 8, 2, 190, 100, False, 40)]

_D112_SCRIPT = """
import torch
from repro_torch.kernels import flash_attention as FA
for dtype in (torch.bfloat16, torch.float16):
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(1, 8, 301, 112, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(1, 2, 230, 112, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    o, lse = FA.flash_attention_fwd(q, k, v, window=90)
    dq, dk, dv = FA.flash_attention_bwd(q, k, v, o, lse, torch.ones_like(q),
                                        window=90)
    torch.cuda.synchronize()
assert FA.fwd_routes["sm90"] == 2 and FA.bwd_routes == {"sm90": 4, "simt": 0}
print("done")
"""


def test_flash_attention_d112_sm90_finishes_in_a_subprocess(cuda):
    """The D 112 kernels' stages expect the whole TMA box, zero-filled
    columns 112-127 included; a wrong count hangs the kernel instead of
    failing it. So one forward and one backward (K2q and K2kv) at D 112,
    bfloat16 and float16, run first in a subprocess that must finish
    within 600 s (a first build of the kernels included)."""
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    done = subprocess.run([sys.executable, "-c", _D112_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0 and "done" in done.stdout, done.stderr


@pytest.mark.parametrize("B,hq,hkv,sq,sk,causal,window", K2_D112_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_d112_sm90_matches_plain_versions(
        cuda, B, hq, hkv, sq, sk, causal, window, dtype):
    """K2f, K2q and K2kv at D 112 on their sm90 routes against the plain
    pair, as ``chip_smoke.py``'s TOL_K2 holds them: o to 2u·max|v|, lse
    to 1e-4, dq, dk and dv to 1e-2 of each tensor's largest entry, dq
    exactly 0 on dead rows. Whole tensors are compared, so a store past
    column 111 (into the next row's first 16 columns) shows."""
    d = 112
    q, k, v, do = _k2_inputs(B, hq, hkv, sq, sk, d, dtype, cuda)
    kw = {"causal": causal, "window": window}
    before, fwd, bwd = dict(FA.launches), dict(FA.fwd_routes), \
        dict(FA.bwd_routes)
    o, lse = FA.flash_attention_fwd(q, k, v, **kw)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert {n: c - fwd[n] for n, c in FA.fwd_routes.items()} == {
        "sm90": 1, "simt": 0}
    assert {n: c - bwd[n] for n, c in FA.bwd_routes.items()} == {
        "sm90": 2, "simt": 0}
    assert {n: c - before[n] for n, c in FA.launches.items()} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1}
    po, plse = FA.flash_attention_fwd_plain(q, k, v, **kw)
    assert o.shape == po.shape == (B * hq, sq, d)
    dead = _assert_fwd_close(o, lse, po, plse, v)
    want = FA.flash_attention_bwd_plain(q, k, v, po, plse, do, **kw)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        err = (a.float() - b.float()).abs().max()
        assert float(err) <= 1e-2 * float(b.float().abs().max())
    assert bool((got[0].reshape(B * hq, sq, d)[dead] == 0).all())


def test_flash_attention_d112_dq_has_no_sm90_kernel(cuda):
    """K2q at D 112 has its tensor-core kernel: the wrapper's own route is
    sm90, it reads the 16-bit dO, and one call counts one sm90 launch (and
    the simt route, named, one simt launch) with the same dq to 1e-2."""
    q, k, v, do = _k2_inputs(1, 4, 2, 70, 70, 112, torch.bfloat16, cuda)
    o, lse = FA.flash_attention_fwd(q, k, v)
    delta, do_k = FA.bwd_operands(q, o, do)
    assert do_k.dtype == torch.bfloat16
    before, routes = dict(FA.launches), dict(FA.bwd_routes)
    dq = FA.flash_attention_bwd_dq(q, k, v, do_k, lse, delta)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in FA.launches.items()} == {
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 0}
    assert {n: c - routes[n] for n, c in FA.bwd_routes.items()} == {
        "sm90": 1, "simt": 0}
    first = FA.flash_attention_bwd_dq(q, k, v, do_k, lse, delta,
                                      route="simt")
    torch.cuda.synchronize()
    assert FA.bwd_routes["simt"] == routes["simt"] + 1
    err = (dq.float() - first.float()).abs().max()
    assert float(err) <= 1e-2 * float(first.float().abs().max())


# The float32 sm90 kernels (B, Hq, Hkv, Sq, Sk, D, causal, window): every
# head dim, the server's heads, dead rows (causal Sq > Sk) with a window
# and GQA, zamba2's d112 and its ragged shape, Sq and Sk off the 128-row
# q-blocks (K2f) and the 64-row tiles (K2q, K2kv), causal=False with and
# without a window; K2kv's grids under one wave take clusters of 2 to 8
# CTAs a key block (8 at D 112 and, in the last case, D 128)
K2_F32_CASES = [(2, 24, 8, 256, 256, 128, True, 0),
                (1, 3, 1, 100, 37, 32, True, 0),
                (2, 4, 2, 300, 200, 32, True, 64),
                (1, 8, 2, 333, 250, 64, True, 100),
                (1, 4, 4, 70, 130, 64, True, 0),
                (2, 32, 32, 512, 512, 112, True, 0),
                (1, 8, 2, 301, 230, 112, True, 90),
                (1, 6, 2, 129, 75, 128, False, 0),
                (1, 8, 2, 77, 300, 128, False, 50),
                (1, 6, 2, 1000, 300, 128, False, 0)]


@pytest.mark.parametrize("B,hq,hkv,sq,sk,d,causal,window", K2_F32_CASES)
def test_flash_attention_f32_fwd_sm90_matches_plain_and_first_version(
        cuda, B, hq, hkv, sq, sk, d, causal, window):
    """K2f in float32 takes its sm90 kernel (one launch, counted on sm90)
    and agrees with the plain version and with the first version (simt)
    to 1e-4, dead rows exactly (o = 0, lse = NEG_INF)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _ = _k2_inputs(B, hq, hkv, sq, sk, d, torch.float32, cuda)
    kw = {"causal": causal, "window": window}
    routes = dict(FA.fwd_routes)
    o, lse = FA.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {n: c - routes[n] for n, c in FA.fwd_routes.items()} == {
        "sm90": 1, "simt": 0}
    po, plse = FA.flash_attention_fwd_plain(q, k, v, **kw)
    dead = _assert_fwd_close(o, lse, po, plse, v)
    so, slse = FA._fwd_launch(q, k, v, causal, window, d ** -0.5, "simt")
    torch.cuda.synchronize()
    torch.testing.assert_close(o, so, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, slse, rtol=1e-4, atol=1e-4)
    assert bool((slse[dead] == FA.NEG_INF).all())


@pytest.mark.parametrize("B,hq,hkv,sq,sk,d,causal,window", K2_F32_CASES)
def test_flash_attention_f32_bwd_sm90_matches_plain_and_first_version(
        cuda, B, hq, hkv, sq, sk, d, causal, window):
    """K2q and K2kv in float32 take their sm90 kernels (one launch each,
    counted on sm90) and agree with the plain version and with the first
    version (simt, on the same dO, lse and delta) to 1e-4 of each
    tensor's largest entry; dq is exactly 0 on dead rows, and a second
    call gives the same bits (no atomics: K2kv sums each GQA group in a
    fixed order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _k2_inputs(B, hq, hkv, sq, sk, d, torch.float32, cuda)
    kw = {"causal": causal, "window": window}
    o, lse = FA.flash_attention_fwd(q, k, v, **kw)
    before = dict(FA.launches)
    dq_r, dkv_r = dict(FA.dq_routes), dict(FA.dkv_routes)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in FA.launches.items()} == {
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1}
    for counts, old in ((FA.dq_routes, dq_r), (FA.dkv_routes, dkv_r)):
        assert {n: c - old[n] for n, c in counts.items()} == {
            "sm90": 1, "simt": 0}
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    delta, do_k = FA.bwd_operands(q, o, do)
    first = (FA.flash_attention_bwd_dq(q, k, v, do_k, lse, delta,
                                       route="simt", **kw),
             *FA.flash_attention_bwd_dkv(q, k, v, do_k, lse, delta,
                                         route="simt", **kw))
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for a, b, c, e in zip(got, want, first, again):
        assert a.dtype == torch.float32 and a.shape == b.shape
        top = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * top
        assert float((a - c).abs().max()) <= 1e-4 * top
        assert torch.equal(a, e)
    dead = lse == FA.NEG_INF
    assert bool((got[0].reshape(B * hq, sq, d)[dead] == 0).all())


@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_sm90_bwd_raises_on_misaligned_tensors(cuda, which,
                                                               dtype):
    """The sm90 backward reads q, k, v and dO by TMA (16 bits) or 16-byte
    cp.async (float32): a contiguous view one element into its storage is
    refused before any launch, never sent to the simt kernels."""
    t = dict(zip("q k v do".split(),
                 _k2_inputs(1, 4, 2, 70, 70, 64, dtype, cuda)))
    o, lse = FA.flash_attention_fwd(t["q"], t["k"], t["v"])
    buf = torch.empty(t[which].numel() + 1, dtype=dtype, device=cuda)
    t[which] = buf[1:].view(t[which].shape).copy_(t[which])
    before, routes = dict(FA.launches), dict(FA.bwd_routes)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_attention_bwd(t["q"], t["k"], t["v"], o, lse, t["do"])
    assert FA.launches == before and FA.bwd_routes == routes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_sm90_raises_on_misaligned_tensors(cuda, dtype):
    """TMA (16 bits) and 16-byte cp.async (float32) need 16-byte aligned
    bases: a contiguous view one element into its storage is refused
    before any launch, never sent elsewhere."""
    q, k, v, _ = _k2_inputs(1, 4, 2, 70, 70, 64, dtype, cuda)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    q_off = buf[1:].view(q.shape).copy_(q)
    before = dict(FA.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_attention_fwd(q_off, k, v)
    assert FA.launches == before


def test_train_step_launches_k2_per_layer(cuda):
    """One train step with remat: K2f twice a layer (the forward and its
    recomputation), K2q and K2kv once."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps as ST

    cfg = get_smoke_config("llama3.2-3b").replace(remat=True)
    state = ST.make_train_state(cfg, device=cuda)
    x = torch.randint(0, cfg.vocab_size, (2, 17), device=cuda)
    before = dict(FA.launches)
    state, m = ST.make_train_step(cfg)(state, {"tokens": x[:, :-1],
                                               "labels": x[:, 1:]})
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in FA.launches.items()}
    L = cfg.n_layers
    assert got == {"flash_attention_fwd": 2 * L,
                   "flash_attention_bwd_dq": L,
                   "flash_attention_bwd_dkv": L}
    assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0


@pytest.mark.parametrize("kind", ["cnn1", "resnet18"])
def test_distill_step_on_k1_matches_the_plain_route(cuda, kind):
    """The baselines' (and DENSE's) distillation step on the card: K1f
    and K1b once each, the same loss and student update as the plain
    ``ref`` KL on the same card, from the same weights and images."""
    from repro_torch import optim
    from repro_torch.configs import DenseExperimentConfig
    from repro_torch.core import Client, make_distill_step
    from repro_torch.models import CNNSpec, cnn_init

    spec = CNNSpec(kind=kind, num_classes=10, width=0.25, image_size=32)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand((128, 32, 32, 3), generator=gen, device=cuda) * 2 - 1
    out = {}
    for mode in ("fused", "ref"):
        init = torch.Generator().manual_seed(0)
        clients = [Client(spec=spec, model=cnn_init(spec, generator=init,
                                                    device=cuda))
                   for _ in range(3)]
        student = cnn_init(spec, generator=init, device=cuda)
        scfg = DenseExperimentConfig(
            distill_kl_mode=None if mode == "fused" else "ref")
        step = make_distill_step(clients, scfg, device=cuda)
        opt = optim.sgd(list(student.parameters()), scfg.s_lr,
                        momentum=scfg.s_momentum)
        before = dict(K.launches)
        loss = step(student, opt, x)
        torch.cuda.synchronize()
        out[mode] = (float(loss), [t.clone() for t in
                                   student.state_dict().values()],
                     {k: v - before[k] for k, v in K.launches.items()})
    assert out["fused"][2] == {"distill_kl_fwd": 1, "distill_kl_bwd": 1}
    assert out["ref"][2] == {"distill_kl_fwd": 0, "distill_kl_bwd": 0}
    assert out["fused"][0] == pytest.approx(out["ref"][0], rel=1e-4)
    for a, b in zip(out["fused"][1], out["ref"][1], strict=True):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.fixture
def ieee_fp32(cuda):
    """Convolutions and matrix products in full float32 (no TF32) for the
    test, as ``chip_smoke.py``'s ``full_float32`` sets them; restored
    after."""
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is None:
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        yield cuda
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
        return
    saved = (torch.backends.fp32_precision,
             torch.backends.cuda.matmul.fp32_precision,
             torch.backends.cudnn.fp32_precision, conv.fp32_precision)
    torch.backends.fp32_precision = "ieee"
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.fp32_precision = "ieee"
    conv.fp32_precision = "ieee"
    yield cuda
    (torch.backends.fp32_precision, torch.backends.cuda.matmul.fp32_precision,
     torch.backends.cudnn.fp32_precision, conv.fp32_precision) = saved


RESNET18 = dict(kind="resnet18", num_classes=10, width=1.0, image_size=32)


def test_grouped_engine_matches_per_client_at_resnet18_width(ieee_fp32):
    """Two resnet18 clients at full width, ragged shards (300 and 200 at
    batch 128, one epoch: a partial batch and a padding step): the
    grouped engine's params and running statistics against the
    per-client loop's from the same inits, to 1e-3: a few SGD steps
    amplify float32 roundoff. ``chip_smoke.py``'s grouped_check holds
    the same limit and reads both sides of it on every run: on an H100
    the loop itself moves by up to 2.7e-4 when its inits move by one
    ulp, and a dropped step, lost momentum or counted padding rows read
    3.0e-3 or more."""
    import numpy as np

    from repro_torch.data import build_batch_plan, pad_shards
    from repro_torch.fl import local_update, local_update_grouped
    from repro_torch.models import CNNSpec, cnn_init, stack_models

    dev = ieee_fp32
    spec = CNNSpec(**RESNET18)
    rng = np.random.default_rng(0)
    shards = [(rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32),
               rng.integers(0, 10, n)) for n in (300, 200)]
    init = torch.Generator().manual_seed(0)
    models = [cnn_init(spec, generator=init, device=dev) for _ in range(2)]
    stacked = stack_models(models)
    for model, (x, y), seed in zip(models, shards, (5, 6)):
        local_update(model, x, y, epochs=1, batch_size=128, seed=seed)
    xs, ys = pad_shards(shards)
    plan = build_batch_plan([300, 200], 128, epochs=1, seeds=[5, 6])
    _, info = local_update_grouped(stacked, spec, xs, ys, plan)
    torch.cuda.synchronize()
    assert info["loss"].shape == (3, 2) and float(info["loss"][2, 1]) == 0
    for j, model in enumerate(models):
        for name, want in model.net.state_dict().items():
            torch.testing.assert_close(stacked[name][j].detach(), want,
                                       rtol=1e-3, atol=1e-3)


def test_grouped_teacher_matches_looped_at_resnet18_width(ieee_fp32):
    """Three resnet18 clients at full width on a generator-sized batch
    (128, 32, 32, 3): the grouped teacher's logits, L_BN and image
    gradient with stats, and its folded-BN logits without, against the
    looped ensemble, to 1e-4 (relative to the largest entry)."""
    from repro_torch.core import (Client, bn_loss, ensemble_logits,
                                  grouped_teacher)
    from repro_torch.models import CNNSpec, cnn_apply, cnn_init

    dev = ieee_fp32
    spec = CNNSpec(**RESNET18)
    init = torch.Generator().manual_seed(1)
    gen = torch.Generator(device=dev).manual_seed(2)
    warm = torch.rand((128, 32, 32, 3), generator=gen, device=dev) * 2 - 1
    models = [cnn_init(spec, generator=init, device=dev) for _ in range(3)]
    with torch.no_grad():
        for model in models:
            cnn_apply(model, warm, train=True)
    teacher = grouped_teacher([Client(spec=spec, model=m) for m in models])
    x0 = torch.rand((128, 32, 32, 3), generator=gen, device=dev) * 2 - 1
    out = []
    for fn in (teacher, lambda x, **kw: ensemble_logits(models, x, **kw)):
        x = x0.clone().requires_grad_(True)
        avg, stats = fn(x, with_bn_stats=True)
        l_bn = bn_loss(stats)
        (grad,) = torch.autograd.grad(avg.square().mean() + l_bn, [x])
        with torch.no_grad():
            folded = fn(x0)
        out.append((avg.detach(), l_bn.detach(), grad, folded))
    for a, b in zip(out[0], out[1]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


# (B, S, H, P, G, N, chunk): mamba2-130m's heads at a train shape, zamba2's
# at a ragged prefill (tail 44) and at a full one, groups with a ragged
# tail, a chunk clamped into S (37, and 100 at zamba2's widths), a chunk of
# 48 with groups. K3f and K3b take their sm90 route at P 64, N 64/128, in
# every dtype.
K3_CASES = [(2, 256, 24, 64, 1, 128, 256),
            (1, 300, 16, 64, 1, 64, 256),
            (1, 448, 112, 64, 1, 64, 256),
            (2, 300, 4, 32, 2, 16, 64),
            (1, 37, 2, 16, 1, 8, 64),
            (1, 100, 8, 64, 1, 64, 256),
            (1, 130, 4, 64, 2, 128, 48)]


def _ssd_inputs(B, S, H, P, G, N, dtype, device, dt_dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(S * 13 + H + N)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    x = r(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(r(B, S, H) - 1.0).to(dt_dtype)
    a = -torch.exp(r(H) * 0.3)
    b, c = ((r(B, S, G, N) * 0.3).to(dtype) for _ in range(2))
    s0 = r(B, H, P, N) * 0.5
    dy = r(B, S, H, P)
    dfin = r(B, H, P, N)
    return x, dt, a, b, c, s0, dy, dfin


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("B,S,H,P,G,N,cl", K3_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_ssd_scan_kernels_match_plain_versions(cuda, B, S, H, P, G, N, cl,
                                               dtype):
    """K3f and K3b's first version (route ``simt``) against the plain pair
    from the same inputs and initial state; float32 to 1e-4 and 16 bits
    (y stored in 16 bits) to 1e-2 of each tensor's largest entry; the
    states and the simt route's gradients are float32 on both sides
    (1e-4), K3b reading the forward's states. Where K3f takes its sm90
    route (P 64, N 64/128, float32 included): one count on it, two calls
    bit for bit, no initial state and dt in x's type held the same way.
    K3b's sm90 route: the next test."""
    from repro_torch.kernels import ssd_scan as K3

    torch.backends.cuda.matmul.allow_tf32 = False
    x, dt, a, b, c, s0, dy, dfin = _ssd_inputs(B, S, H, P, G, N, dtype, cuda)
    route = K3.fwd_route(dtype, P, N)
    before = dict(K3.fwd_routes)
    y, fin, st = K3.ssd_scan_fwd(x, dt, a, b, c, s0, chunk=cl,
                                 return_chunk_states=True)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in K3.fwd_routes.items()} == {
        r: int(r == route) for r in ("sm90", "simt")}
    assert route == ("simt" if P != 64 or N not in (64, 128) else "sm90")
    assert K3.bwd_route(dtype, P, N) == route
    py, pfin, pst = K3.ssd_scan_fwd_plain(x, dt, a, b, c, s0, chunk=cl)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert y.dtype == dtype and _rel(y, py) <= tol
    assert _rel(fin, pfin) <= 1e-4 and _rel(st, pst) <= 1e-4
    before = dict(K3.bwd_routes)
    got = K3.ssd_scan_bwd(x, dt, a, b, c, st, dy, dfin, chunk=cl,
                          route="simt")
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in K3.bwd_routes.items()} == {
        "sm90": 0, "simt": 1}
    want = K3.ssd_scan_bwd_plain(x, dt, a, b, c, pst, dy, dfin, chunk=cl)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) <= 1e-4
    if route != "sm90":
        return
    again = K3.ssd_scan_fwd(x, dt, a, b, c, s0, chunk=cl,
                            return_chunk_states=True)
    assert all(torch.equal(u, v) for u, v in zip(again, (y, fin, st)))
    for s_in, d in ((None, dt), (s0, dt.to(dtype))):
        y2, fin2 = K3.ssd_scan_fwd(x, d, a, b, c, s_in, chunk=cl)
        py2, pfin2, _ = K3.ssd_scan_fwd_plain(x, d, a, b, c, s_in, chunk=cl)
        assert _rel(y2, py2) <= tol and _rel(fin2, pfin2) <= 1e-4


# K3b's sm90 route against the chunked plain version with its rounding
# points emulated: the same arithmetic, so closer than the 1e-2 the
# 16-bit roundings allow against float32 (sums in another order, and a
# value the kernel and the emulation round to neighbouring 16-bit numbers)
TOL_K3B_EMULATED = {torch.bfloat16: 2e-3, torch.float16: 5e-4}


@pytest.mark.parametrize("B,S,H,P,G,N,cl", [k for k in K3_CASES
                                            if k[3] == 64
                                            and k[5] in (64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_ssd_scan_bwd_sm90_matches_plain_versions(cuda, B, S, H, P, G, N,
                                                  cl, dtype):
    """K3b's sm90 route (P 64, N 64/128) from the forward's states: one
    count on it. In 16 bits dx, ddt, da, db and dc within 1e-2 of each
    largest entry of the float32 plain (autograd), d(initial_state) within
    1e-4, all within TOL_K3B_EMULATED of ``ssd_scan_bwd_chunked_plain``
    with the route's roundings; in float32 (CUDA cores, exact) all six
    within 1e-4 of the plain, with no emulated comparison (the chunked
    plain version is then the float32 oracle's arithmetic itself). Two
    calls bit for bit; a float32 dy (read rounded to x's type) gives what
    dy in x's type gives, bit for bit; dt in x's type held the same
    way."""
    from repro_torch.kernels import ssd_scan as K3

    x, dt, a, b, c, s0, dy32, dfin = _ssd_inputs(B, S, H, P, G, N, dtype,
                                                 cuda)
    dy = dy32.to(dtype)
    _, _, st = K3.ssd_scan_fwd(x, dt, a, b, c, s0, chunk=cl,
                               return_chunk_states=True)
    before = dict(K3.bwd_routes)
    got = K3.ssd_scan_bwd(x, dt, a, b, c, st, dy, dfin, chunk=cl)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in K3.bwd_routes.items()} == {
        "sm90": 1, "simt": 0}
    want = K3.ssd_scan_bwd_plain(x, dt, a, b, c, st, dy, dfin, chunk=cl)
    f32 = dtype == torch.float32
    tol = [1e-4] * 6 if f32 else [1e-2] * 5 + [1e-4]
    emul = None if f32 else K3.ssd_scan_bwd_chunked_plain(
        x, dt, a, b, c, st, dy, dfin, chunk=cl, emulate=dtype)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) <= tol[i], i
        if emul is not None:
            assert _rel(g, emul[i]) <= TOL_K3B_EMULATED[dtype], i
    for again in (K3.ssd_scan_bwd(x, dt, a, b, c, st, dy, dfin, chunk=cl),
                  K3.ssd_scan_bwd(x, dt, a, b, c, st, dy32, dfin,
                                  chunk=cl)):
        assert all(torch.equal(u, v) for u, v in zip(again, got))
    d16 = dt.to(dtype)
    got16 = K3.ssd_scan_bwd(x, d16, a, b, c, st, dy, dfin, chunk=cl)
    want16 = K3.ssd_scan_bwd_plain(x, d16, a, b, c, st, dy, dfin, chunk=cl)
    for i, (g, w) in enumerate(zip(got16, want16)):
        assert _rel(g, w) <= tol[i], i


def test_ssd_scan_sm90_raises_on_misaligned_tensors(cuda):
    """The sm90 routes move 16 bytes at a time: an x (K3f) or a dy (K3b)
    whose base is not 16-byte aligned is refused before a launch, and
    nothing is counted."""
    from repro_torch.kernels import ssd_scan as K3

    x, dt, a, b, c, s0, dy, dfin = _ssd_inputs(1, 64, 2, 64, 1, 64,
                                               torch.bfloat16, cuda)

    def odd(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    before = dict(K3.fwd_routes)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K3.ssd_scan_fwd(odd(x), dt, a, b, c, s0, chunk=64)
    assert K3.fwd_routes == before
    _, _, st = K3.ssd_scan_fwd(x, dt, a, b, c, s0, chunk=64,
                               return_chunk_states=True)
    before = (dict(K3.bwd_routes), dict(K3.launches))
    with pytest.raises(ValueError, match="16-byte aligned"):
        K3.ssd_scan_bwd(x, dt, a, b, c, st, odd(dy.to(x.dtype)), dfin,
                        chunk=64)
    assert (K3.bwd_routes, K3.launches) == before


@pytest.mark.parametrize("B,S,H,P,G,N,route,dtype",
                         [(1, 70, 4, 16, 2, 8, "simt", torch.bfloat16),
                          (1, 130, 4, 64, 2, 64, "sm90", torch.bfloat16),
                          (1, 130, 4, 64, 2, 128, "sm90", torch.float32)])
def test_ssd_scan_autograd_and_launches(cuda, B, S, H, P, G, N, route,
                                        dtype):
    """SSDScan with dt in x's dtype: one K3f and one K3b launch, each on
    its route (the dy the autograd hands K3b read as it is), the
    gradients in the inputs' dtypes, against ``ref.ssd_grads`` (the
    sequential recurrence) in float32 to 2e-2 of the largest entry in
    bfloat16, 1e-4 in float32."""
    from repro_torch.kernels import ssd_scan as K3

    x, dt, a, b, c, s0, dy, dfin = _ssd_inputs(B, S, H, P, G, N, dtype,
                                               cuda, dt_dtype=dtype)
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, a, b, c, s0)]
    before = (dict(K3.launches), dict(K3.fwd_routes), dict(K3.bwd_routes))
    y, fin = K3.SSDScan.apply(*leaves, 32)
    grads = torch.autograd.grad((y, fin), leaves, (dy.to(y.dtype), dfin))
    torch.cuda.synchronize()
    assert {k: v - before[0][k] for k, v in K3.launches.items()} == {
        "ssd_scan_fwd": 1, "ssd_scan_bwd": 1}
    for counts, old in zip((K3.fwd_routes, K3.bwd_routes), before[1:]):
        assert {k: v - old[k] for k, v in counts.items()} == {
            r: int(r == route) for r in ("sm90", "simt")}
    want = ref.ssd_grads(*(t.float() for t in (x, dt, a, b, c, s0)),
                         dy.to(dtype).float(), dfin)
    for g, w, t in zip(grads, want, leaves):
        assert g.dtype == t.dtype
        assert _rel(g, w) <= (1e-4 if dtype == torch.float32 else 2e-2)


def test_ssm_train_step_launches_k3_per_block(cuda):
    """One mamba2 train step with remat: K3f twice a block (the forward and
    its recomputation), K3b once, all on the route the widths choose (simt
    at the float32 smoke widths; sm90 at P 64, N 64, in bfloat16 and in
    float32); a zamba2 step adds K2 for each application of its shared
    block."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.launch import steps as ST

    for arch, n_attn, widths in (
            ("mamba2-130m", 0, {}), ("zamba2-7b", 2, {}),
            ("mamba2-130m", 0, dict(dtype="bfloat16", ssm_head_dim=64,
                                    ssm_state=64)),
            ("mamba2-130m", 0, dict(dtype="float32", ssm_head_dim=64,
                                    ssm_state=64))):
        cfg = get_smoke_config(arch).replace(remat=True, **widths)
        route = K3.fwd_route(getattr(torch, cfg.dtype), cfg.ssm_head_dim,
                             cfg.ssm_state)
        assert route == ("sm90" if widths else "simt")
        state = ST.make_train_state(cfg, device=cuda)
        x = torch.randint(0, cfg.vocab_size, (2, 41), device=cuda)
        before = {**K3.launches, **FA.launches}
        routes = (dict(K3.fwd_routes), dict(K3.bwd_routes))
        state, m = ST.make_train_step(cfg)(state, {"tokens": x[:, :-1],
                                                   "labels": x[:, 1:]})
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in {**K3.launches,
                                             **FA.launches}.items()}
        L = cfg.n_layers
        assert got == {"ssd_scan_fwd": 2 * L, "ssd_scan_bwd": L,
                       "flash_attention_fwd": 2 * n_attn,
                       "flash_attention_bwd_dq": n_attn,
                       "flash_attention_bwd_dkv": n_attn}
        for counts, old, n in zip((K3.fwd_routes, K3.bwd_routes), routes,
                                  (2 * L, L)):
            assert {k: v - old[k] for k, v in counts.items()} == {
                r: n * (r == route) for r in ("sm90", "simt")}
        assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_guarded_steps_equal_unguarded_on_the_card(cuda, name):
    """``step_if`` (nan_policy="skip"'s guarded update) gives ``step``'s
    values bit for bit where the guard passes, on the card too, where a
    tensor divided by a host float is multiplied by its reciprocal; where
    the guard fails nothing moves, Adam's count included."""
    from repro_torch import optim

    gen = torch.Generator(device=cuda).manual_seed(0)
    params = [torch.randn(1000, 37, device=cuda, generator=gen)
              for _ in range(3)]

    def make(ps):
        return optim.adam(ps, 1e-3) if name == "adam" else \
            optim.sgd(ps, 0.1, momentum=0.9)

    p1, p2 = [p.clone() for p in params], [p.clone() for p in params]
    o1, o2 = make(p1), make(p2)
    yes = torch.tensor(True, device=cuda)
    for _ in range(200):
        grads = [torch.randn(p.shape, device=cuda, generator=gen)
                 for p in params]
        o1.step(grads)
        o2.step_if(grads, yes)
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
    before = [p.clone() for p in p2]
    o2.step_if([torch.full_like(p, float("nan")) for p in p2],
               torch.tensor(False, device=cuda))
    for a, b in zip(p2, before):
        assert torch.equal(a, b)
    if name == "adam":
        assert o2.count() == 200


def _smoke_server(cuda, **kw):
    """A smoke federation (3 cnn1 clients, 8x8 images) on the card and a
    server config over it, with ``kw`` set."""
    import dataclasses

    from repro_torch.configs import smoke
    from repro_torch.data import make_classification_data
    from repro_torch.fl import build_federation

    scfg = dataclasses.replace(smoke(), **{
        **dict(image_size=8, local_epochs=1, train_per_class=16,
               test_per_class=4, t_g=3, epochs=3, synth_batch=32), **kw})
    data = make_classification_data(0, num_classes=scfg.num_classes,
                                    size=scfg.image_size, ch=scfg.in_ch,
                                    train_per_class=scfg.train_per_class,
                                    test_per_class=scfg.test_per_class)
    clients, _ = build_federation(scfg, data, device=cuda)
    return scfg, clients


def test_fused_graph_replay_equals_eager(ieee_fp32):
    """Three smoke epochs on the fused driver (the first eager, two
    replays of the captured epoch) against the python driver from the
    same seeds, with cuDNN's and PyTorch's deterministic algorithms: the
    student, the generator and every loss bit for bit."""
    import dataclasses

    from repro_torch.core import train_dense_server

    scfg, clients = _smoke_server(ieee_fp32, loop_chunk=2)
    flags = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out = {loop: train_dense_server(
            clients, dataclasses.replace(scfg, loop_mode=loop),
            device=ieee_fp32) for loop in ("python", "fused")}
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.use_deterministic_algorithms(flags[1], warn_only=flags[2])
    (s1, g1, h1), (s2, g2, h2) = out["python"], out["fused"]
    assert (h1.loop, h2.loop) == ("python", "fused")
    assert h2.graph_replays == 2 and h2.host_reads == 2
    for a, b in zip([*s1.state_dict().values(), *g1.state_dict().values()],
                    [*s2.state_dict().values(), *g2.state_dict().values()]):
        assert torch.equal(a, b)
    assert (h1.gen_loss, h1.gen_parts, h1.dis_loss) == \
        (h2.gen_loss, h2.gen_parts, h2.dis_loss)


def test_k1_launch_counts_under_replay(ieee_fp32):
    """The launch counters count what the card executes: the eager epoch
    and every replay, not the capture: epochs·(t_g + s_steps) of K1f and
    K1b over a fused run, and nothing else."""
    from repro_torch import kernels
    from repro_torch.core import train_dense_server

    scfg, clients = _smoke_server(ieee_fp32, loop_mode="fused", epochs=4,
                                  loop_chunk=3)
    before = [dict(c) for c in kernels.counters()]
    _, _, hist = train_dense_server(clients, scfg, device=ieee_fp32)
    torch.cuda.synchronize()
    got = {k: v - b[k] for c, b in zip(kernels.counters(), before)
           for k, v in c.items() if v != b[k]}
    n = scfg.epochs * (scfg.t_g + scfg.s_steps)
    assert got == {"distill_kl_fwd": n, "distill_kl_bwd": n}
    assert hist.graph_replays == scfg.epochs - 1 and hist.host_reads == 2
    assert hist.capture_seconds > 0


def test_quickstart_round_is_full_float32_bit_for_bit(cuda, tmp_path):
    """``launch/quickstart.py``'s round, set up as the entry point sets it
    up (``parse_device`` turns TF32 off), equals the same round under
    ``chip_smoke.full_float32`` bit for bit, each in a fresh process
    under deterministic algorithms (``tests/_tf32_round.py``): uploads,
    FedAvg, student, generator and losses."""
    import os
    import subprocess
    import sys

    script = os.path.join(os.path.dirname(__file__), "_tf32_round.py")
    got = {}
    for mode in ("entry", "chip_smoke"):
        out = tmp_path / f"{mode}.pt"
        run = subprocess.run([sys.executable, script, mode, str(out)],
                             capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stderr[-3000:]
        got[mode] = torch.load(out, weights_only=False)
    a, b = got["entry"], got["chip_smoke"]
    assert a["loop"] == b["loop"] == "fused"
    assert a["losses"] == b["losses"]
    assert len(a["tensors"]) == len(b["tensors"])
    for x, y in zip(a["tensors"], b["tensors"]):
        assert torch.equal(x, y)


def test_mesh_gradient_rule_on_a_one_rank_nccl_world(cuda):
    """On a one-rank NCCL world over the card (``launch.mesh``'s own), the
    sum over the clients axis passes its cotangent through and a
    replicated input's gradient is all-reduced once: d(Σy² + Σx)/dx for
    y = w·x is 2w²x + 1, eagerly."""
    import torch.distributed as dist

    from repro_torch.fl.sharding import replicated_input, sum_over_clients
    from repro_torch.launch.mesh import make_client_mesh

    mesh = make_client_mesh(device="cuda")
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(257, generator=g, device="cuda", requires_grad=True)
        w = torch.randn(257, generator=g, device="cuda")
        y = sum_over_clients(replicated_input(x, mesh) * w, mesh)
        gx, = torch.autograd.grad((y * y).sum() + x.sum(), x)
        torch.testing.assert_close(gx, 2 * w * w * x.detach() + 1,
                                   rtol=1e-6, atol=1e-6)
    finally:
        dist.destroy_process_group()


def test_one_rank_model_axis_train_step_is_unsharded_bit_for_bit(cuda):
    """``launch.train``'s setup under a world of one rank on the card
    (``make_host_mesh(1)``: a 1 x 1 (data, model) mesh, the MoE layers
    on their expert-parallel path) equals the train step without a mesh
    bit for bit: deepseek-v2-lite at smoke widths, float32, the capacity
    binding, two steps, under deterministic algorithms (the MoE's
    ``index_add_`` adds in no fixed order without them)."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T

    cfg = get_smoke_config("deepseek-v2-lite-16b").replace(
        capacity_factor=0.5)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                              device="cuda") for k in ("tokens", "labels")}
    mesh = make_host_mesh(1, device="cuda")
    flags = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for m in (mesh, None):
            state = ST.make_train_state(cfg, seed=3, device="cuda", mesh=m)
            step = ST.make_train_step(cfg, m)
            metrics = [step(state, batch)[1] for _ in range(2)]
            runs.append((metrics, T.leaves(state["params"])))
        (m1, p1), (m0, p0) = runs
        for a, b in zip(m1, m0):
            assert all(torch.equal(a[k], b[k]) for k in b)
        assert all(torch.equal(a, b) for a, b in zip(p1, p0))
        assert float(m0[0]["moe_aux"]) > 0
    finally:
        torch.use_deterministic_algorithms(flags)
        dist.destroy_process_group()
