"""The kernels on the card against their plain versions, and the launch
counts: K1 (Triton) against torch autograd too, K4 (CUDA C++, both
routes, every dtype, head dims 32 to 128, split and unsplit contexts)
against both plain versions, through one paged decode step on the sm90
route and its refusal of misaligned pools, K2 (CUDA C++: K2f,
K2q, K2kv) with dead rows, windows and ragged tails, at D = 112 and
through one train step, the tensor-core routes of K2f and of K2q/K2kv
(bfloat16, float16 at D 64 and 128), their route counts and their
refusal of misaligned tensors, K3 (CUDA C++: K3f, K3b) with ragged tails,
groups and an initial state, through ``SSDScan`` and one mamba train
step. Skips without a CUDA card.

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
    """K2f's output against the plain version's. The simt route computes
    in float32 and holds o to 1e-4. The sm90 route rounds P to the input's
    16-bit type before the PV product, so each o entry may move by
    Σ p_j ε_j v_j / l with |ε_j| ≤ u (2^-9 bfloat16, 2^-12 float16), at
    most u·max|v|: o is held to atol = 2u·max|v|, rtol = 0. lse comes
    from float32 scores and a float32 l on both routes: 1e-4. Rows with
    no live key are exact on both."""
    d = o.shape[-1]
    if FA.fwd_route(v.dtype, d) == "sm90":
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
    (torch.bfloat16, 112, "simt"), (torch.float32, 128, "simt")])
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
    (torch.bfloat16, 128, "sm90"), (torch.float16, 64, "sm90"),
    (torch.bfloat16, 112, "simt"), (torch.float32, 128, "simt")])
def test_flash_attention_bwd_counts_its_route(cuda, dtype, d, route):
    """One backward launches K2q and K2kv once each, each counting once in
    ``launches`` and once under its route in ``bwd_routes``."""
    q, k, v, do = _k2_inputs(1, 4, 2, 70, 70, d, dtype, cuda)
    o, lse = FA.flash_attention_fwd(q, k, v)
    before, routes = dict(FA.launches), dict(FA.bwd_routes)
    FA.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in FA.launches.items()} == {
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1}
    assert {n: c - routes[n] for n, c in FA.bwd_routes.items()} == {
        "sm90": 2 * (route == "sm90"), "simt": 2 * (route == "simt")}


@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
def test_flash_attention_sm90_bwd_raises_on_misaligned_tensors(cuda, which):
    """The sm90 backward reads q, k, v and dO by TMA: a contiguous view one
    element into its storage is refused before any launch, never sent to
    the simt kernels."""
    t = dict(zip("q k v do".split(),
                 _k2_inputs(1, 4, 2, 70, 70, 64, torch.bfloat16, cuda)))
    o, lse = FA.flash_attention_fwd(t["q"], t["k"], t["v"])
    buf = torch.empty(t[which].numel() + 1, dtype=torch.bfloat16,
                      device=cuda)
    t[which] = buf[1:].view(t[which].shape).copy_(t[which])
    before, routes = dict(FA.launches), dict(FA.bwd_routes)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.flash_attention_bwd(t["q"], t["k"], t["v"], o, lse, t["do"])
    assert FA.launches == before and FA.bwd_routes == routes


def test_flash_attention_sm90_raises_on_misaligned_tensors(cuda):
    """TMA needs 16-byte aligned bases: a contiguous view one element into
    its storage is refused before any launch, never sent elsewhere."""
    q, k, v, _ = _k2_inputs(1, 4, 2, 70, 70, 64, torch.bfloat16, cuda)
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


# (B, S, H, P, G, N, chunk): mamba2-130m's heads at a train shape, zamba2's
# at a ragged prefill, groups with a ragged tail, a chunk clamped into S
K3_CASES = [(2, 256, 24, 64, 1, 128, 256),
            (1, 300, 16, 64, 1, 64, 256),
            (2, 300, 4, 32, 2, 16, 64),
            (1, 37, 2, 16, 1, 8, 64),
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernels_match_plain_versions(cuda, B, S, H, P, G, N, cl,
                                               dtype):
    """K3f and K3b against the plain pair from the same inputs and
    initial state; float32 to 1e-4 and bfloat16 (y stored in bfloat16)
    to 1e-2 of each tensor's largest entry; the gradients are float32
    on both sides."""
    from repro_torch.kernels import ssd_scan as K3

    torch.backends.cuda.matmul.allow_tf32 = False
    x, dt, a, b, c, s0, dy, dfin = _ssd_inputs(B, S, H, P, G, N, dtype, cuda)
    y, fin, st = K3.ssd_scan_fwd(x, dt, a, b, c, s0, chunk=cl,
                                 return_chunk_states=True)
    torch.cuda.synchronize()
    py, pfin, pst = K3.ssd_scan_fwd_plain(x, dt, a, b, c, s0, chunk=cl)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert y.dtype == dtype and _rel(y, py) <= tol
    assert _rel(fin, pfin) <= 1e-4 and _rel(st, pst) <= 1e-4
    got = K3.ssd_scan_bwd(x, dt, a, b, c, st, dy, dfin, chunk=cl)
    torch.cuda.synchronize()
    want = K3.ssd_scan_bwd_plain(x, dt, a, b, c, pst, dy, dfin, chunk=cl)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) <= 1e-4


def test_ssd_scan_autograd_and_launches(cuda):
    """SSDScan with dt in bfloat16 beside bfloat16 x: one K3f and one K3b
    launch, the gradients in the inputs' dtypes, against ``ref.ssd_grads``
    (the sequential recurrence) in float32 to 1e-2 of the largest entry."""
    from repro_torch.kernels import ssd_scan as K3

    x, dt, a, b, c, s0, dy, dfin = _ssd_inputs(1, 70, 4, 16, 2, 8,
                                               torch.bfloat16, cuda,
                                               dt_dtype=torch.bfloat16)
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, a, b, c, s0)]
    before = dict(K3.launches)
    y, fin = K3.SSDScan.apply(*leaves, 32)
    grads = torch.autograd.grad((y, fin), leaves, (dy.to(y.dtype), dfin))
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in K3.launches.items()} == {
        "ssd_scan_fwd": 1, "ssd_scan_bwd": 1}
    want = ref.ssd_grads(*(t.float() for t in (x, dt, a, b, c, s0)),
                         dy.to(torch.bfloat16).float(), dfin)
    for g, w, t in zip(grads, want, leaves):
        assert g.dtype == t.dtype
        assert _rel(g, w) <= 2e-2


def test_ssm_train_step_launches_k3_per_block(cuda):
    """One mamba2 train step with remat: K3f twice a block (the forward and
    its recomputation), K3b once; a zamba2 step adds K2 for each
    application of its shared block."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.launch import steps as ST

    for arch, n_attn in (("mamba2-130m", 0), ("zamba2-7b", 2)):
        cfg = get_smoke_config(arch).replace(remat=True)
        state = ST.make_train_state(cfg, device=cuda)
        x = torch.randint(0, cfg.vocab_size, (2, 41), device=cuda)
        before = {**K3.launches, **FA.launches}
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
        assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0
