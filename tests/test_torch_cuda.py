"""The kernels on the card against their plain versions, and the launch
counts: K1 (Triton) against torch autograd too, K4 (CUDA C++) through
one paged decode step, K2 (CUDA C++: K2f, K2q, K2kv) with dead rows,
windows and ragged tails, and through one train step. Skips without a
CUDA card.

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


@pytest.mark.parametrize("R,hq,hkv,d,page,m", [
    (8, 24, 8, 128, 16, 32), (5, 4, 2, 32, 8, 4), (3, 8, 8, 64, 4, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain_version(cuda, R, hq, hkv, d,
                                                      page, m, dtype):
    args = _paged_inputs(R, hq, hkv, d, page, m, dtype, cuda)
    got = PK.paged_attention(*args)
    torch.cuda.synchronize()
    want = PK.paged_attention_plain(*args)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert bool((got[0] == 0).all())


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


# (B, Hq, Hkv, Sq, Sk, D, causal, window): the server's heads, dead rows
# (causal Sq > Sk), a window, causal=False, ragged tails at every D
K2_CASES = [(2, 24, 8, 256, 256, 128, True, 0),
            (1, 3, 1, 100, 37, 32, True, 0),
            (1, 4, 2, 150, 150, 32, True, 20),
            (1, 4, 4, 70, 130, 64, True, 0),
            (1, 4, 2, 50, 90, 64, False, 16)]


@pytest.mark.parametrize("B,hq,hkv,sq,sk,d,causal,window", K2_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain_versions(
        cuda, B, hq, hkv, sq, sk, d, causal, window, dtype):
    """K2f, K2q and K2kv against the plain pair; float32 to 1e-4 (no TF32
    in either), bfloat16 gradients, stored in bfloat16, to 1e-2 of each
    tensor's largest entry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(sq * 7 + sk + d)
    q = torch.randn(B, hq, sq, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(B, hkv, sk, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    do = torch.randn(B, hq, sq, d, generator=gen, device=cuda).to(dtype)
    kw = {"causal": causal, "window": window}
    o, lse = FA.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    po, plse = FA.flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o, po, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, plse, rtol=1e-4, atol=1e-4)
    dead = plse == FA.NEG_INF
    assert bool((lse[dead] == FA.NEG_INF).all())
    assert bool((o[dead] == 0).all())
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    want = FA.flash_attention_bwd_plain(q, k, v, po, plse, do, **kw)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype
        err = (a.float() - b.float()).abs().max()
        assert float(err) <= tol * float(b.float().abs().max())
    assert bool((got[0].reshape(B * hq, sq, d)[dead] == 0).all())


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
