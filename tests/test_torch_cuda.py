"""The kernels on the card against their plain versions, and the launch
counts: K1 (Triton) against torch autograd too, K4 (CUDA C++) through
one paged decode step. Skips without a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import distill_kl as K
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
