"""K1 on the card: the Triton kernels against their plain versions and
torch autograd, and the launch counts. Skips without a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import distill_kl as K
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Triton kernels run only there")
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
