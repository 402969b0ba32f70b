"""K4's split-context arithmetic (the sm90 route's) and its split plan.

  * ``paged_attention_split_plain`` — the plain PyTorch version of what
    the sm90 kernel computes: per-split (acc, m, l) under the live mask,
    then one merge over the splits that hold a live token — against the
    reference's oracle (``repro.kernels.ref.paged_attention``) and its
    Pallas kernel in interpret mode, over several slots a split (pps 1,
    2, 3 with M not a multiple), wholly dead splits, lengths on a split
    boundary, ``seq_lens == 0`` (exact zeros), the full table and a
    length past it. Tolerance 1e-5 in float32.
  * ``split_plan``: a pure function of shapes whose splits cover every
    table slot, one split when the (request, KV head) pairs fill two
    waves of SMs.

Inputs are made with numpy from a seed and handed to both frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as R_PK
from repro.kernels import ref as R_ref

from repro_torch.kernels import paged_attention as T_PK

TOL = 1e-5
H100_SMS = 132


def _paged_case(page, m, seqs, hq, hkv, d, seed=23):
    """Pools, a full table per request with distinct blocks, and the
    table rows of requests with seq_len 0 pointed at the null block."""
    rng = np.random.default_rng(seed)
    r = len(seqs)
    n_blocks = 1 + r * m
    q = rng.standard_normal((r, hq, d)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, page, hkv, d)).astype(np.float32)
    bt = (np.arange(r * m, dtype=np.int32) + 1).reshape(r, m)
    seq = np.asarray(seqs, np.int32)
    bt[seq == 0] = 0
    return q, kp, vp, bt, seq


# (page, M, seq_lens, Hq, Hkv, D, pps): the both-oracle cases of
# test_torch_serving.py, each split, plus split boundaries and dead splits
@pytest.mark.parametrize("page,m,seqs,hq,hkv,d,pps", [
    (8, 4, (1, 17, 32), 4, 2, 16, 2),        # one token / mid-split / full
    (8, 4, (8, 16, 24), 4, 2, 16, 1),        # every page its own split
    (16, 2, (3, 31, 32), 4, 2, 16, 1),
    (4, 7, (5, 13, 27), 4, 2, 16, 3),        # M 7 over pps 3; 5: 2 dead
    (16, 4, (0, 64, 37, 0), 4, 2, 16, 3),    # null rows, M 4 over pps 3
    (16, 3, (0, 20, 48), 6, 2, 32, 2),       # G = 3, the serve grouping
    (8, 5, (16, 32, 40, 0), 4, 2, 16, 2),    # lengths on split boundaries
    (8, 5, (3, 47, 40), 4, 4, 16, 2),        # 47 past the table (40)
    (4, 6, (24, 9, 1), 2, 1, 16, 6),         # one split holds the table
])
def test_split_plain_matches_both_oracles(page, m, seqs, hq, hkv, d, pps):
    q, kp, vp, bt, seq = _paged_case(page, m, seqs, hq, hkv, d)
    args_j = [jnp.asarray(a) for a in (q, kp, vp, bt, seq)]
    args_t = [torch.tensor(a) for a in (q, kp, vp, bt, seq)]
    got = T_PK.paged_attention_split_plain(*args_t, pps=pps).numpy()
    want_oracle = np.asarray(R_ref.paged_attention(*args_j))
    want_kernel = np.asarray(R_PK.paged_attention(*args_j, interpret=True))
    np.testing.assert_allclose(got, want_oracle, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_kernel, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[seq == 0], 0.0)


@pytest.mark.parametrize("R,hkv,m,page", [
    (8, 8, 32, 16), (8, 8, 256, 16), (8, 32, 32, 16), (6, 2, 8, 16),
    (3, 8, 7, 4), (5, 2, 20, 8), (1, 1, 1, 16), (2, 1, 0, 16),
    (33, 8, 40, 16)])
def test_split_plan_covers_every_slot_from_shapes_alone(R, hkv, m, page):
    n_split, pps = T_PK.split_plan(R, hkv, m, page, H100_SMS)
    assert (n_split, pps) == T_PK.split_plan(R, hkv, m, page, H100_SMS)
    assert isinstance(n_split, int) and isinstance(pps, int)
    assert n_split >= 1 and pps >= 1
    assert n_split * pps >= m                  # every slot in a split
    assert (n_split - 1) * pps < max(m, 1)     # no split past the table
    if n_split > 1:                            # a split holds a few pages
        assert pps * page >= T_PK.MIN_SPLIT_TOKENS


def test_split_plan_one_split_when_pairs_fill_two_waves():
    for R, hkv in ((33, 8), (264, 1), (8, 40)):
        assert R * hkv >= 2 * H100_SMS
        assert T_PK.split_plan(R, hkv, 32, 16, H100_SMS) == (1, 32)
    # the serve shape (R·Hkv = 64) splits into a few hundred CTAs
    n_split, pps = T_PK.split_plan(8, 8, 32, 16, H100_SMS)
    assert (n_split, pps) == (8, 4) and 256 <= 64 * n_split <= 1024
    # and the split arithmetic at that plan equals the unsplit one
    q, kp, vp, bt, seq = (torch.tensor(a) for a in _paged_case(
        16, 32, (0, 511, 64, 65, 512, 300, 1, 17), 6, 2, 16))
    torch.testing.assert_close(
        T_PK.paged_attention_split_plain(q, kp, vp, bt, seq, pps=pps),
        T_PK.paged_attention_plain(q, kp, vp, bt, seq), rtol=TOL, atol=TOL)


def test_wrapper_routes_on_the_cpu():
    """On a CPU tensor either route name runs the plain version, an
    unknown one raises, and nothing counts as a launch."""
    q, kp, vp, bt, seq = (torch.tensor(a) for a in
                          _paged_case(8, 3, (0, 9, 24), 4, 2, 16))
    before = dict(T_PK.routes), dict(T_PK.launches)
    want = T_PK.paged_attention_plain(q, kp, vp, bt, seq)
    for route in (None, "sm90", "simt"):
        torch.testing.assert_close(
            T_PK.paged_attention(q, kp, vp, bt, seq, route=route), want,
            rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown K4 route"):
        T_PK.paged_attention(q, kp, vp, bt, seq, route="tma")
    assert (dict(T_PK.routes), dict(T_PK.launches)) == before
