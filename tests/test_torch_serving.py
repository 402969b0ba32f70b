"""The port's serving path against the JAX package's, and its own
contracts.

  * K4's plain version (``repro_torch.kernels.ref.paged_attention``, the
    CPU route of ``kernels.paged_attention``) against the reference's
    oracle and its Pallas kernel in interpret mode, over ragged block
    tables, ``seq_lens`` of 0 and null rows; tolerance 1e-5.
  * The contracts of ``tests/test_serving.py`` that apply to the dense
    family, for the port's ``ServeEngine``: paged ≡ dense, continuous ≡
    sequential, pool exhaustion, impossible requests, submit and poll,
    the allocator.
  * Across frameworks: the port's paged engine against the reference's
    ``ServeEngine(mode="paged")`` on the same parameters and prompts —
    equal greedy streams, logits of every step within 1e-4 with the
    reference's tokens forced, and equal sampled streams with the
    reference's Gumbel draws injected.

Model: ``llama3_2_3b.smoke()`` in float32, the reference's parameters
carried across with ``interop``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as R_base
from repro.kernels import paged_attention as R_PK
from repro.kernels import ref as R_ref
from repro.launch.engine import ServeEngine as RefEngine
from repro.launch.engine import engine_keys
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.configs import backend as T_B
from repro_torch.configs import base as T_base
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import paged_attention as T_PK
from repro_torch.kernels import ref as T_ref
from repro_torch.launch import paging as T_PG
from repro_torch.launch.engine import ServeEngine, gumbel_noise
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve

ARCH = "llama3.2-3b"
TOL = 1e-5
TOL_LOGITS = 1e-4
# ragged: three prompt lengths and generation budgets, so requests start
# and finish at different scheduler iterations
_PROMPTS = [(5, 6), (9, 4), (12, 7)]          # (prompt_len, max_new)
_MAX_LEN = max(p + g for p, g in _PROMPTS)


@pytest.fixture(scope="module")
def lm():
    """(reference cfg, port cfg, reference params, port params, prompts)."""
    rc, tc = R_base.get_smoke_config(ARCH), T_base.get_smoke_config(ARCH)
    rp = R_T.init_model(engine_keys(0)[0], rc)
    tp = interop.lm_params_from_reference(jax.tree.map(np.asarray, rp), tc,
                                          device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab_size, p).astype(np.int32)
               for p, _ in _PROMPTS]
    return rc, tc, rp, tp, prompts


def _run(eng, prompts, sampling=None):
    sampling = sampling or [None] * len(prompts)
    rids = [eng.submit(pr, max_new=g, sampling=s)
            for pr, (_, g), s in zip(prompts, _PROMPTS, sampling)]
    out = eng.drain()
    return [out[r] for r in rids]


def _engine(lm, mode, *, max_reqs=2, **kw):
    _, tc, _, tp, _ = lm
    return ServeEngine(tc, tp, mode=mode, max_reqs=max_reqs,
                       max_len=_MAX_LEN, device="cpu", **kw)


# ---------------------------------- K4's plain version against the oracles --

def _paged_case(page, m, seqs, hq=4, hkv=2, d=16, seed=17):
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


@pytest.mark.parametrize("page,m,seqs,hq,hkv,d", [
    (8, 4, (1, 17, 32), 4, 2, 16),     # one token / mid-block / full table
    (8, 4, (8, 16, 24), 4, 2, 16),     # exact block boundaries
    (16, 2, (3, 31, 32), 4, 2, 16),
    (4, 7, (5, 13, 27), 4, 2, 16),     # odd page count, ragged everywhere
    (16, 4, (0, 64, 37, 0), 4, 2, 16),  # null rows beside a full table
    (16, 3, (0, 20, 48), 6, 2, 32),    # G = 3, the serve shape's grouping
])
def test_plain_paged_attention_matches_both_oracles(page, m, seqs, hq, hkv,
                                                    d):
    q, kp, vp, bt, seq = _paged_case(page, m, seqs, hq, hkv, d)
    args_j = [jnp.asarray(a) for a in (q, kp, vp, bt, seq)]
    args_t = [torch.tensor(a) for a in (q, kp, vp, bt, seq)]
    want_oracle = np.asarray(R_ref.paged_attention(*args_j))
    want_kernel = np.asarray(R_PK.paged_attention(*args_j, interpret=True))
    for got in (T_ref.paged_attention(*args_t),
                T_PK.paged_attention(*args_t)):    # the wrapper's CPU route
        np.testing.assert_allclose(got.numpy(), want_oracle, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got.numpy(), want_kernel, rtol=TOL,
                                   atol=TOL)
    # requests with no live token give exact zeros
    np.testing.assert_array_equal(
        T_PK.paged_attention(*args_t).numpy()[seq == 0], 0.0)


def test_null_row_is_zero_mass():
    """A seq_len of 0 on the null block adds exactly nothing, even from a
    pool of non-zero values; a live row averages the values it sees."""
    q = torch.ones((2, 2, 8))
    pool = torch.full((5, 8, 1, 8), 7.5)
    bt = torch.tensor([[0, 0], [1, 2]], dtype=torch.int32)
    seq = torch.tensor([0, 5], dtype=torch.int32)
    out = T_PK.paged_attention(q, pool, pool, bt, seq)
    np.testing.assert_array_equal(out[0].numpy(), 0.0)
    np.testing.assert_allclose(out[1].numpy(), 7.5, atol=TOL)


def test_ops_paged_attention_routing_and_checks():
    q, kp, vp, bt, seq = (torch.tensor(a) for a in
                          _paged_case(8, 2, (5, 11)))
    pol = T_B.resolve_exec_policy(None, device="cpu")
    assert pol.kernel_vjp == "ref" and pol.page == 16
    a = T_ops.paged_attention(q, kp, vp, bt, seq, policy=pol)
    for mode in ("fused", "autodiff"):
        b = T_ops.paged_attention(q, kp, vp, bt, seq,
                                  policy=T_B.ExecPolicy(kernel_vjp=mode))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL)
    with pytest.raises(ValueError, match="unknown kernel_vjp mode"):
        T_B.resolve_exec_policy(T_base.get_smoke_config(ARCH).replace(
            kernel_vjp_mode="bogus"), device="cpu")
    with pytest.raises(TypeError, match="int32"):
        T_PK.paged_attention(q, kp, vp, bt.long(), seq)
    with pytest.raises(TypeError, match="share"):
        T_PK.paged_attention(q.double(), kp, vp, bt, seq)
    with pytest.raises(ValueError, match="seq_lens"):
        T_PK.paged_attention(q, kp, vp, bt, seq[:1])
    with pytest.raises(ValueError, match="contiguous"):
        T_PK.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                             kp, vp, bt, seq)


# ------------------------------------------------ the engine's contracts --

def test_paged_equals_dense(lm):
    """Continuous paged decode == the sequential dense engine, token for
    token, with 3 ragged requests in 2 slots (the third recycles a freed
    slot and released blocks)."""
    prompts = lm[4]
    dense = _run(_engine(lm, "dense"), prompts)
    eng = _engine(lm, "paged")
    paged = _run(eng, prompts)
    for d, p in zip(dense, paged):
        np.testing.assert_array_equal(d, p)
    assert eng.allocator.n_free == eng.allocator.n_blocks - 1
    assert not bool(eng._bt.any())               # every row back on block 0


def test_continuous_equals_sequential_under_arrival_trace(lm):
    """Requests join a running decode batch at different steps (one of
    them sampled at a temperature); each stream equals the sequential
    dense run's."""
    prompts = lm[4]
    sampling = [None, {"temperature": 0.7}, None]
    seq = _run(_engine(lm, "dense", seed=3), prompts, sampling)

    eng = _engine(lm, "paged", max_reqs=3, seed=3)
    r0 = eng.submit(prompts[0], max_new=_PROMPTS[0][1])
    eng.step()
    eng.step()                                   # r0 decoding alone
    r1 = eng.submit(prompts[1], max_new=_PROMPTS[1][1],
                    sampling=sampling[1])
    eng.step()                                   # r1 joins mid-flight
    r2 = eng.submit(prompts[2], max_new=_PROMPTS[2][1])
    out = eng.drain()
    for want, got in zip(seq, (out[r0], out[r1], out[r2])):
        np.testing.assert_array_equal(want, got)


def test_pool_exhaustion_queues_then_recycles(lm):
    """A pool for one worst-case request admits one request at a time,
    FIFO, each reusing the blocks the last one released; the tokens
    still equal the roomy pool's."""
    prompts = lm[4]
    roomy = _run(_engine(lm, "paged", max_reqs=3), prompts)
    eng = _engine(lm, "paged", max_reqs=3, page=4,
                  n_blocks=1 + T_PG.blocks_needed(_MAX_LEN, 0, 4))
    rids = [eng.submit(pr, max_new=g) for pr, (_, g) in zip(prompts, _PROMPTS)]
    running_high = 0
    while any(eng.poll(r)["status"] != "done" for r in rids):
        eng.step()
        running_high = max(running_high, sum(
            1 for r in rids if eng.poll(r)["status"] == "running"))
    assert running_high == 1
    assert eng.allocator.n_free == eng.allocator.n_blocks - 1
    for want, r in zip(roomy, rids):
        np.testing.assert_array_equal(want, eng.poll(r)["tokens"])


def test_impossible_request_raises_not_hangs(lm):
    _, tc, _, tp, prompts = lm
    eng = ServeEngine(tc, tp, mode="paged", max_reqs=2, max_len=32, page=4,
                      n_blocks=3, device="cpu")  # 2 usable blocks
    eng.submit(prompts[0], max_new=12)            # needs 5
    with pytest.raises(RuntimeError, match="pool too small"):
        eng.step()


def test_submit_validation_and_poll_lifecycle(lm):
    _, tc, _, tp, prompts = lm
    eng = ServeEngine(tc, tp, mode="paged", max_reqs=2, max_len=16,
                      device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(prompts[0], max_new=0)
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(prompts[0], max_new=12)        # 5 + 12 > 16
    rid = eng.submit(prompts[0], max_new=2)
    assert eng.poll(rid)["status"] == "queued"
    eng.drain()
    done = eng.poll(rid)
    assert done["status"] == "done" and len(done["tokens"]) == 2
    assert done["latency_s"] >= 0.0


def test_block_allocator_invariants():
    a = T_PG.BlockAllocator(5)                    # blocks 1..4 usable
    assert a.n_free == 4
    got = a.alloc(3)
    assert got == [1, 2, 3]                       # the reference's LIFO order
    assert a.alloc(2) is None and a.n_free == 1  # all or nothing
    a.release(got)
    assert a.n_free == 4
    with pytest.raises(ValueError, match="double free"):
        a.release(got)
    with pytest.raises(ValueError, match=">= 2"):
        T_PG.BlockAllocator(1)


def test_unported_serving_paths_raise(lm):
    _, tc, _, tp, prompts = lm
    # the audio family pages as the dense one does (its streams against
    # the reference: tests/test_torch_serving_families.py)
    audio = tc.replace(family="audio")
    assert T_PG.supports_paged(audio)
    pools = T_PG.init_paged_cache(audio, max_reqs=1, n_blocks=2, page=4,
                                  device="cpu")
    assert tuple(pools["layers"]["k"].shape) == (
        tc.n_layers, 2, 4, tc.n_kv_heads, tc.head_dim)
    np.testing.assert_array_equal(
        _run(ServeEngine(audio, tp, mode="paged", max_reqs=2,
                         max_len=_MAX_LEN, device="cpu"), prompts)[0],
        _run(_engine(lm, "paged"), prompts)[0])
    # moe (MLA), vlm and sliding-window patterns have no paged layout:
    # they serve in dense mode, and paged mode raises
    for other in (tc.replace(sliding_window=8), tc.replace(kv_lora_rank=16)):
        assert not T_PG.supports_paged(other)
        with pytest.raises(ValueError, match="no paged cache layout"):
            T_PG.init_paged_cache(other, max_reqs=1, n_blocks=2, page=4,
                                  device="cpu")
    swcfg = tc.replace(sliding_window=8)
    assert ServeEngine(swcfg, tp, device="cpu").mode == "dense"
    with pytest.raises(ValueError, match="paged mode unsupported"):
        ServeEngine(swcfg, tp, mode="paged", device="cpu")
    for fam in ("moe", "vlm"):
        assert not T_PG.supports_paged(tc.replace(family=fam))
    # under a model axis the engine serves in dense mode and refuses
    # paged mode, as the reference's does
    from repro_torch.launch.mesh import make_production_mesh
    pod = make_production_mesh()
    assert ServeEngine(tc, tp, mesh=pod, device="cpu").mode == "dense"
    with pytest.raises(ValueError, match="model_parallel=True"):
        ServeEngine(tc, tp, mesh=pod, mode="paged", device="cpu")


def test_default_noise_is_keyed_by_request_and_token():
    noise = gumbel_noise(5)
    a = noise(1, 2, 20_000)
    np.testing.assert_array_equal(a.numpy(), noise(1, 2, 20_000).numpy())
    assert not torch.equal(a, noise(2, 2, 20_000))
    assert not torch.equal(a, noise(1, 3, 20_000))
    assert not torch.equal(a, gumbel_noise(6)(1, 2, 20_000))
    assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
    assert abs(float(a.mean()) - 0.5772) < 0.05   # Euler-Mascheroni
    assert abs(float(a.std()) - np.pi / np.sqrt(6)) < 0.05


# -------------------------------------------------- across the frameworks --

def _ref_engine(lm, **kw):
    rc, _, rp, _, _ = lm
    return RefEngine(rc, rp, mode="paged", max_reqs=2, max_len=_MAX_LEN,
                     **kw)


def test_greedy_streams_equal_the_reference_engine(lm):
    prompts = lm[4]
    want = _run(_ref_engine(lm), prompts)
    got = _run(_engine(lm, "paged"), prompts)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_pools_equal_the_reference_engine_after_admission(lm):
    """After one scheduler step (two admissions and one decode step) the
    port's pool, block table and slots hold what the reference's do."""
    prompts = lm[4]
    ref, eng = _ref_engine(lm), _engine(lm, "paged")
    for e in (ref, eng):
        for pr, (_, g) in zip(prompts, _PROMPTS):
            e.submit(pr, max_new=g)
        e.step()
    got, got_bt = interop.paged_cache_to_reference(eng._pools, eng._bt)
    np.testing.assert_array_equal(got_bt, np.asarray(ref._bt))
    np.testing.assert_array_equal(eng._seq, ref._seq)
    for n in ("k", "v"):
        np.testing.assert_allclose(got["layers"][n],
                                   np.asarray(ref._pools["layers"][n]),
                                   rtol=TOL, atol=TOL)


def test_forced_tokens_give_the_reference_logits(lm):
    """The reference's tokens forced into the port's engine: the logits
    of every prefill and decode step agree at 1e-4."""
    prompts = lm[4]
    ref_log = {}

    class Recording(RefEngine):
        def _sample(self, req, logits_row):
            tok = super()._sample(req, logits_row)
            ref_log[req.rid, len(req.tokens)] = (np.asarray(logits_row), tok)
            return tok

    class Forced(ServeEngine):
        def _sample(self, req, logits_row):
            key = req.rid, len(req.tokens)
            got_log[key] = logits_row.numpy()
            return ref_log[key][1]

    rc, tc, rp, tp, _ = lm
    got_log = {}
    _run(Recording(rc, rp, mode="paged", max_reqs=2, max_len=_MAX_LEN),
         prompts, [None, {"temperature": 0.9}, None])
    _run(Forced(tc, tp, mode="paged", max_reqs=2, max_len=_MAX_LEN,
                device="cpu"), prompts)
    assert got_log.keys() == ref_log.keys()
    assert len(got_log) == sum(g for _, g in _PROMPTS)
    for key, (want, _) in ref_log.items():
        np.testing.assert_allclose(got_log[key], want, rtol=TOL_LOGITS,
                                   atol=TOL_LOGITS)


def test_sampled_streams_equal_with_the_reference_draws(lm):
    """Temperature sampling with the reference's Gumbel draws injected:
    ``jax.random.categorical(k, l / T)`` is ``argmax(l / T + gumbel(k))``
    with ``k = fold_in(fold_in(k_sample, rid), token_index)``."""
    prompts = lm[4]
    seed = 4
    k_sample = engine_keys(seed)[2]

    def ref_draws(rid, i, vocab):
        k = jax.random.fold_in(jax.random.fold_in(k_sample, rid), i)
        return torch.tensor(np.asarray(
            jax.random.gumbel(k, (vocab,), jnp.float32)))

    sampling = [{"temperature": 0.8}, {"temperature": 1.3}, None]
    want = _run(_ref_engine(lm, seed=seed), prompts, sampling)
    got = _run(_engine(lm, "paged", seed=seed, noise=ref_draws), prompts,
               sampling)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------- serve wrapper --

def test_serve_wrapper_paged_equals_dense_and_cli(capsys):
    toks_p, stats_p = serve(ARCH, batch=2, prompt_len=8, gen=4, mode="paged",
                            device="cpu")
    toks_d, stats_d = serve(ARCH, batch=2, prompt_len=8, gen=4, mode="dense",
                            device="cpu")
    assert toks_p.shape == (2, 4) and toks_p.dtype == np.int32
    np.testing.assert_array_equal(toks_p, toks_d)
    for st in (stats_p, stats_d):
        assert set(st) >= {"prefill_s", "decode_s", "tok_per_s"}
        assert st["tok_per_s"] > 0
    serve_main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
                "5", "--gen", "3", "--device", "cpu"])
    assert "generated shape: (2, 3)" in capsys.readouterr().out
