"""The port's serving engine on the ssm (mamba2) and hybrid (zamba2)
families against the JAX package's ``ServeEngine``, at smoke sizes in
float32 with the reference's parameters carried across by ``interop``:

  * greedy streams equal the reference engine's token for token, in the
    port's paged and dense modes, for 3 ragged requests through 2 slots
    (the third recycles a freed slot and its blocks,
    ``test_serving.py:56-68``), with prompts shorter than the smoke chunk
    of 32 as the reference's (``test_serving.py:29``);
  * the pool and slots after admission equal the reference's;
  * a pool for one request at a time queues and recycles slots and
    blocks (``test_serving.py:110``), with the roomy pool's tokens;
  * a prompt longer than the chunk and no multiple of it through the
    port's kernel route (``kernel_vjp_mode="fused"``: the plain K3 pair on
    the CPU) against the reference's kernel route (its Pallas kernel in
    interpret mode);
  * the serve wrapper and its CLI.
"""
import jax
import numpy as np
import pytest

from repro.configs import base as R_base
from repro.launch.engine import ServeEngine as RefEngine
from repro.launch.engine import engine_keys
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.configs import base as T_base
from repro_torch.launch import paging as T_PG
from repro_torch.launch.engine import ServeEngine
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve

ARCHS = ["mamba2-130m", "zamba2-7b"]
TOL = 1e-5
_PROMPTS = [(5, 6), (9, 4), (12, 7)]          # (prompt_len, max_new)
_MAX_LEN = max(p + g for p, g in _PROMPTS)


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """(reference cfg, port cfg, reference params, port params, prompts,
    the reference paged engine's greedy streams)."""
    rc = R_base.get_smoke_config(request.param)
    tc = T_base.get_smoke_config(request.param)
    rp = R_T.init_model(engine_keys(0)[0], rc)
    tp = interop.lm_params_from_reference(jax.tree.map(np.asarray, rp), tc,
                                          device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab_size, p).astype(np.int32)
               for p, _ in _PROMPTS]
    want = _run(RefEngine(rc, rp, mode="paged", max_reqs=2,
                          max_len=_MAX_LEN), prompts)
    return rc, tc, rp, tp, prompts, want


def _run(eng, prompts, budgets=_PROMPTS):
    rids = [eng.submit(pr, max_new=g) for pr, (_, g) in zip(prompts, budgets)]
    out = eng.drain()
    return [out[r] for r in rids]


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_greedy_streams_equal_the_reference_engine(lm, mode):
    _, tc, _, tp, prompts, want = lm
    eng = ServeEngine(tc, tp, mode=mode, max_reqs=2, max_len=_MAX_LEN,
                      device="cpu")
    got = _run(eng, prompts)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    if mode == "paged":
        assert eng.allocator.n_free == eng.allocator.n_blocks - 1
        assert not bool(eng._bt.any())           # every row back on block 0


def test_pools_and_slots_equal_the_reference_after_admission(lm):
    """After one scheduler step (two admissions, one decode step) the
    port's slot states, KV pools (zamba2's shared block) and block table
    hold what the reference's do."""
    rc, tc, rp, tp, prompts, _ = lm
    ref = RefEngine(rc, rp, mode="paged", max_reqs=2, max_len=_MAX_LEN)
    eng = ServeEngine(tc, tp, mode="paged", max_reqs=2, max_len=_MAX_LEN,
                      device="cpu")
    for e in (ref, eng):
        for pr, (_, g) in zip(prompts, _PROMPTS):
            e.submit(pr, max_new=g)
        e.step()
    got, got_bt = interop.paged_cache_to_reference(eng._pools, eng._bt)
    np.testing.assert_array_equal(got_bt, np.asarray(ref._bt))
    np.testing.assert_array_equal(eng._seq, ref._seq)
    want = jax.tree.map(np.asarray, ref._pools)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_pool_exhaustion_queues_then_recycles(lm):
    """A pool for one worst-case request admits one request at a time,
    FIFO, each reusing the slot and blocks the last one released: every
    leaf of a reused slot is overwritten at admission, so the tokens
    still equal the reference's."""
    _, tc, _, tp, prompts, want = lm
    eng = ServeEngine(tc, tp, mode="paged", max_reqs=3, max_len=_MAX_LEN,
                      page=4, n_blocks=1 + T_PG.blocks_needed(_MAX_LEN, 0, 4),
                      device="cpu")
    rids = [eng.submit(pr, max_new=g) for pr, (_, g) in zip(prompts, _PROMPTS)]
    running_high = 0
    while any(eng.poll(r)["status"] != "done" for r in rids):
        eng.step()
        running_high = max(running_high, sum(
            1 for r in rids if eng.poll(r)["status"] == "running"))
    assert running_high == 1
    assert eng.allocator.n_free == eng.allocator.n_blocks - 1
    for w, r in zip(want, rids):
        np.testing.assert_array_equal(eng.poll(r)["tokens"], w)


def test_long_prompt_on_the_kernel_route_equals_the_reference_kernel(lm):
    """Prompts of 45 and 70 tokens (the smoke chunk is 32): the port's
    K3 route (its plain pair on the CPU, ragged tail masked) against the
    reference's Pallas kernel in interpret mode, both engines paged."""
    rc, tc, rp, tp, _, _ = lm
    rng = np.random.default_rng(3)
    budgets = [(45, 5), (70, 4)]
    prompts = [rng.integers(0, tc.vocab_size, p).astype(np.int32)
               for p, _ in budgets]
    max_len = max(p + g for p, g in budgets)
    want = _run(RefEngine(rc.replace(kernel_vjp_mode="fused"), rp,
                          mode="paged", max_reqs=2, max_len=max_len),
                prompts, budgets)
    got = _run(ServeEngine(tc.replace(kernel_vjp_mode="fused"), tp,
                           mode="paged", max_reqs=2, max_len=max_len,
                           device="cpu"), prompts, budgets)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_wrapper_paged_equals_dense_and_cli(arch, capsys):
    toks_p, _ = serve(arch, batch=2, prompt_len=8, gen=4, mode="paged",
                      device="cpu")
    toks_d, stats = serve(arch, batch=2, prompt_len=8, gen=4, mode="dense",
                          device="cpu")
    assert toks_p.shape == (2, 4) and toks_p.dtype == np.int32
    np.testing.assert_array_equal(toks_p, toks_d)
    assert stats["tok_per_s"] > 0
    serve_main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                "5", "--gen", "3", "--device", "cpu"])
    assert "generated shape: (2, 3)" in capsys.readouterr().out
