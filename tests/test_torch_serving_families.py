"""The serving engine for every architecture beside llama3.2-3b (held in
``tests/test_torch_serving.py``), against the JAX package's engine on the
same parameters and prompts, at ``smoke()`` sizes in float32.

  * Paged mode for qwen1.5-4b (q, k and v biases), phi3-medium-14b and
    musicgen-large (the audio family, paged as the dense one): equal
    greedy streams for 3 ragged requests in 2 slots (the third recycles
    a freed slot and released blocks), the pool, block table and
    sequence lengths after the first scheduler step within 1e-5, and
    paged ≡ the port's own dense mode.
  * Dense mode, the default of gemma3-4b (a request passing the smoke
    window of 8), deepseek-v2-lite-16b, deepseek-v2-236b and
    llama-3.2-vision-11b (the engine's zero patch embeddings): equal
    greedy streams, and paged mode refused as the reference refuses it.

The reference's parameters are carried across with ``interop``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as R_base
from repro.launch.engine import ServeEngine as RefEngine
from repro.launch.engine import engine_keys
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.configs import base as T_base
from repro_torch.launch import paging as T_PG
from repro_torch.launch.engine import ServeEngine

TOL = 1e-5
PAGED_ARCHS = ("qwen1.5-4b", "phi3-medium-14b", "musicgen-large")
DENSE_ARCHS = ("gemma3-4b", "deepseek-v2-lite-16b", "deepseek-v2-236b",
               "llama3.2-vision-11b")
# (prompt_len, max_new), ragged for the paged engine; for the dense one
# a single total length, so the reference's dense cache compiles once
_PAGED = [(5, 6), (9, 4), (12, 7)]
_DENSE = [(12, 6), (7, 11)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size tensors gain nothing from torch's thread pool, and its
    threads and XLA's slow each other down tenfold in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(arch, requests):
    """(reference cfg, port cfg, reference params, port params, prompts,
    max_len)."""
    rc, tc = R_base.get_smoke_config(arch), T_base.get_smoke_config(arch)
    rp = jax.jit(R_T.init_model, static_argnums=1)(engine_keys(0)[0], rc)
    tp = interop.lm_params_from_reference(jax.tree.map(np.asarray, rp), tc,
                                          device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab_size, p).astype(np.int32)
               for p, _ in requests]
    return rc, tc, rp, tp, prompts, max(p + g for p, g in requests)


def _submit(eng, prompts, requests):
    return [eng.submit(pr, max_new=g) for pr, (_, g) in zip(prompts,
                                                             requests)]


def _streams(eng, prompts, requests):
    rids = _submit(eng, prompts, requests)
    out = eng.drain()
    return [out[r] for r in rids]


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_paged_engine_equals_the_reference_engine(arch):
    rc, tc, rp, tp, prompts, max_len = _model(arch, tuple(_PAGED))
    assert T_PG.supports_paged(tc)
    kw = {"max_reqs": 2, "max_len": max_len}
    ref = RefEngine(rc, rp, mode="paged", **kw)
    eng = ServeEngine(tc, tp, device="cpu", **kw)
    assert eng.mode == "paged"
    for e in (ref, eng):
        _submit(e, prompts, _PAGED)
        e.step()                     # two admissions, one decode step
    got, got_bt = interop.paged_cache_to_reference(eng._pools, eng._bt)
    np.testing.assert_array_equal(got_bt, np.asarray(ref._bt))
    np.testing.assert_array_equal(eng._seq, ref._seq)
    for n in ("k", "v"):
        np.testing.assert_allclose(got["layers"][n],
                                   np.asarray(ref._pools["layers"][n]),
                                   rtol=TOL, atol=TOL)
    want = ref.drain()
    res = eng.drain()
    for r in want:
        np.testing.assert_array_equal(res[r], want[r])
    assert eng.allocator.n_free == eng.allocator.n_blocks - 1
    dense = _streams(ServeEngine(tc, tp, mode="dense", device="cpu", **kw),
                     prompts, _PAGED)
    for r, d in zip(sorted(res), dense):
        np.testing.assert_array_equal(res[r], d)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_engine_greedy_streams_equal_the_reference(arch):
    """The default engine mode of these families is dense (no paged
    layout): the port's greedy streams equal the reference engine's (the
    vlm's with the engine's zero patch embeddings), and paged mode is
    refused as in the reference."""
    rc, tc, rp, tp, prompts, max_len = _model(arch, tuple(_DENSE))
    assert not T_PG.supports_paged(tc)
    ref = RefEngine(rc, rp, max_reqs=2, max_len=max_len)
    eng = ServeEngine(tc, tp, max_reqs=2, max_len=max_len, device="cpu")
    assert ref.mode == eng.mode == "dense"
    for w, g in zip(_streams(ref, prompts, _DENSE),
                    _streams(eng, prompts, _DENSE)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="paged mode unsupported"):
        ServeEngine(tc, tp, mode="paged", device="cpu")
