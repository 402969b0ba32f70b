"""The port's LM stack (configs, LM layers, GQA on its cache paths, the
dense trunk with a cache and over the block pool) against the JAX
package's, on ``llama3_2_3b.smoke()`` in float32.

The reference's parameters, caches and pools are carried across with
``repro_torch.interop``; other inputs come from numpy with a seed.
Tolerance rtol = atol = 1e-5 (float32 on both sides, summed in another
order), 1e-4 for full logits over the vocabulary.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as R_base
from repro.launch import paging as R_PG
from repro.models import attention as R_A
from repro.models import layers as R_L
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.configs import base as T_base
from repro_torch.configs import llama3_2_3b as T_llama
from repro_torch.models import attention as T_A
from repro_torch.models import layers as T_L
from repro_torch.models import transformer as T_T

TOL = 1e-5
TOL_LOGITS = 1e-4
ARCH = "llama3.2-3b"


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, port params)."""
    rc, tc = R_base.get_smoke_config(ARCH), T_base.get_smoke_config(ARCH)
    rp = R_T.init_model(jax.random.PRNGKey(0), rc)
    return rc, tc, rp, interop.lm_params_from_reference(_np(rp), tc,
                                                        device="cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# --------------------------------------------------------------- configs --

@pytest.mark.parametrize("which", ["CONFIG", "smoke"])
def test_config_fields_match_reference(which):
    from repro.configs import llama3_2_3b as R_llama

    got = T_llama.CONFIG if which == "CONFIG" else T_llama.smoke()
    want = R_llama.CONFIG if which == "CONFIG" else R_llama.smoke()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_config_registry_routes():
    assert T_base.get_config("llama3_2_3b") == T_llama.CONFIG
    assert T_base.get_smoke_config("llama3.2-3b") == T_llama.smoke()
    # the dense-mode families resolve through the aliases, as the
    # reference's registry does
    for name in ("gemma3-4b", "deepseek-v2-lite-16b", "deepseek_v2_236b",
                 "llama3.2-vision-11b", "llama-3.2-vision-11b"):
        assert T_base.get_config(name).name == R_base.get_config(name).name
    with pytest.raises(KeyError, match="unknown arch"):
        T_base.get_config("gpt-17")


# ---------------------------------------------------------------- layers --

def _layer_cases(rng):
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = {"w": rng.standard_normal((16, 24)).astype(np.float32) / 4}
    mlp = {k: {"w": rng.standard_normal(s).astype(np.float32) / 4}
           for k, s in (("gate", (16, 24)), ("up", (16, 24)),
                        ("down", (24, 16)))}
    scale = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32)}
    table = {"table": rng.standard_normal((40, 16)).astype(np.float32)}
    ids = rng.integers(0, 40, (2, 5)).astype(np.int32)
    pos = np.array([0, 3, 9, 17, 40], np.int32)
    pos_b = rng.integers(0, 60, (2, 5)).astype(np.int32)
    return {
        "linear": (R_L.linear, T_L.linear, (w, h)),
        "rmsnorm": (R_L.rmsnorm, T_L.rmsnorm, (scale, h)),
        "embed": (R_L.embed, T_L.embed, (table, ids)),
        "unembed": (R_L.unembed, T_L.unembed, (table, h)),
        "swiglu": (R_L.swiglu, T_L.swiglu, (mlp, h)),
        "rope_cos_sin": (lambda p: R_L.rope_cos_sin(p, 8, 500_000.0),
                         lambda p: T_L.rope_cos_sin(p, 8, 500_000.0), (pos,)),
        "apply_rope": (
            lambda a, p: R_L.apply_rope(a, *R_L.rope_cos_sin(p, 8)),
            lambda a, p: T_L.apply_rope(a, *T_L.rope_cos_sin(p, 8)),
            (x, pos)),
        "apply_rope_per_row": (
            lambda a, p: R_L.apply_rope(a, *R_L.rope_cos_sin(p, 8)),
            lambda a, p: T_L.apply_rope(a, *T_L.rope_cos_sin(p, 8)),
            (x, pos_b)),
    }


@pytest.mark.parametrize("name", ["linear", "rmsnorm", "embed", "unembed",
                                  "swiglu", "rope_cos_sin", "apply_rope",
                                  "apply_rope_per_row"])
def test_lm_layer_matches_reference(name):
    ref_fn, port_fn, args = _layer_cases(np.random.default_rng(1))[name]
    want = ref_fn(*[jax.tree.map(jnp.asarray, a) for a in args])
    got = port_fn(*[interop.tree_from_reference(a, device="cpu")
                    if isinstance(a, dict) else torch.tensor(a)
                    for a in args])
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _close(g, w)


def test_rmsnorm_casts_before_the_scale():
    """In bfloat16 the normalized value is rounded to bfloat16 before
    the scale multiplies it, in bfloat16, as the reference does."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = R_L.rmsnorm({"scale": jnp.asarray(s, jnp.bfloat16)},
                       jnp.asarray(x, jnp.bfloat16))
    got = T_L.rmsnorm({"scale": torch.tensor(s).bfloat16()},
                      torch.tensor(x).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_init_model_tree_matches_reference(model):
    rc, tc, rp, _ = model
    got = T_T.init_model(tc, seed=3, device="cpu")
    want = jax.eval_shape(lambda: R_T.init_model(jax.random.PRNGKey(0), rc))
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert [jax.tree_util.keystr(k) for k in flat_g] == \
        [jax.tree_util.keystr(k) for k in flat_w]
    for (_, g), (_, w) in zip(flat_g.items(), flat_w.items()):
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)
    # N(0, 1/d_in) linear weights, norms at one
    wq = got["blocks"]["attn"]["wq"]["w"]
    assert abs(float(wq.std()) * np.sqrt(tc.d_model) - 1) < 0.05
    assert bool((got["blocks"]["norm1"]["scale"] == 1).all())


# ------------------------------------------------------------ attention --

def test_gqa_prefill_and_decode_match_reference(model):
    rc, tc, rp, tp = model
    ra, ta = _layer0(rp["blocks"])["attn"], T_T.layer(tp["blocks"], 0)["attn"]
    rng = np.random.default_rng(4)
    B, S, T = 2, 6, 10
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    rcache = R_A.gqa_cache_init(rc, B, T, jnp.float32)
    tcache = T_A.gqa_cache_init(tc, B, T, torch.float32, "cpu")
    pos = np.arange(S, dtype=np.int32)
    want, rcache = R_A.gqa_apply(ra, jnp.asarray(x), rc,
                                 positions=jnp.asarray(pos), cache=rcache)
    got, tcache = T_A.gqa_apply(ta, torch.tensor(x), tc,
                                positions=torch.tensor(pos), cache=tcache)
    _close(got, want)
    for p in range(S, S + 3):                    # three decode steps
        xd = rng.standard_normal((B, 1, tc.d_model)).astype(np.float32)
        want, rcache = R_A.gqa_apply(
            ra, jnp.asarray(xd), rc, positions=jnp.asarray([p], jnp.int32),
            cache=rcache, cache_pos=jnp.int32(p))
        got, tcache = T_A.gqa_apply(
            ta, torch.tensor(xd), tc, positions=torch.tensor([p]),
            cache=tcache, cache_pos=p)
        _close(got, want)
    for n in ("k", "v"):
        _close(tcache[n], rcache[n])


def _pool_case(rng, cfg, R=3, page=4, m=4):
    """A random pool, block tables with distinct blocks per slot and one
    inactive slot (all-zero row, position 0), and positions."""
    n_blocks = 1 + R * m
    shape = (n_blocks, page, cfg.n_kv_heads, cfg.head_dim)
    pool = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    bt = (np.arange(R * m, dtype=np.int32) + 1).reshape(R, m)
    bt[1] = 0
    pos = np.array([9, 0, 14], np.int32)[:R]
    return pool, bt, pos


def test_gqa_apply_paged_matches_reference(model):
    rc, tc, rp, tp = model
    ra, ta = _layer0(rp["blocks"])["attn"], T_T.layer(tp["blocks"], 0)["attn"]
    rng = np.random.default_rng(5)
    pool, bt, pos = _pool_case(rng, tc)
    x = rng.standard_normal((3, 1, tc.d_model)).astype(np.float32)
    want, rpool = R_A.gqa_apply_paged(
        ra, jnp.asarray(x), rc, positions=jnp.asarray(pos),
        pool=jax.tree.map(jnp.asarray, pool), block_tables=jnp.asarray(bt))
    tpool, tbt = interop.paged_cache_from_reference(pool, bt, device="cpu")
    got, tpool = T_A.gqa_apply_paged(ta, torch.tensor(x), tc,
                                     positions=torch.tensor(pos), pool=tpool,
                                     block_tables=tbt)
    _close(got, want)
    for n in ("k", "v"):
        _close(tpool[n], rpool[n])


# ----------------------------------------------------------------- trunk --

def test_forward_with_cache_matches_reference(model):
    """Prefill of two prompts into a cache, then three decode steps."""
    rc, tc, rp, tp = model
    rng = np.random.default_rng(6)
    B, S, T = 2, 7, 12
    toks = rng.integers(0, tc.vocab_size, (B, S)).astype(np.int32)
    want, rcache, _ = R_T.forward(rp, rc, tokens=jnp.asarray(toks),
                                  cache=R_T.init_cache(rc, B, T),
                                  cache_pos=jnp.int32(0))
    got, tcache = T_T.forward(tp, tc, tokens=torch.tensor(toks),
                              cache=T_T.init_cache(tc, B, T, device="cpu"),
                              cache_pos=0)
    _close(got, want, TOL_LOGITS)
    for p in range(S, S + 3):
        nxt = np.asarray(want)[:, -1].argmax(-1).astype(np.int32)[:, None]
        want, rcache, _ = R_T.forward(
            rp, rc, tokens=jnp.asarray(nxt),
            positions=jnp.asarray([p], jnp.int32), cache=rcache,
            cache_pos=jnp.int32(p), decode=True)
        got, tcache = T_T.forward(tp, tc, tokens=torch.tensor(nxt),
                                  positions=torch.tensor([p], dtype=torch.int32),
                                  cache=tcache, cache_pos=p)
        _close(got, want, TOL_LOGITS)
    for n in ("k", "v"):
        _close(tcache["layers"][n], rcache["layers"][n])


def test_forward_without_cache_on_the_plain_profile(model):
    rc, tc, rp, tp = model
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, (2, 9))
    want, _, _ = R_T.forward(rp, rc, tokens=jnp.asarray(toks, jnp.int32))
    got, cache = T_T.forward(tp, tc, tokens=torch.tensor(toks))
    assert cache is None
    _close(got, want, TOL_LOGITS)


def test_forward_paged_matches_reference(model):
    rc, tc, rp, tp = model
    rng = np.random.default_rng(8)
    pool, bt, pos = _pool_case(rng, tc)
    pools = {"layers": {n: np.stack([pool[n], pool[n][::-1].copy()])
                        for n in ("k", "v")}}
    toks = rng.integers(0, tc.vocab_size, (3, 1)).astype(np.int32)
    want, rpools = R_T.forward_paged(
        rp, rc, tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
        cache=jax.tree.map(jnp.asarray, pools), block_tables=jnp.asarray(bt))
    tpools, tbt = interop.paged_cache_from_reference(pools, bt, device="cpu")
    got, tpools = T_T.forward_paged(tp, tc, tokens=torch.tensor(toks),
                                    positions=torch.tensor(pos),
                                    cache=tpools, block_tables=tbt)
    _close(got, want, TOL_LOGITS)
    got_pools, got_bt = interop.paged_cache_to_reference(tpools, tbt)
    np.testing.assert_array_equal(got_bt, bt)
    for n in ("k", "v"):
        _close(got_pools["layers"][n], rpools["layers"][n])


def test_scatter_prefill_matches_reference(model):
    """A filled exact-length prefill cache lands in the same pool rows,
    the tail of its last block zero, and the table row points at it."""
    from repro_torch.launch import paging as T_PG

    rc, tc, rp, tp = model
    rng = np.random.default_rng(9)
    p, page, n_blocks, max_reqs, m = 9, 4, 10, 2, 5
    filled = {"layers": {n: rng.standard_normal(
        (tc.n_layers, 1, p, tc.n_kv_heads, tc.head_dim)).astype(np.float32)
        for n in ("k", "v")}}
    row = np.array([3, 7, 2, 0, 0], np.int32)
    rpools = R_PG.init_paged_cache(rc, max_reqs=max_reqs, n_blocks=n_blocks,
                                   page=page)
    rpools, rbt = R_PG.scatter_prefill(
        rc, rpools, jnp.zeros((max_reqs, m), jnp.int32),
        jax.tree.map(jnp.asarray, filled), 1, jnp.asarray(row))
    tpools = T_PG.init_paged_cache(tc, max_reqs=max_reqs, n_blocks=n_blocks,
                                   page=page, device="cpu")
    tbt = torch.zeros((max_reqs, m), dtype=torch.int32)
    T_PG.scatter_prefill(tc, tpools, tbt,
                         interop.tree_from_reference(filled, device="cpu"), 1,
                         torch.tensor(row))
    got, got_bt = interop.paged_cache_to_reference(tpools, tbt)
    np.testing.assert_array_equal(got_bt, np.asarray(rbt))
    for n in ("k", "v"):
        np.testing.assert_array_equal(got["layers"][n],
                                      np.asarray(rpools["layers"][n]))


# ------------------------------------------------------ what is not ported --

def test_unported_routes_raise(model):
    rc, tc, rp, tp = model
    ta = T_T.layer(tp["blocks"], 0)["attn"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 4, tc.d_model)).astype(np.float32))
    # the reference's K2 route (no cache under a kernel profile) runs, on
    # the CPU through FlashAttention's plain pair, and matches "ref"
    for mode in ("fused", "autodiff"):
        got, cache = T_A.gqa_apply(ta, x, tc.replace(kernel_vjp_mode=mode),
                                   positions=torch.arange(4))
        assert cache is None
        _close(got, T_A.gqa_apply(ta, x, tc.replace(kernel_vjp_mode="ref"),
                                  positions=torch.arange(4))[0])
    toks = torch.tensor([[3, 1, 4, 1]], dtype=torch.int32)
    _close(T_T.forward(tp, tc.replace(kernel_vjp_mode="fused"),
                       tokens=toks)[0],
           T_T.forward(tp, tc.replace(kernel_vjp_mode="ref"), tokens=toks)[0],
           TOL_LOGITS)
    # the blockwise prefill (S >= 4096) now runs, and equals the
    # materialized path
    long = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 4096, tc.d_model)).astype(np.float32))
    _close(T_A.gqa_apply(ta, long, tc, positions=torch.arange(4096))[0],
           T_A.gqa_apply(ta, long, tc.replace(use_blockwise_attn=False),
                         positions=torch.arange(4096))[0], TOL_LOGITS)
    # a sliding-window pattern on the dense trunk, as the reference runs it
    sw = (rc.replace(sliding_window=3, global_every=2),
          tc.replace(sliding_window=3, global_every=2))
    _close(T_T.forward(tp, sw[1], tokens=toks)[0],
           R_T.forward(rp, sw[0], tokens=jnp.asarray(toks.numpy()))[0],
           TOL_LOGITS)
    # still refused: an unknown family; under a model axis the paged
    # engine, and the expert-parallel MoE handed all of its experts
    with pytest.raises(ValueError, match="unknown family"):
        T_T.init_model(tc.replace(family="gnn"), device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        T_T.forward(tp, tc.replace(family="gnn"),
                    tokens=torch.zeros((1, 2), dtype=torch.int32))
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe as T_M
    pod = make_production_mesh()
    assert ServeEngine(tc, tp, mesh=pod, device="cpu").mode == "dense"
    with pytest.raises(ValueError, match="model_parallel=True"):
        ServeEngine(tc, tp, mesh=pod, mode="paged", device="cpu")
    moe = T_base.get_smoke_config("deepseek-v2-lite-16b")
    two = SimpleNamespace(axis_names=("data", "model"),
                          shape={"data": 1, "model": 2})
    with pytest.raises(ValueError, match="local_params"):
        T_M.moe_apply(T_M.moe_init(moe, generator=torch.Generator(),
                                   dtype=torch.float32),
                      torch.zeros((1, 2, moe.d_model)), moe, mesh=two)


# ---------------------------------------------------------------- interop --

def test_interop_round_trip_and_shape_check(model):
    rc, tc, rp, tp = model
    back = interop.lm_params_to_reference(tp)
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(_np(rp))[0]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="does not fit"):
        interop.lm_params_from_reference(_np(rp), tc.replace(d_ff=128),
                                         device="cpu")
    # bfloat16 keeps its bits across and widens exactly on the way back
    x = jnp.asarray(np.random.default_rng(10).standard_normal((5, 7)),
                    jnp.bfloat16)
    t = interop.tree_from_reference({"x": np.asarray(x)}, device="cpu")["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.tree_to_reference({"x": t})["x"],
                                  np.asarray(x, np.float32))
