"""The port's ssm (Mamba-2) and hybrid (Zamba2) families against the JAX
package's, at smoke sizes in float32: the two configs, the parameter
tree (interop keeps the (K, C) conv weights and the float32 per-head
scalars as they are), ``mamba2_apply`` on its three routes (decode, the
kernel route through ``SSDScan``'s plain pair on the CPU, and the plain
``ssd_chunked``), the trunks of ``mamba2_130m.smoke()`` and
``zamba2_7b.smoke()`` (logits over tokens and embeddings, ``loss_fn`` and
its gradients against ``jax.grad``), prefill then decode against the
full forward, the caches after a prefill, and ``forward_paged``.

The reference's parameters are carried across with ``repro_torch.interop``;
inputs come from numpy with a seed. Tolerance rtol = atol = 1e-5 for a
block, 1e-4 for the trunks' logits and the gradients (float32 on both
sides, summed in another order over a vocabulary), gradients relative to
each tensor's largest entry.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as R_base
from repro.launch import paging as R_PG
from repro.models import ssm as R_S
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.configs import base as T_base
from repro_torch.launch import paging as T_PG
from repro_torch.models import ssm as T_S
from repro_torch.models import transformer as T_T

TOL = 1e-5
TOL_MODEL = 1e-4
ARCHS = ["mamba2-130m", "zamba2-7b"]
MODULES = {"mamba2-130m": "mamba2_130m", "zamba2-7b": "zamba2_7b"}


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_rel(got, want, tol=TOL_MODEL):
    """|got − want| ≤ tol · max|want|, for gradients."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= tol * scale


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


_ref_forward = jax.jit(R_T.forward, static_argnums=1)


def _ref_init(cfg, seed=0):
    return _np(jax.jit(R_T.init_model, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(reference cfg, port cfg, reference params (numpy), port params)."""
    rc = R_base.get_smoke_config(request.param)
    tc = T_base.get_smoke_config(request.param)
    rp = _ref_init(rc)
    return rc, tc, rp, interop.lm_params_from_reference(rp, tc, device="cpu")


# --------------------------------------------------------------- configs --

@pytest.mark.parametrize("which", ["CONFIG", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch, which):
    mod_r = importlib.import_module(f"repro.configs.{MODULES[arch]}")
    mod_t = importlib.import_module(f"repro_torch.configs.{MODULES[arch]}")
    got = mod_t.CONFIG if which == "CONFIG" else mod_t.smoke()
    want = mod_r.CONFIG if which == "CONFIG" else mod_r.smoke()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.d_inner, got.n_ssm_heads) == (want.d_inner, want.n_ssm_heads)
    assert T_base.get_config(arch) == mod_t.CONFIG
    assert arch in T_base.available_archs()


def test_zamba2_counts_mamba_blocks():
    """81 mamba blocks: 13 super-blocks of 6, each followed by the shared
    block, and a tail of 3 (as ``transformer.py:119`` runs it)."""
    cfg = T_base.get_config("zamba2-7b")
    assert T_T.hybrid_shape(cfg) == (13, 3)
    shapes = interop.lm_param_shapes(cfg)
    assert shapes[("blocks", "mamba", "in_x", "w")] == (13, 6, 3584, 7168)
    assert shapes[("tail", "norm", "scale")] == (3, 3584)
    assert shapes[("shared", "attn", "wq", "w")] == (3584, 32 * 112)


# ------------------------------------------------------- parameter trees --

def test_init_model_tree_matches_reference(model):
    """Same paths and shapes as the reference's tree; in bfloat16 the
    per-head a_log, dt_bias and d_skip stay float32, and the port's draw
    has the reference's fixed values."""
    rc, tc, rp, tp = model
    mine = T_T.init_model(tc, device="cpu")
    assert dict(interop._shapes(mine)) == dict(interop._shapes(tp))
    bf = T_T.init_model(tc.replace(param_dtype="bfloat16"), device="cpu")
    m = (bf["blocks"] if tc.family == "ssm" else bf["tail"])["mamba"]
    assert m["in_x"]["w"].dtype == torch.bfloat16
    for name in ("a_log", "dt_bias", "d_skip"):
        assert m[name].dtype == torch.float32
    rbf = _ref_init(rc.replace(param_dtype="bfloat16"), 1)
    tbf = interop.lm_params_from_reference(rbf, tc, device="cpu")
    mt = (tbf["blocks"] if tc.family == "ssm" else tbf["tail"])["mamba"]
    mr = (rbf["blocks"] if tc.family == "ssm" else rbf["tail"])["mamba"]
    for name in ("a_log", "dt_bias", "d_skip"):
        assert mt[name].dtype == torch.float32
        np.testing.assert_array_equal(mt[name].numpy(), mr[name])
        _close(m[name], mr[name], 1e-6)


def test_interop_keeps_conv_layouts(model):
    """conv_x.w and conv_bc.w are (K, C), carried as they are (not
    transposed as linears); a transposed one is refused."""
    _, tc, rp, tp = model
    for key in ("blocks", "tail"):
        if key not in rp:
            continue
        for conv in ("conv_x", "conv_bc"):
            got = tp[key]["mamba"][conv]["w"]
            assert got.shape[-2] == tc.ssm_conv
            np.testing.assert_array_equal(got.numpy(),
                                          rp[key]["mamba"][conv]["w"])
    bad = jax.tree.map(lambda a: a, rp)
    w = bad["blocks"]["mamba"]["conv_x"]["w"]
    bad["blocks"]["mamba"]["conv_x"]["w"] = np.swapaxes(w, -1, -2)
    with pytest.raises(ValueError, match="does not fit"):
        interop.lm_params_from_reference(bad, tc, device="cpu")
    back = interop.lm_params_to_reference(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rp)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the block --

def _block_case(rc, rp, rng, S=12):
    """Layer 0's mamba parameters, an input and a nonzero state."""
    stack = rp["blocks"]["mamba"]
    p = jax.tree.map(lambda a: a[0] if rc.family == "ssm" else a[0, 0],
                     stack)
    x = rng.standard_normal((2, S, rc.d_model)).astype(np.float32) * 0.5
    st = _np(R_S.mamba2_state_init(rc, 2, jnp.float32))
    st = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
          for k, v in st.items()}
    return p, x, st


@pytest.fixture(scope="module")
def block_ref(model):
    """Layer 0's mamba block, inputs, states and the reference's outputs:
    no state and a prefill from a nonzero state at S = 12 (below the
    chunk) and 64 (a multiple of it, as the "ref" route requires), and
    one decode step."""
    rc, _, rp, _ = model
    rng = np.random.default_rng(4)
    apply = jax.jit(R_S.mamba2_apply, static_argnums=2,
                    static_argnames="decode")
    cases = []
    for S in (12, 64):
        p, x, st = _block_case(rc, rp, rng, S)
        want, _ = apply(_j(p), jnp.asarray(x), rc)
        want_s, wst = apply(_j(p), jnp.asarray(x), rc, state=_j(st))
        cases.append((p, x, st, False, [want, want_s, _np(wst)]))
    x1 = x[:, :1]
    want, wst = apply(_j(p), jnp.asarray(x1), rc, state=_j(st), decode=True)
    cases.append((p, x1, st, True, [None, want, _np(wst)]))
    return cases


@pytest.mark.parametrize("mode", ["ref", "fused"])
def test_mamba2_apply_matches_reference(model, block_ref, mode):
    tcm = model[1].replace(kernel_vjp_mode=mode)
    for p, x, st, decode, (want, want_s, wst) in block_ref:
        tp = interop.tree_from_reference(p, device="cpu")
        if not decode:
            got, none = T_S.mamba2_apply(tp, torch.from_numpy(x), tcm)
            assert none is None
            _close(got, want)
        tst = interop.tree_from_reference(st, device="cpu")
        got, gst = T_S.mamba2_apply(tp, torch.from_numpy(x), tcm, state=tst,
                                    decode=decode)
        _close(got, want_s)
        for k in st:
            _close(gst[k], wst[k])
            np.testing.assert_array_equal(tst[k].numpy(), st[k])  # kept


def test_causal_conv_and_ssd_chunked_match_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    pad = rng.standard_normal((2, 3, 5)).astype(np.float32)
    for pd in (None, pad):
        want = R_S._causal_conv(*map(jnp.asarray, (x, w, b)),
                                None if pd is None else jnp.asarray(pd))
        got = T_S._causal_conv(*map(torch.from_numpy, (x, w, b)),
                               None if pd is None else torch.from_numpy(pd))
        for g, wt in zip(got, want):
            _close(g, wt)
    B, S, H, P, G, N = 1, 48, 4, 8, 2, 8
    args = [rng.standard_normal(s).astype(np.float32) * 0.3
            for s in ((B, S, H, P), (B, S, H), (H,), (B, S, G, N),
                      (B, S, G, N), (B, H, P, N))]
    args[1] = np.log1p(np.exp(args[1])).astype(np.float32)
    args[2] = -np.exp(args[2]).astype(np.float32)
    want = R_S.ssd_chunked(*map(jnp.asarray, args[:5]), chunk=16,
                           initial_state=jnp.asarray(args[5]))
    got = T_S.ssd_chunked(*map(torch.from_numpy, args[:5]), chunk=16,
                          initial_state=torch.from_numpy(args[5]))
    for g, wt in zip(got, want):
        _close(g, wt)
    # the reference's contract: S a multiple of the chunk
    with pytest.raises(AssertionError):
        T_S.ssd_chunked(*map(torch.from_numpy, args[:5]), chunk=32)


# ------------------------------------------------------------- the trunk --

@pytest.mark.parametrize("mode", ["ref", "fused"])
def test_forward_tokens_and_embeds_match_reference(model, mode):
    rc, tc, rp, tp = model
    tcm = tc.replace(kernel_vjp_mode=mode)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rc.vocab_size, (2, 32)).astype(np.int32)
    emb = rng.standard_normal((2, 32, rc.d_model)).astype(np.float32) * 0.3
    for kw_r, kw_t in (({"tokens": jnp.asarray(toks)},
                        {"tokens": torch.from_numpy(toks)}),
                       ({"embeds": jnp.asarray(emb)},
                        {"embeds": torch.from_numpy(emb)})):
        want, _, _ = _ref_forward(_j(rp), rc, **kw_r)
        got, cache = T_T.forward(tp, tcm, **kw_t)
        assert cache is None
        _close(got, want, TOL_MODEL)


def test_fused_route_takes_any_length(model):
    """The kernel route (``SSDScan``'s plain pair here) takes a length
    that is no multiple of the chunk, where the "ref" route asserts; it
    agrees with the reference's kernel route (interpret mode)."""
    rc, tc, rp, tp = model
    toks = np.random.default_rng(8).integers(
        0, rc.vocab_size, (1, 45)).astype(np.int32)
    want, _, _ = _ref_forward(_j(rp), rc.replace(kernel_vjp_mode="fused"),
                              tokens=jnp.asarray(toks))
    got, _ = T_T.forward(tp, tc.replace(kernel_vjp_mode="fused"),
                         tokens=torch.from_numpy(toks))
    _close(got, want, TOL_MODEL)
    with pytest.raises(AssertionError):
        T_T.forward(tp, tc.replace(kernel_vjp_mode="ref"),
                    tokens=torch.from_numpy(toks))


@pytest.fixture(scope="module")
def loss_ref(model):
    """A masked batch and the reference's loss, cross-entropy and
    ``jax.grad``."""
    rc, _, rp, _ = model
    rng = np.random.default_rng(6)
    toks = rng.integers(0, rc.vocab_size, (2, 33)).astype(np.int32)
    mask = (rng.random((2, 32)) > 0.3).astype(np.float32)
    rb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:]), "mask": jnp.asarray(mask)}
    (want, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: R_T.loss_fn(p, rc, rb), has_aux=True))(_j(rp))
    return rb, float(want), float(parts["ce"]), _np(grads)


@pytest.mark.parametrize("mode", ["ref", "fused"])
def test_loss_fn_and_grads_match_jax_grad(model, loss_ref, mode):
    """With remat, as the full configs train."""
    _, tc, rp, _ = model
    rb, want, want_ce, grads = loss_ref
    tp = interop.lm_params_from_reference(rp, tc, device="cpu")
    leaves = T_T.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}
    got, tparts = T_T.loss_fn(tp, tc.replace(kernel_vjp_mode=mode,
                                             remat=True), tb)
    _close(got, want, TOL_MODEL)
    _close(tparts["ce"], want_ce, TOL_MODEL)
    tgrads = torch.autograd.grad(got, leaves)
    for g, w in zip(tgrads, T_T.leaves(interop.tree_from_reference(
            grads, device="cpu"))):
        _close_rel(g, w.numpy())


def test_prefill_then_decode_equals_full_forward(model):
    """A prefill of 20 tokens into a cache, then 5 decode steps: each
    step's logits equal the full forward's at its position, and the
    prefill's cache equals the reference's."""
    rc, tc, rp, tp = model
    toks = np.random.default_rng(7).integers(
        0, rc.vocab_size, (2, 25)).astype(np.int32)
    full, _ = T_T.forward(tp, tc, tokens=torch.from_numpy(toks))
    p = 20
    cache = T_T.init_cache(tc, 2, 25, device="cpu")
    with torch.inference_mode():
        lg, cache = T_T.forward(tp, tc, tokens=torch.from_numpy(toks[:, :p]),
                                cache=cache, cache_pos=0)
        _close(lg, full[:, :p].detach().numpy(), TOL_MODEL)
        rcache = R_T.init_cache(rc, 2, 25)
        _, rcache, _ = R_T.forward(_j(rp), rc, tokens=jnp.asarray(toks[:, :p]),
                                   positions=jnp.arange(p), cache=rcache,
                                   cache_pos=0)
        for g, w in zip(jax.tree.leaves(interop.tree_to_reference(cache)),
                        jax.tree.leaves(_np(rcache))):
            _close(g, w, TOL_MODEL)
        for t in range(p, 25):
            lg, cache = T_T.forward(
                tp, tc, tokens=torch.from_numpy(toks[:, t:t + 1]),
                positions=torch.tensor([t], dtype=torch.int32), cache=cache,
                cache_pos=t, decode=True)
            _close(lg[:, 0], full[:, t].detach().numpy(), TOL_MODEL)


def test_forward_paged_matches_reference(model):
    """One paged decode step over slot states and (for zamba2) KV pools
    from numpy, three slots, one of them inactive."""
    rc, tc, rp, tp = model
    rng = np.random.default_rng(9)
    page, R = 4, 3
    pools = _np(R_PG.init_paged_cache(rc, max_reqs=R, n_blocks=7, page=page))
    pools = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3)
                         .astype(np.float32), pools)
    bt = np.array([[1, 2], [0, 0], [3, 4]], np.int32)
    pos = np.array([5, 0, 2], np.int32)
    toks = rng.integers(0, rc.vocab_size, (R, 1)).astype(np.int32)
    want, wpools = R_T.forward_paged(_j(rp), rc, tokens=jnp.asarray(toks),
                                     positions=jnp.asarray(pos),
                                     cache=_j(pools),
                                     block_tables=jnp.asarray(bt))
    tpools, tbt = interop.paged_cache_from_reference(pools, bt, device="cpu")
    mine = T_PG.init_paged_cache(tc, max_reqs=R, n_blocks=7, page=page,
                                 device="cpu")
    assert dict(interop._shapes(mine)) == dict(interop._shapes(tpools))
    with torch.inference_mode():
        got, tpools = T_T.forward_paged(tp, tc, tokens=torch.from_numpy(toks),
                                        positions=torch.from_numpy(pos),
                                        cache=tpools, block_tables=tbt)
    _close(got, want, TOL_MODEL)
    got_pools, _ = interop.paged_cache_to_reference(tpools, tbt)
    for g, w in zip(jax.tree.leaves(got_pools), jax.tree.leaves(_np(wpools))):
        _close(g, w, TOL_MODEL)
