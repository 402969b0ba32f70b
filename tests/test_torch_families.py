"""The LM families that serve in the engine's dense mode — gemma3-4b
(the sliding-window pattern), deepseek-v2-lite-16b and deepseek-v2-236b
(MLA and MoE; 236b takes the q_lora branch, lite does not) and
llama-3.2-vision-11b (gated cross-attention) — against the JAX package,
at their ``smoke()`` sizes in float32.

The reference's parameters (``transformer.init_model``) are carried
across with ``interop``; the vlm's two gates (``xattn.gate``,
``mlp_gate``), zero at init, are set non-zero and its patch embeddings
are random, so that a fault in cross-attention shows. Token and vision
inputs come from numpy with a seed. Tolerances: logits and losses 1e-4
(``TOL_LOGITS``, float32 summed in another order), single layers and
caches 1e-5.

Also here: the config fields and parameter counts of all ten
architectures, MoE routing with a binding capacity (both packages drop
the same tokens) and with tied router probabilities, the blockwise
prefill at S = 4096 (GQA with a window, MLA), and what the port refuses
for these families (the sharded MoE; a vlm in LLM DENSE, as the
reference cannot run one there). Their engine streams are held in
``tests/test_torch_serving_families.py``, their training in
``tests/test_torch_family_train.py``.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as R_base
from repro.models import attention as R_A
from repro.models import moe as R_M
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.configs import base as T_base
from repro_torch.core import dense_llm as T_DL
from repro_torch.launch import dense_llm_oneshot as T_one
from repro_torch.launch import steps as T_ST
from repro_torch.models import attention as T_A
from repro_torch.models import moe as T_M
from repro_torch.models import transformer as T_T

TOL = 1e-5
TOL_LOGITS = 1e-4
ARCHS = ("gemma3-4b", "deepseek-v2-lite-16b", "deepseek-v2-236b",
         "llama3.2-vision-11b")


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size tensors gain nothing from torch's thread pool, and its
    threads and XLA's slow each other down tenfold in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ref_init = jax.jit(R_T.init_model, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, port cfg, reference params, port params, vision as
    numpy or None): the vlm's gates set non-zero."""
    rc, tc = R_base.get_smoke_config(arch), T_base.get_smoke_config(arch)
    rp = _np(_ref_init(jax.random.PRNGKey(0), rc))
    vision = None
    if rc.family == "vlm":
        n_super = rp["cross"]["mlp_gate"].shape[0]
        rp["cross"]["mlp_gate"] = np.linspace(0.6, -0.8, n_super,
                                              dtype=np.float32)
        rp["cross"]["xattn"]["gate"] = np.linspace(-0.7, 0.9, n_super,
                                                   dtype=np.float32)
        vision = np.random.default_rng(3).standard_normal(
            (2, rc.n_patches, rc.vision_dim)).astype(np.float32)
    tp = interop.lm_params_from_reference(rp, tc, device="cpu")
    return rc, tc, jax.tree.map(jnp.asarray, rp), tp, vision


def _vision(vision, b=None):
    v = vision if b is None or vision is None else vision[:b]
    return (None, None) if v is None else (jnp.asarray(v), torch.tensor(v))


# --------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", R_base.available_archs())
def test_config_fields_and_counts_match_reference(arch):
    """CONFIG and smoke() field for field, and the analytic parameter
    counts, for every architecture the reference registers. The port
    has every field but ``scan_layers`` (it loops over its layers)."""
    missing = {f.name for f in dataclasses.fields(R_base.ArchConfig)} \
        - {f.name for f in dataclasses.fields(T_base.ArchConfig)}
    assert missing == {"scan_layers"}
    for get in ("get_config", "get_smoke_config"):
        want, got = getattr(R_base, get)(arch), getattr(T_base, get)(arch)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), \
                (arch, f.name)
        assert got.attention_kind == want.attention_kind
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
    assert T_base.available_archs() == R_base.available_archs()


# ---------------------------------------------------------------- interop --

@pytest.mark.parametrize("arch", ARCHS)
def test_interop_round_trip(arch):
    """Reference tree -> port -> reference, leaf for leaf and dtype for
    dtype, the router float32; a tree of another config is refused."""
    rc, tc, rp, tp, _ = _model(arch)
    assert set(interop.lm_param_shapes(tc)) == {
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(rp)[0]}
    back = interop.lm_params_to_reference(tp)
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, a in jax.tree_util.tree_flatten_with_path(_np(rp))[0]:
        np.testing.assert_array_equal(flat_b[path], a)
    if tc.family == "moe":
        assert tp["blocks"]["moe"]["router"]["w"].dtype == torch.float32
        # a bfloat16 config keeps its router float32 (moe.py:31-33)
        bf = interop.lm_params_from_reference(
            jax.tree_util.tree_map_with_path(
                lambda path, a: a if "router" in str(path)
                else a.astype(jnp.bfloat16), _np(rp)),
            tc.replace(param_dtype="bfloat16"), device="cpu")
        assert bf["blocks"]["moe"]["router"]["w"].dtype == torch.float32
        assert bf["blocks"]["moe"]["gate"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="does not fit"):
        interop.lm_params_from_reference(
            _np(rp), tc.replace(n_layers=tc.n_layers * 2), device="cpu")


# ----------------------------------------------------------------- trunk --

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_moe_aux(arch):
    """Forward without a cache over 20 tokens, on the plain profile and
    (the vlm's self layers through K2's plain pair on the CPU) the kernel
    profile; gemma3's window decides its logits."""
    rc, tc, rp, tp, vision = _model(arch)
    toks = np.random.default_rng(4).integers(0, tc.vocab_size, (2, 20))
    rv, tv = _vision(vision)
    want, _, raux = jax.jit(lambda p, t, v: R_T.forward(
        p, rc, tokens=t, vision=v))(rp, jnp.asarray(toks, jnp.int32), rv)
    for mode in ("ref", "fused"):
        got, cache, aux = T_T.forward(
            tp, tc.replace(kernel_vjp_mode=mode), tokens=torch.tensor(toks),
            vision=tv, with_aux=True)
        assert cache is None
        _close(got, want, TOL_LOGITS)
        _close(aux["moe_aux"], raux["moe_aux"], TOL_LOGITS)
    if tc.family == "moe":
        assert float(aux["moe_aux"]) > 0.5
    if tc.sliding_window:
        no_window, _ = T_T.forward(tp, tc.replace(sliding_window=0),
                                   tokens=torch.tensor(toks))
        assert float((no_window - got).abs().max()) > 1e-2
    if tc.family == "vlm":
        with pytest.raises(ValueError, match="vision"):
            T_T.forward(tp, tc, tokens=torch.tensor(toks))


def _ref_decode(rc, vision):
    @jax.jit
    def step(p, cache, tok, pos):
        return R_T.forward(p, rc, tokens=tok, positions=pos[None],
                           cache=cache, cache_pos=pos, vision=vision,
                           decode=True)[:2]
    return step


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference_and_full_forward(arch):
    """Prefill 11 tokens into a cache of 20, then 9 teacher-forced decode
    steps (past gemma3's window): every step's logits equal the
    reference's and the full forward's last position, and the caches
    (MLA's c_kv and k_rope, a moe's layer0, a vlm's (n_super, per, ...))
    equal the reference's. The MoE capacity depends on the tokens in a
    call, so a binding one drops other tokens in the full forward than
    in the prefill (in both packages): here it is set never to bind
    (``capacity_factor = n_experts``); the MoE tests hold a binding one."""
    rc, tc, rp, tp, vision = _model(arch)
    if tc.n_experts:
        rc, tc = (c.replace(capacity_factor=float(c.n_experts))
                  for c in (rc, tc))
    rv, tv = _vision(vision, 1)
    toks = np.random.default_rng(5).integers(0, tc.vocab_size, (1, 20)) \
        .astype(np.int32)
    p, T = 11, 20
    full, _ = T_T.forward(tp, tc, tokens=torch.tensor(toks), vision=tv)
    want, rcache, _ = jax.jit(lambda p_, t, c, v: R_T.forward(
        p_, rc, tokens=t, cache=c, cache_pos=jnp.int32(0), vision=v))(
        rp, jnp.asarray(toks[:, :p]), R_T.init_cache(rc, 1, T), rv)
    got, tcache = T_T.forward(tp, tc, tokens=torch.tensor(toks[:, :p]),
                              cache=T_T.init_cache(tc, 1, T, device="cpu"),
                              cache_pos=0, vision=tv)
    _close(got, want, TOL_LOGITS)
    _close(got, full[:, :p], TOL_LOGITS)
    step = _ref_decode(rc, rv)
    for i in range(p, T):
        want, rcache = step(rp, rcache, jnp.asarray(toks[:, i:i + 1]),
                            jnp.int32(i))
        got, tcache = T_T.forward(
            tp, tc, tokens=torch.tensor(toks[:, i:i + 1]),
            positions=torch.tensor([i], dtype=torch.int32), cache=tcache,
            cache_pos=i, vision=tv, decode=True)
        _close(got, want, TOL_LOGITS)
        _close(got[:, 0], full[:, i], TOL_LOGITS)
    got_c = interop.tree_to_reference(tcache)
    for path, a in jax.tree_util.tree_flatten_with_path(_np(rcache))[0]:
        _close(dict(jax.tree_util.tree_flatten_with_path(got_c)[0])[path], a)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch):
    """Cross-entropy plus router_aux_coef times the MoE auxiliary, over a
    mask; the vlm reads batch["vision"]."""
    rc, tc, rp, tp, vision = _model(arch)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tc.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, tc.vocab_size, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) > 0.3).astype(np.float32)
    rv, tv = _vision(vision)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "mask": jnp.asarray(mask)}
    tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels),
          "mask": torch.tensor(mask)}
    if rv is not None:
        rb["vision"], tb["vision"] = rv, tv
    want, wparts = jax.jit(lambda p, b: R_T.loss_fn(p, rc, b))(rp, rb)
    got, parts = T_T.loss_fn(tp, tc, tb)
    _close(got, want, TOL_LOGITS)
    for k in ("ce", "moe_aux"):
        _close(parts[k], wparts[k], TOL_LOGITS)
    _close(got, parts["ce"] + tc.router_aux_coef * parts["moe_aux"], TOL)


# ----------------------------------------------------------- the layers --

@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v2-236b"])
def test_mla_layer_with_and_without_q_lora(arch):
    """mla_apply (236b's q_lora branch, lite's wq) over 9 tokens, then
    with a cache: prefill 6 and decode one, the scale 1/√(nope + rope)."""
    rc, tc, rp, tp, _ = _model(arch)
    ra = jax.tree.map(lambda a: a[0], rp["blocks"]["attn"])
    ta = T_T.layer(tp["blocks"], 0)["attn"]
    assert ("wq_a" in ta) == bool(tc.q_lora_rank)
    x = np.random.default_rng(7).standard_normal(
        (2, 9, tc.d_model)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    mla = jax.jit(lambda a, x_, q, c, at: R_A.mla_apply(
        a, x_, rc, positions=q, cache=c, cache_pos=at))
    want, _ = mla(ra, jnp.asarray(x), jnp.asarray(pos), None, None)
    got, _ = T_A.mla_apply(ta, torch.tensor(x), tc, positions=torch.tensor(pos))
    _close(got, want)
    rcache = R_A.mla_cache_init(rc, 2, 12, jnp.float32)
    tcache = T_A.mla_cache_init(tc, 2, 12, torch.float32, "cpu")
    for lo, hi in ((0, 6), (6, 7)):
        want, rcache = mla(ra, jnp.asarray(x[:, lo:hi]),
                           jnp.asarray(pos[lo:hi]), rcache, jnp.int32(lo))
        got, tcache = T_A.mla_apply(
            ta, torch.tensor(x[:, lo:hi]), tc,
            positions=torch.tensor(pos[lo:hi]), cache=tcache, cache_pos=lo)
        _close(got, want)
    for n in ("c_kv", "k_rope"):
        _close(tcache[n], rcache[n])


def test_cross_attention_layer_with_a_gate():
    rc, tc, rp, tp, vision = _model("llama3.2-vision-11b")
    ra = jax.tree.map(lambda a: a[1], rp["cross"]["xattn"])
    ta = T_T.layer(tp["cross"], 1)["xattn"]
    assert float(ta["gate"]) != 0.0
    x = np.random.default_rng(8).standard_normal(
        (2, 5, tc.d_model)).astype(np.float32)
    want = jax.jit(lambda a, x_, v: R_A.cross_attn_apply(a, x_, v, rc))(
        ra, jnp.asarray(x), jnp.asarray(vision))
    got = T_A.cross_attn_apply(ta, torch.tensor(x), torch.tensor(vision), tc)
    _close(got, want)
    assert float(got.abs().max()) > 1e-2


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_layer_window_on_cache_paths(window):
    """gqa_apply with a window, without a cache and decoding against one
    (gemma3's local layers)."""
    rc, tc, rp, tp, _ = _model("gemma3-4b")
    ra = jax.tree.map(lambda a: a[0], rp["blocks"]["attn"])
    ta = T_T.layer(tp["blocks"], 0)["attn"]
    x = np.random.default_rng(9).standard_normal(
        (2, 14, tc.d_model)).astype(np.float32)
    pos = np.arange(14, dtype=np.int32)
    gqa = jax.jit(lambda a, x_, q, c, at: R_A.gqa_apply(
        a, x_, rc, positions=q, window=window, cache=c, cache_pos=at))
    want, _ = gqa(ra, jnp.asarray(x), jnp.asarray(pos), None, None)
    got, _ = T_A.gqa_apply(ta, torch.tensor(x), tc,
                           positions=torch.tensor(pos), window=window)
    _close(got, want)
    rcache = R_A.gqa_cache_init(rc, 2, 16, jnp.float32)
    tcache = T_A.gqa_cache_init(tc, 2, 16, torch.float32, "cpu")
    for lo, hi in ((0, 10), (10, 11), (11, 12)):
        want, rcache = gqa(ra, jnp.asarray(x[:, lo:hi]),
                           jnp.asarray(pos[lo:hi]), rcache, jnp.int32(lo))
        got, tcache = T_A.gqa_apply(
            ta, torch.tensor(x[:, lo:hi]), tc,
            positions=torch.tensor(pos[lo:hi]), window=window, cache=tcache,
            cache_pos=lo)
        _close(got, want)


# ------------------------------------------------------------------- MoE --

def _moe_case(arch, T, seed, capacity_factor=1.25):
    rc, tc, rp, tp, _ = _model(arch)
    rc, tc = (c.replace(capacity_factor=capacity_factor) for c in (rc, tc))
    rm = jax.tree.map(lambda a: a[0], rp["blocks"]["moe"])
    tm = T_T.layer(tp["blocks"], 0)["moe"]
    x = np.random.default_rng(seed).standard_normal(
        (2, T // 2, tc.d_model)).astype(np.float32)
    return rc, tc, rm, tm, x


def _ref_moe_local(rc, capacity):
    return jax.jit(lambda xf, m: R_M._moe_local(
        xf, m["router"]["w"], m["gate"], m["up"], m["down"], cfg=rc,
        offset=0, e_local=rc.n_experts, capacity=capacity))


def test_moe_with_a_binding_capacity_drops_the_same_tokens():
    """256 tokens, 4 experts, top-2, capacity factor 0.25: each expert
    holds 40 of ~128 assignments. The same outputs, the same auxiliary,
    and the same tokens left with no routed expert at all (their routed
    output exactly 0 in both)."""
    rc, tc, rm, tm, x = _moe_case("deepseek-v2-lite-16b", 256, 10, 0.25)
    assert T_M._capacity(256, tc) == R_M._capacity(256, rc) == 40
    xf = x.reshape(-1, tc.d_model)
    want, waux = _ref_moe_local(rc, 40)(jnp.asarray(xf), rm)
    got, aux = T_M._moe_local(
        torch.tensor(xf), tm["router"]["w"], tm["gate"], tm["up"], tm["down"],
        cfg=tc, capacity=40)
    _close(got, want)
    _close(aux, waux)
    dropped_ref = np.all(np.asarray(want) == 0, axis=-1)
    dropped = torch.all(got == 0, dim=-1).numpy()
    assert dropped.sum() > 10
    np.testing.assert_array_equal(dropped, dropped_ref)
    # and through moe_apply, the shared experts on top
    wy, waux2 = jax.jit(lambda m, x_: R_M.moe_apply(m, x_, rc))(
        rm, jnp.asarray(x))
    gy, aux2 = T_M.moe_apply(tm, torch.tensor(x), tc)
    _close(gy, wy)
    _close(aux2, waux2)
    # a mesh without the expert axis takes the unsharded path, as the
    # reference's moe_apply does
    no_ep = SimpleNamespace(axis_names=("pod", "data"),
                            shape={"pod": 2, "data": 16})
    y2, a2 = T_M.moe_apply(tm, torch.tensor(x), tc, mesh=no_ep,
                           dp_axes=("pod", "data"))
    assert torch.equal(y2, gy) and torch.equal(a2, aux2)


def test_moe_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: top-k
    takes the lowest k indices, as jax.lax.top_k does, so experts 0 and
    1 fill (capacity 24 of 32 assignments each; tokens 24-31 dropped) and
    2 and 3 stay empty."""
    rc, tc, rm, tm, x = _moe_case("deepseek-v2-236b", 32, 11)
    rm = dict(rm, router={"w": jnp.zeros_like(rm["router"]["w"])})
    tm = dict(tm, router={"w": torch.zeros_like(tm["router"]["w"])})
    xf = x.reshape(-1, tc.d_model)
    cap = T_M._capacity(32, tc)
    want, waux = _ref_moe_local(rc, cap)(jnp.asarray(xf), rm)
    got, aux = T_M._moe_local(
        torch.tensor(xf), tm["router"]["w"], tm["gate"], tm["up"], tm["down"],
        cfg=tc, capacity=cap)
    _close(got, want)
    _close(aux, waux)
    assert cap == 24 and bool((got[24:] == 0).all())


# ------------------------------------------------------ blockwise prefill --

@pytest.mark.parametrize("case", ["gqa_window", "mla"])
def test_blockwise_prefill_matches_reference(case):
    """S = 4096 takes the blockwise path (1024 x 1024 blocks): gemma3's
    layer with a window of 1100 (blocks wholly masked before the window
    and partly masked across it), and MLA's concatenated nope + rope keys
    (deepseek-v2-lite); both also against the port's materialized path."""
    arch = "gemma3-4b" if case == "gqa_window" else "deepseek-v2-lite-16b"
    rc, tc, rp, tp, _ = _model(arch)
    ra = jax.tree.map(lambda a: a[0], rp["blocks"]["attn"])
    ta = T_T.layer(tp["blocks"], 0)["attn"]
    S = 4096
    assert T_A._blockwise(tc, S, S)
    x = np.random.default_rng(12).standard_normal(
        (1, S, tc.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    kw = {"window": 1100} if case == "gqa_window" else {}
    apply_r = R_A.gqa_apply if case == "gqa_window" else R_A.mla_apply
    apply_t = T_A.gqa_apply if case == "gqa_window" else T_A.mla_apply
    want, _ = jax.jit(lambda a, x_, q: apply_r(a, x_, rc, positions=q,
                                               **kw))(
        ra, jnp.asarray(x), jnp.asarray(pos))
    got, _ = apply_t(ta, torch.tensor(x), tc, positions=torch.tensor(pos),
                     **kw)
    _close(got, want, TOL_LOGITS)
    plain, _ = apply_t(ta, torch.tensor(x),
                       tc.replace(use_blockwise_attn=False),
                       positions=torch.tensor(pos), **kw)
    _close(got, plain, TOL_LOGITS)


def test_llm_dense_refuses_a_vlm_by_name():
    """LLM DENSE takes these families but the vlm, as a client or the
    student, by name and with the reason (its cross blocks need patch
    embeddings the server never has); the other three build their train
    state and both server steps."""
    vlm = T_base.get_smoke_config("llama3.2-vision-11b")
    others = [T_base.get_smoke_config(a) for a in ARCHS if a != ARCHS[-1]]
    for student, clients in ((vlm, others), (others[0], [others[1], vlm])):
        with pytest.raises(ValueError, match="llama3-2-vision-11b.*patch "
                           "embeddings"):
            T_DL.make_llm_dense_steps(student, clients, device="cpu")
    oc = T_one.LLMOneShotConfig(client_archs=(ARCHS[0],),
                                student_arch=ARCHS[-1])
    with pytest.raises(ValueError, match="vlm"):
        oc.arch_config(oc.student_arch)
    assert T_DL.make_llm_dense_steps(others[1], others, device="cpu")
    for cfg in (*others, vlm):
        assert T_ST.make_train_state(cfg, device="cpu")["step"] == 0
