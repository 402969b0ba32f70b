"""The port's LM training path against the JAX package's, at smoke sizes:
the new configs, the LM layers this slice adds (linear with a bias,
layernorm, gelu MLP), the trunk without a cache over tokens and over soft
embeddings on the K2 route (``kernel_vjp_mode="fused"``, which on the CPU
runs ``FlashAttention``'s plain pair) for the llama, qwen, phi3 and
musicgen smoke configs, ``loss_fn`` and its gradients against
``jax.grad``, remat, the LM data streams, the token generator, and the
train step over three steps.

The reference's parameters are carried across with
``repro_torch.interop``; the qwen biases, zero at init, are set to random
values first so that they count. Tolerances: rtol = atol = 1e-5 for
layers, 1e-4 for the trunk and the steps (float32 on both sides, summed
in another order over a vocabulary), gradients relative to each tensor's
largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as R_data
from repro import optim as R_optim
from repro.configs import base as R_base
from repro.core import generator as R_gen
from repro.launch import steps as R_ST
from repro.models import layers as R_L
from repro.models import transformer as R_T

from repro_torch import data as T_data
from repro_torch import interop
from repro_torch.configs import base as T_base
from repro_torch.core import generator as T_gen
from repro_torch.launch import steps as T_ST
from repro_torch.models import layers as T_L
from repro_torch.models import transformer as T_T

TOL = 1e-5
TOL_MODEL = 1e-4
ARCHS = ["llama3.2-3b", "qwen1.5-4b", "phi3-medium-14b", "musicgen-large"]
NEW = {"qwen1.5-4b": "qwen1_5_4b", "phi3-medium-14b": "phi3_medium_14b",
       "musicgen-large": "musicgen_large"}


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _close_rel(got, want, tol=TOL_MODEL):
    """|got − want| ≤ tol · max|want|, for gradients."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= tol * scale


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_params(arch, seed=0):
    """The reference's smoke parameters, with random q/k/v biases and a
    vlm's two gates (zero at init) set non-zero."""
    rc = R_base.get_smoke_config(arch)
    rp = _np(R_T.init_model(jax.random.PRNGKey(seed), rc))
    rng = np.random.default_rng(seed + 1)
    if rc.qkv_bias:
        for name in ("wq", "wk", "wv"):
            b = rp["blocks"]["attn"][name]["b"]
            rp["blocks"]["attn"][name]["b"] = rng.standard_normal(
                b.shape).astype(np.float32) * 0.1
    if rc.family == "vlm":
        n_super = rp["cross"]["mlp_gate"].shape[0]
        rp["cross"]["mlp_gate"] = np.linspace(0.7, -0.5, n_super,
                                              dtype=np.float32)
        rp["cross"]["xattn"]["gate"] = np.linspace(-0.6, 0.8, n_super,
                                                   dtype=np.float32)
    return rc, rp


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    rc, rp = _ref_params(request.param)
    tc = T_base.get_smoke_config(request.param).replace(
        kernel_vjp_mode="fused")
    return rc, tc, rp, interop.lm_params_from_reference(rp, tc,
                                                        device="cpu")


# --------------------------------------------------------------- configs --

@pytest.mark.parametrize("which", ["CONFIG", "smoke"])
@pytest.mark.parametrize("arch", sorted(NEW))
def test_new_config_fields_match_reference(arch, which):
    import importlib

    mod_r = importlib.import_module(f"repro.configs.{NEW[arch]}")
    mod_t = importlib.import_module(f"repro_torch.configs.{NEW[arch]}")
    got = mod_t.CONFIG if which == "CONFIG" else mod_t.smoke()
    want = mod_r.CONFIG if which == "CONFIG" else mod_r.smoke()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert T_base.get_config(arch) == mod_t.CONFIG


# ---------------------------------------------------------------- layers --

def test_new_lm_layers_match_reference():
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32) * 2 + 0.5
    lin = {"w": rng.standard_normal((16, 24)).astype(np.float32) / 4,
           "b": rng.standard_normal(24).astype(np.float32)}
    ln = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
          "bias": rng.standard_normal(16).astype(np.float32)}
    mlp = {"up": {"w": rng.standard_normal((16, 64)).astype(np.float32) / 4,
                  "b": rng.standard_normal(64).astype(np.float32)},
           "down": {"w": rng.standard_normal((64, 16)).astype(np.float32) / 8,
                    "b": rng.standard_normal(16).astype(np.float32)}}
    th = torch.from_numpy(h)
    for r_fn, t_fn, p in ((R_L.linear, T_L.linear, lin),
                          (R_L.layernorm, T_L.layernorm, ln),
                          (R_L.gelu_mlp, T_L.gelu_mlp, mlp)):
        want = r_fn(jax.tree.map(jnp.asarray, p), jnp.asarray(h))
        _close(t_fn(interop.tree_from_reference(p, device="cpu"), th), want)


# ----------------------------------------------------------------- trunk --

def test_forward_tokens_and_embeds_match_reference(model):
    rc, tc, rp, tp = model
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rc.vocab_size, (2, 12)).astype(np.int32)
    emb = rng.standard_normal((2, 12, rc.d_model)).astype(np.float32) * 0.3
    jp = jax.tree.map(jnp.asarray, rp)
    for kw_r, kw_t in (({"tokens": jnp.asarray(toks)},
                        {"tokens": torch.from_numpy(toks)}),
                       ({"embeds": jnp.asarray(emb)},
                        {"embeds": torch.from_numpy(emb)})):
        want, _, _ = R_T.forward(jp, rc, **kw_r)
        got, cache = T_T.forward(tp, tc, **kw_t)
        assert cache is None
        _close(got, want, TOL_MODEL)


def test_loss_fn_and_grads_match_jax_grad(model):
    rc, tc, rp, tp = model
    rng = np.random.default_rng(6)
    toks = rng.integers(0, rc.vocab_size, (2, 13)).astype(np.int32)
    mask = (rng.random((2, 12)) > 0.3).astype(np.float32)
    rb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:]), "mask": jnp.asarray(mask)}
    (want, parts), grads = jax.value_and_grad(
        lambda p: R_T.loss_fn(p, rc, rb), has_aux=True)(
            jax.tree.map(jnp.asarray, rp))
    leaves = T_T.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in rb.items()}
    got, tparts = T_T.loss_fn(tp, tc, tb)
    _close(got, want, TOL_MODEL)
    _close(tparts["ce"], parts["ce"], TOL_MODEL)
    assert float(tparts["moe_aux"]) == float(parts["moe_aux"]) == 0.0
    tgrads = torch.autograd.grad(got, leaves)
    for g, w in zip(tgrads, T_T.leaves(interop.tree_from_reference(
            _np(grads), device="cpu"))):
        _close_rel(g, w.numpy())
    for t in leaves:
        t.requires_grad_(False)


def test_remat_equals_no_remat():
    _, rp = _ref_params("llama3.2-3b", seed=2)
    tc = T_base.get_smoke_config("llama3.2-3b").replace(
        kernel_vjp_mode="fused")
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab_size, (2, 9)).astype(np.int32))
    out = []
    for remat in (False, True):
        tp = interop.lm_params_from_reference(rp, tc, device="cpu")
        leaves = T_T.leaves(tp)
        for t in leaves:
            t.requires_grad_(True)
        logits, _ = T_T.forward(tp, tc, tokens=x, remat=remat)
        out.append((logits.detach(),
                    torch.autograd.grad(logits.square().mean(), leaves)))
    _close(out[1][0], out[0][0])
    for a, b in zip(out[1][1], out[0][1]):
        _close(a, b)


# ------------------------------------------------------ data, generator --

def test_lm_data_and_batches_are_bit_identical():
    for seed, vocab in ((0, 512), (3, 256)):
        want = R_data.make_lm_data(seed, vocab=vocab, n_tokens=5000)
        got = T_data.make_lm_data(seed, vocab=vocab, n_tokens=5000)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        for (xa, ya), (xb, yb) in zip(
                T_data.lm_batches(got, 4, 16, seed=seed, steps=5),
                R_data.lm_batches(want, 4, 16, seed=seed, steps=5)):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("n_classes", [0, 40])
def test_tok_generator_matches_reference(n_classes):
    rp = _np(R_gen.tok_generator_init(jax.random.PRNGKey(4), nz=8, seq=12,
                                      d_model=32, d_g=16,
                                      n_classes=n_classes))
    rng = np.random.default_rng(2)
    # move the layer norms and biases off their init so that they count
    for blk in rp["blocks"]:
        for name in ("norm1", "norm2"):
            blk[name]["scale"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
            blk[name]["bias"] = rng.standard_normal(16).astype(np.float32)
        blk["mix"]["b"] = rng.standard_normal(12).astype(np.float32)
    z = rng.standard_normal((3, 8)).astype(np.float32)
    y = rng.integers(0, max(n_classes, 1), 3).astype(np.int32)
    labels = y if n_classes else None
    want = R_gen.tok_generator(jax.tree.map(jnp.asarray, rp), jnp.asarray(z),
                               None if labels is None else jnp.asarray(y))
    gen = interop.tok_generator_from_reference(rp, seq=12, d_model=32,
                                               device="cpu")
    got = T_gen.tok_generator(gen, torch.from_numpy(z),
                              None if labels is None else torch.from_numpy(y))
    assert tuple(got.shape) == (3, 12, 32)
    _close(got, want)
    back = interop.tok_generator_to_reference(gen)
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 2
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rp)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ train step --

class _Recorder:
    """Wraps an optimizer's ``step`` to keep the gradients it is given."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None
        self.params = opt.params

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]
        self.opt.step(grads)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen1.5-4b",
                                  "deepseek-v2-lite-16b",
                                  "llama3.2-vision-11b"])
def test_train_step_matches_reference_over_three_steps(arch):
    """Three steps from the same weights on the same batches: the loss,
    grad_norm and the clipped gradients at every step. Each port step
    starts from the reference's parameters of that step (carried across
    in place), so the comparison holds the step and not Adam's
    amplification of float32 noise (ROADMAP.md Queue 3). The moe arch
    with a binding capacity (its auxiliary in the loss), the vlm with its
    gates set and random patch embeddings in every batch."""
    rc, rp = _ref_params(arch, seed=7)
    tc = T_base.get_smoke_config(arch).replace(kernel_vjp_mode="fused")
    if rc.n_experts:
        rc, tc = (c.replace(capacity_factor=0.5) for c in (rc, tc))
    vision = np.random.default_rng(9).standard_normal(
        (4, rc.n_patches, rc.vision_dim)).astype(np.float32) \
        if rc.family == "vlm" else None
    lr = 3e-3
    rstate = R_ST.make_train_state(jax.random.PRNGKey(0), rc, lr=lr)
    rstate["params"] = jax.tree.map(jnp.asarray, rp)
    rstate["opt"] = R_optim.adam(lr).init(rstate["params"])
    rstep = jax.jit(R_ST.make_train_step(rc, None, lr=lr, clip=1.0))
    tstate = T_ST.make_train_state(
        tc, lr=lr, params=interop.lm_params_from_reference(rp, tc,
                                                           device="cpu"),
        device="cpu")
    tstate["opt"] = _Recorder(tstate["opt"])
    tstep = T_ST.make_train_step(tc, clip=1.0)
    toks = R_data.make_lm_data(1, vocab=rc.vocab_size, n_tokens=4000)
    clipped = jax.jit(lambda p, b: R_optim.clip_by_global_norm(
        jax.grad(lambda q: R_T.loss_fn(q, rc, b)[0])(p), 1.0)[0])
    for x, y in R_data.lm_batches(toks, 4, 16, seed=1, steps=3):
        rb = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
        tb = {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)}
        if vision is not None:
            rb["vision"] = jnp.asarray(vision)
            tb["vision"] = torch.from_numpy(vision)
        want_g = clipped(rstate["params"], rb)
        with torch.no_grad():
            for t, r in zip(T_T.leaves(tstate["params"]), T_T.leaves(
                    interop.tree_from_reference(_np(rstate["params"]),
                                                device="cpu"))):
                t.copy_(r)
        rstate, rm = rstep(rstate, rb)
        tstate, tm = tstep(tstate, tb)
        _close(tm["loss"], rm["loss"], TOL_MODEL)
        _close(tm["ce"], rm["ce"], TOL_MODEL)
        _close(tm["moe_aux"], rm["moe_aux"], TOL_MODEL)
        assert (float(rm["moe_aux"]) > 0) == bool(rc.n_experts)
        _close(tm["grad_norm"], rm["grad_norm"], TOL_MODEL)
        assert float(rm["grad_norm"]) > 1.0      # the clip is active
        for g, w in zip(tstate["opt"].grads, T_T.leaves(
                interop.tree_from_reference(_np(want_g), device="cpu"))):
            _close_rel(g, w.numpy())
    assert tstate["step"] == 3
