"""Training the dense-mode families — gemma3-4b (the sliding-window
pattern on the plain path), deepseek-v2-lite-16b and deepseek-v2-236b
(MLA without and with q_lora, routed and shared experts) and
llama-3.2-vision-11b (gated cross-attention) — and LLM DENSE with the moe
and gemma3 families, the port against the JAX package at ``smoke()``
sizes in float32:

  * ``loss_fn`` and its gradient against ``jax.grad`` of the reference's
    for each arch, each block recomputed in the backward and not: the
    vlm's two gates set non-zero (zero at init, they would hide every
    cross-attention gradient) and random patch embeddings, the MoE
    capacity binding (fewer slots than assignments, so tokens drop);
  * the MoE layer's backward through the router's top-k gates, the
    gathers and the ``index_add_`` scatter, dropped tokens getting no
    expert gradient in both packages;
  * ``launch.train.train`` for each family on the CPU (the vlm on the
    reference's zero patch embeddings) and a ``--ckpt`` file of a moe
    arch that ``repro.checkpoint.restore_checkpoint`` reads;
  * one generator step and one student step of a federation of a
    deepseek-v2-lite and a gemma3 client, with a deepseek-v2-236b or a
    gemma3 student, the reference's weights and draws carried across,
    and ``dense_llm_oneshot`` with that federation: one round.

The three train steps of a moe and a vlm arch are cases of
``tests/test_torch_train.py``'s three-step test. Tolerances: rtol = atol
= 1e-5 for the loss and every gradient entry (``TOL``, float32 on both
sides); the DENSE steps 1e-4 (``TOL_STEP``, summed over three trunks and
a vocabulary in another order), gradients there relative to each
tensor's largest entry. Reference results are computed once per arch or
student in module-scoped fixtures.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as r_restore
from repro.configs import base as R_base
from repro.core import dense_llm as R_DL
from repro.models import moe as R_M
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.checkpoint import load_meta
from repro_torch.configs import base as T_base
from repro_torch.core import dense_llm as T_DL
from repro_torch.core import generator as T_gen
from repro_torch.fl.protocol import param_bytes
from repro_torch.launch import dense_llm_oneshot as T_one
from repro_torch.launch.train import train as lm_train
from repro_torch.models import moe as T_M
from repro_torch.models import transformer as T_T

TOL = 1e-5
TOL_STEP = 1e-4
ARCHS = ("gemma3-4b", "deepseek-v2-lite-16b", "deepseek-v2-236b",
         "llama3.2-vision-11b")
# 2 x 24 tokens, top-2 of 4 experts: 96 assignments; a capacity factor of
# 0.5 gives each expert 16 slots, 64 in all, so at least 32 drop
BATCH, SEQ, CAPACITY_FACTOR = 2, 24, 0.5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _close_rel(got, want, tol=TOL_STEP):
    """|got − want| ≤ tol · max|want|, for gradients."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size tensors gain nothing from torch's thread pool, and its
    threads and XLA's slow each other down tenfold in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init(tc, seed):
    """Random weights in the reference's tree (numpy), drawn by the
    port's ``init_model`` from ``seed``: both packages then start from
    the same numbers, without a jit of the reference's init per config."""
    return interop.lm_params_to_reference(
        T_T.init_model(tc, seed=seed, device="cpu"))


def _cfgs(arch):
    """The reference's and the port's smoke configs, the MoE capacity
    binding."""
    rc, tc = R_base.get_smoke_config(arch), T_base.get_smoke_config(arch)
    if rc.n_experts:
        rc, tc = (c.replace(capacity_factor=CAPACITY_FACTOR)
                  for c in (rc, tc))
    return rc, tc


def _set_gates(rp, rng):
    """A vlm's two gates (zero at init) set non-zero, in place."""
    n_super = rp["cross"]["mlp_gate"].shape[0]
    rp["cross"]["mlp_gate"] = rng.uniform(0.3, 0.9, n_super).astype(
        np.float32) * np.where(np.arange(n_super) % 2, -1, 1)
    rp["cross"]["xattn"]["gate"] = rng.uniform(0.3, 0.9, n_super).astype(
        np.float32) * np.where(np.arange(n_super) % 2, 1, -1)


# ------------------------------------------------- loss and gradients --

@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(reference cfg, port cfg, reference params (numpy), batch (numpy),
    the reference's loss, parts and gradient)."""
    arch = request.param
    rc, tc = _cfgs(arch)
    rng = np.random.default_rng(17)
    rp = _init(tc, 3)
    batch = {"tokens": rng.integers(0, rc.vocab_size, (BATCH, SEQ)),
             "labels": rng.integers(0, rc.vocab_size, (BATCH, SEQ)),
             "mask": (rng.random((BATCH, SEQ)) > 0.2).astype(np.float32)}
    batch["tokens"] = batch["tokens"].astype(np.int32)
    batch["labels"] = batch["labels"].astype(np.int32)
    if rc.family == "vlm":
        _set_gates(rp, rng)
        batch["vision"] = rng.standard_normal(
            (BATCH, rc.n_patches, rc.vision_dim)).astype(np.float32)
    if rc.n_experts:
        T = BATCH * SEQ
        assert rc.n_experts * R_M._capacity(T, rc) < T * rc.top_k
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: R_T.loss_fn(p, rc, b), has_aux=True))(_j(rp),
                                                           _j(batch))
    return rc, tc, rp, batch, float(loss), _np(parts), _np(grads)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_jax_grad(case, remat):
    """The loss, its parts and every parameter's gradient; the window
    decides gemma3's (its local layers see 8 of 24 keys), the MoE
    auxiliary enters with ``router_aux_coef``, every cross-attention
    weight of the vlm gets a gradient."""
    rc, tc, rp, batch, want, wparts, wgrads = case
    tp = interop.lm_params_from_reference(rp, tc.replace(remat=remat),
                                          device="cpu")
    leaves = T_T.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, parts = T_T.loss_fn(tp, tc.replace(remat=remat), tb)
    _close(got, want)
    for k in ("ce", "moe_aux"):
        _close(parts[k], wparts[k])
    if tc.n_experts:
        assert float(parts["moe_aux"].detach()) > 0.5
        _close(got, (parts["ce"] + tc.router_aux_coef
                     * parts["moe_aux"]).detach())
    grads = torch.autograd.grad(got, leaves)
    want_g = {tuple(k.key for k in path): a for path, a in
              jax.tree_util.tree_flatten_with_path(wgrads)[0]}
    got_g = dict(zip(_paths(tp), grads))
    assert set(got_g) == set(want_g)
    for p, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[p], rtol=TOL, atol=TOL,
                                   err_msg=str(p))
    if tc.family == "vlm":
        for name in ("wq", "wk", "wv", "wo"):
            assert np.abs(want_g[("cross", "xattn", name, "w")]).max() > 1e-4
        assert np.abs(want_g[("cross", "xattn", "gate")]).min() > 0


def _paths(tree, prefix=()):
    """The key paths of a nested dict's tensors, in ``leaves`` order."""
    return [p for k, v in tree.items()
            for p in (_paths(v, prefix + (k,)) if isinstance(v, dict)
                      else [prefix + (k,)])]


def test_moe_layer_backward_with_a_binding_capacity():
    """``_moe_local``'s gradient with respect to the tokens, the router
    and the three expert stacks against ``jax.grad`` of the reference's,
    over 64 tokens of which many lose every assignment: those tokens'
    routed outputs and input gradients are exactly 0 in both."""
    rc, tc = _cfgs("deepseek-v2-lite-16b")
    rp = _init(tc, 5)
    rm = jax.tree.map(lambda a: a[0], rp["blocks"]["moe"])
    rng = np.random.default_rng(8)
    xf = rng.standard_normal((64, rc.d_model)).astype(np.float32)
    r = rng.standard_normal((64, rc.d_model)).astype(np.float32)
    cap = R_M._capacity(64, rc)
    assert rc.n_experts * cap < 64 * rc.top_k

    def ref_loss(x, m):
        y, aux = R_M._moe_local(x, m["router"]["w"], m["gate"], m["up"],
                                m["down"], cfg=rc, offset=0,
                                e_local=rc.n_experts, capacity=cap)
        return jnp.sum(y * r) + aux, y

    (_, y_ref), (gx_ref, gm_ref) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(xf), _j(rm))
    tm = interop.tree_from_reference(rm, device="cpu")
    x = torch.tensor(xf, requires_grad=True)
    ws = [tm["router"]["w"], tm["gate"], tm["up"], tm["down"]]
    for w in ws:
        w.requires_grad_(True)
    y, aux = T_M._moe_local(x, *ws, cfg=tc, capacity=cap)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                                [x, *ws])
    _close(y, y_ref)
    _close(grads[0], gx_ref)
    for g, name in zip(grads[1:], ("router", "gate", "up", "down")):
        _close(g, gm_ref[name]["w"] if name == "router" else gm_ref[name])
    dropped = np.all(np.asarray(y_ref) == 0, axis=-1)
    assert dropped.sum() >= 4
    np.testing.assert_array_equal(torch.all(y == 0, dim=-1).numpy(), dropped)
    # without the auxiliary, a token with no expert gets no gradient
    g_routed = torch.autograd.grad((T_M._moe_local(
        x, *ws, cfg=tc, capacity=cap)[0] * torch.from_numpy(r)).sum(), x)[0]
    assert bool((g_routed[torch.from_numpy(dropped)] == 0).all())


# ----------------------------------------------------- the entry point --

@pytest.mark.parametrize("arch", ARCHS)
def test_train_entry_point_runs_each_family(arch):
    """``launch.train.train`` on the CPU: finite losses and grad norms,
    the MoE auxiliary in the moe archs' steps, the vlm on zero patch
    embeddings."""
    state, hist = lm_train(arch, steps=2, batch=2, seq=16, smoke=True,
                           log_every=100, device="cpu")
    assert state["step"] == 2 and len(hist) == 2
    assert all(np.isfinite([h[k] for h in hist for k in
                            ("loss", "ce", "grad_norm", "seconds")]))
    if "deepseek" in arch:
        assert all(h["moe_aux"] > 0 for h in hist)
    else:
        assert all(h["moe_aux"] == 0 for h in hist)


def test_moe_ckpt_file_restores_into_the_reference(tmp_path):
    """A trained deepseek-v2-236b's ``--ckpt`` file (3 layers deep by
    ``n_layers``: layer 0 and two MoE layers) restores into the
    reference's parameter tree, leaf for leaf."""
    arch = "deepseek-v2-236b"
    ours = os.path.join(tmp_path, "ours")
    state, hist = lm_train(arch, steps=1, batch=2, seq=16, smoke=True,
                           ckpt=ours, log_every=100, device="cpu",
                           n_layers=3)
    assert load_meta(ours) == {"arch": arch, "steps": 1,
                               "final_loss": hist[-1]["loss"]}
    like = jax.tree.map(jnp.zeros_like, _init(
        T_base.get_smoke_config(arch).replace(n_layers=3), 0))
    back = r_restore(ours, like)
    want = interop.lm_params_to_reference(state["params"])
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, a in jax.tree_util.tree_flatten_with_path(back)[0]:
        np.testing.assert_array_equal(np.asarray(a), flat[path])
    assert len(flat) == len(jax.tree.leaves(back))


# --------------------------------------------------------- LLM DENSE --

VOCAB, GEN_SEQ, NZ, D_G, GEN_BATCH = 256, 24, 16, 32, 2
CLIENTS = ("deepseek-v2-lite-16b", "gemma3-4b")


def _llm_cfg(base, arch):
    return base.get_smoke_config(arch).replace(vocab_size=VOCAB)


class _Capture:
    """An optimizer stand-in that keeps the gradients it is given."""

    def __init__(self, params):
        self.params = list(params)

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]


class _GradOut:
    """Stands in for the reference's Adam inside its steps: ``update``
    returns the gradient in place of the new parameters, so each step
    hands back the gradient it computed."""

    def __init__(self, lr):
        pass

    def init(self, params):
        return ()

    def update(self, grads, state, params, step=None):
        return grads, state


@pytest.fixture(scope="module", params=["deepseek-v2-236b", "gemma3-4b"])
def llm_ref(request):
    """The reference's federation, generator and draws, and its two
    steps (``make_llm_dense_steps``) with ``request.param`` as the
    student: their losses, and the gradients they compute (their
    optimizer replaced by ``_GradOut``)."""
    student = request.param
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    ccfgs = [_llm_cfg(R_base, a) for a in CLIENTS]
    cparams = [_init(_llm_cfg(T_base, a), i) for i, a in enumerate(CLIENTS)]
    scfg = _llm_cfg(R_base, student)
    stu = _init(_llm_cfg(T_base, student), 7)
    gen = interop.tok_generator_to_reference(T_gen.tok_generator_init(
        nz=NZ, seq=GEN_SEQ, d_model=scfg.d_model, d_g=D_G, n_classes=VOCAB,
        generator=torch.Generator().manual_seed(8), device="cpu"))
    z = np.asarray(jax.random.normal(keys[0], (GEN_BATCH, NZ)))
    y = np.asarray(jax.random.randint(keys[1], (GEN_BATCH, GEN_SEQ), 0,
                                      VOCAB))
    jc = [_j(p) for p in cparams]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R_DL.optim, "adam", _GradOut)
        gstep, sstep, _, _ = R_DL.make_llm_dense_steps(
            scfg, ccfgs, gen_seq=GEN_SEQ, nz=NZ, distill_kl_mode="ref",
            kernel_vjp_mode="ref")
    g_grad, _, gl, parts = gstep(_j(gen), (), _j(stu), jc, z, y)
    s_grad, _, dl = sstep(_j(stu), (), _j(gen), jc, z, y)
    return dict(student=student, cparams=cparams, stu=stu, gen=gen, z=z,
                y=y, gen_loss=float(gl),
                parts={k: float(v) for k, v in parts.items()},
                dis_loss=float(dl), g_grad=_np(g_grad), s_grad=_np(s_grad))


def _llm_port(ref, mode):
    ccfgs = [_llm_cfg(T_base, a) for a in CLIENTS]
    cparams = [interop.lm_params_from_reference(p, c, device="cpu")
               for p, c in zip(ref["cparams"], ccfgs)]
    scfg = _llm_cfg(T_base, ref["student"])
    stu = interop.lm_params_from_reference(ref["stu"], scfg, device="cpu")
    for t in T_T.leaves(stu):
        t.requires_grad_(True)
    gen = interop.tok_generator_from_reference(ref["gen"], seq=GEN_SEQ,
                                               d_model=scfg.d_model,
                                               device="cpu")
    steps = T_DL.make_llm_dense_steps(scfg, ccfgs, s_lr=3e-4,
                                      distill_kl_mode=mode,
                                      kernel_vjp_mode=mode, device="cpu")
    return steps, cparams, stu, gen, torch.tensor(ref["z"]), \
        torch.tensor(ref["y"])


@pytest.mark.parametrize("mode", ["ref", "fused"])
def test_gen_step_matches_reference(llm_ref, mode):
    """The generator step through the MoE/MLA and windowed trunks (and,
    under "fused", K1's plain pair): its losses against the reference's
    step, the generator's gradient against ``jax.grad``."""
    (gen_step, _, _, _), cparams, stu, gen, z, y = _llm_port(llm_ref, mode)
    cap = _Capture(gen.parameters())
    loss, parts = gen_step(gen, cap, stu, cparams, z, y)
    np.testing.assert_allclose(float(loss), llm_ref["gen_loss"],
                               rtol=TOL_STEP)
    for k in ("ce", "bn", "div"):
        np.testing.assert_allclose(float(parts[k]), llm_ref["parts"][k],
                                   rtol=TOL_STEP, atol=TOL_STEP)
    assert llm_ref["parts"]["div"] != 0.0
    want = interop.ref_to_state(llm_ref["g_grad"])
    for (n, _), g in zip(gen.named_parameters(), cap.grads):
        _close_rel(g, want[n].numpy())


@pytest.mark.parametrize("mode", ["ref", "fused"])
def test_student_step_matches_reference(llm_ref, mode):
    (_, student_step, _, _), cparams, stu, gen, z, y = _llm_port(llm_ref,
                                                                 mode)
    cap = _Capture(T_T.leaves(stu))
    loss = student_step(stu, cap, gen, cparams, z, y)
    np.testing.assert_allclose(float(loss), llm_ref["dis_loss"],
                               rtol=TOL_STEP)
    want = {tuple(k.key for k in path): a for path, a in
            jax.tree_util.tree_flatten_with_path(llm_ref["s_grad"])[0]}
    got = dict(zip(_paths(stu), cap.grads))
    assert set(got) == set(want)
    for p, g in got.items():
        _close_rel(g, want[p])


def test_oneshot_with_moe_and_gemma3_runs_one_round():
    """The one-shot round with a deepseek-v2-lite and a gemma3 client and
    a deepseek-v2-236b student on the CPU, and ``full_moe()``'s shape."""
    oc = T_one.SMOKE_MOE
    assert oc.client_archs == CLIENTS
    res = T_one.dense_llm_oneshot(
        T_one.dataclasses.replace(oc, client_steps=2, epochs=2, batch=2,
                                  gen_seq=16),
        device="cpu", log=None)
    assert res.ledger.rounds == 1 and res.ledger.downlink_bytes == 0
    assert res.ledger.uplink_bytes == sum(param_bytes(p)
                                          for p in res.client_params)
    assert all(np.isfinite(res.gen_loss + res.dis_loss + res.client_losses))
    full = T_one.full_moe()
    assert full.client_archs == ("deepseek-v2-lite-16b",) * 2
    assert full.student_arch == "deepseek-v2-lite-16b" and not full.smoke
    cfg = full.arch_config(full.student_arch)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.n_experts) == \
        (27, 2048, 102400, 64)
    assert (full.batch, full.gen_seq, full.client_seq, full.epochs) == \
        (4, 256, 256, 2)
    cut = T_one.dataclasses.replace(full, n_layers=4)
    assert cut.arch_config(cut.student_arch).n_layers == 4
