"""The LLM-scale DENSE steps of the port against the JAX package's
(``core/dense_llm.py``), on the example's heterogeneous federation:
llama, qwen (QKV bias) and musicgen (audio) clients and a phi3 student
at smoke widths, sharing a 256-token vocabulary, and the token generator
(nz 16, d_g 64, gen_seq 32, batch 8).

The reference draws every weight and the z and y of one epoch
(``jax.random``, as ``examples/dense_llm_oneshot.py`` does); the weights
are carried across with ``repro_torch.interop`` and the draws injected.
One generator step and one student step are compared:

  * the losses (and L_CE, L_BN, L_div) with the reference's own steps;
  * the generator's and the student's gradients with ``jax.grad`` of the
    reference's losses, written out from ``dense_llm.py``. Gradients, not
    Adam updates: Adam's first step amplifies float32 noise (ROADMAP.md
    Queue 3).

The port runs its plain route (``kernel_vjp="ref"``: ``_sdpa``; the
materialized KL) and its kernel route (``"fused"``: ``FlashAttention``
and ``DistillKL``, whose CPU wrappers run their plain pairs); the
reference its CPU default. Tolerance 1e-4: float32 on both sides, summed
in another order over three trunks and a vocabulary; gradients relative
to each tensor's largest entry. Then ``dense_llm_oneshot`` runs end to
end on the CPU: one round, uplink bytes equal to the uploads'
``param_bytes``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as R_base
from repro.core import dense_llm as R_DL
from repro.core import generator as R_gen
from repro.core import losses as R_LS
from repro.fl.protocol import param_bytes as r_param_bytes
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.configs import base as T_base
from repro_torch.core import dense_llm as T_DL
from repro_torch.fl.protocol import param_bytes
from repro_torch.launch import dense_llm_oneshot as T_one
from repro_torch.models import transformer as T_T

TOL = 1e-4
VOCAB, SEQ, NZ, D_G, BATCH = 256, 32, 16, 64, 8
CLIENTS = ("llama3.2-3b", "qwen1.5-4b", "musicgen-large")
STUDENT = "phi3-medium-14b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_rel(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= tol * scale


def _ref_model(arch, key):
    cfg = R_base.get_smoke_config(arch).replace(vocab_size=VOCAB)
    p = _np(R_T.init_model(key, cfg))
    if cfg.qkv_bias:            # zero at init: make the biases count
        rng = np.random.default_rng(1)
        for n in ("wq", "wk", "wv"):
            b = p["blocks"]["attn"][n]["b"]
            p["blocks"]["attn"][n]["b"] = (rng.standard_normal(b.shape)
                                           * 0.1).astype(np.float32)
    return cfg, p


@pytest.fixture(scope="module")
def ref():
    """The reference's federation, generator, draws, its two steps and
    jax.grad of their losses."""
    keys = jax.random.split(jax.random.PRNGKey(0), len(CLIENTS) + 4)
    clients = [_ref_model(a, k) for a, k in zip(CLIENTS, keys)]
    ccfgs, cparams = [c for c, _ in clients], [p for _, p in clients]
    scfg, stu = _ref_model(STUDENT, keys[-4])
    gen = _np(R_gen.tok_generator_init(keys[-3], nz=NZ, seq=SEQ,
                                       d_model=scfg.d_model, d_g=D_G,
                                       n_classes=VOCAB))
    z = np.asarray(jax.random.normal(keys[-2], (BATCH, NZ)))
    y = np.asarray(jax.random.randint(keys[-1], (BATCH, SEQ), 0, VOCAB))
    j = lambda t: jax.tree.map(jnp.asarray, t)
    jc = [j(p) for p in cparams]
    # g_lr = 1e-5 for the one-shot loop below; a step's loss is computed
    # before its update, so the rate does not enter the steps' losses
    steps = R_DL.make_llm_dense_steps(scfg, ccfgs, gen_seq=SEQ, nz=NZ,
                                      g_lr=1e-5, s_lr=3e-4)
    gstep, sstep, g_opt, s_opt = steps
    _, _, gl, parts = gstep(j(gen), g_opt.init(j(gen)), j(stu), jc, z, y)
    _, _, dl = sstep(j(stu), s_opt.init(j(stu)), j(gen), jc, z, y)

    def gen_loss(gp):        # dense_llm.py's gen_step loss_fn
        embeds = R_gen.tok_generator(gp, z, y[:, 0])
        avg = R_DL.ensemble_lm_logits(ccfgs, jc, embeds)
        s_lg, _, _ = R_T.forward(j(stu), scfg, embeds=embeds, remat=False)
        af, sf = avg.reshape(-1, VOCAB), s_lg.reshape(-1, VOCAB)
        return R_LS.ce_loss(af, y.reshape(-1)) \
            + R_DL.embed_stats_loss(ccfgs, jc, embeds) \
            + 0.5 * R_LS.div_loss(af, sf, mode="ref")

    def stu_loss(sp):        # dense_llm.py's student_step loss_fn
        embeds = R_gen.tok_generator(j(gen), z, y[:, 0])
        avg = R_DL.ensemble_lm_logits(ccfgs, jc, embeds)
        s_lg, _, _ = R_T.forward(sp, scfg, embeds=embeds, remat=False)
        return R_LS.distill_loss(avg.reshape(-1, VOCAB),
                                 s_lg.reshape(-1, VOCAB), mode="ref")

    g_grad = _np(jax.jit(jax.grad(gen_loss))(j(gen)))
    s_grad = _np(jax.jit(jax.grad(stu_loss))(j(stu)))
    return dict(ccfgs=ccfgs, cparams=cparams, scfg=scfg, stu=stu, gen=gen,
                z=z, y=y, steps=steps, gen_loss=float(gl),
                parts={k: float(v) for k, v in parts.items()},
                dis_loss=float(dl), g_grad=g_grad, s_grad=s_grad)


class _Capture:
    """An optimizer stand-in that keeps the gradients it is given."""

    def __init__(self, params):
        self.params = list(params)

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]


def _port(ref, mode):
    tcfg = lambda a: T_base.get_smoke_config(a).replace(vocab_size=VOCAB)
    ccfgs = [tcfg(a) for a in CLIENTS]
    cparams = [interop.lm_params_from_reference(p, c, device="cpu")
               for p, c in zip(ref["cparams"], ccfgs)]
    scfg = tcfg(STUDENT)
    stu = interop.lm_params_from_reference(ref["stu"], scfg, device="cpu")
    for t in T_T.leaves(stu):
        t.requires_grad_(True)
    gen = interop.tok_generator_from_reference(ref["gen"], seq=SEQ,
                                               d_model=scfg.d_model,
                                               device="cpu")
    steps = T_DL.make_llm_dense_steps(scfg, ccfgs, s_lr=3e-4,
                                      distill_kl_mode=mode,
                                      kernel_vjp_mode=mode, device="cpu")
    return steps, cparams, stu, gen, torch.tensor(ref["z"]), \
        torch.tensor(ref["y"])


@pytest.mark.parametrize("mode", ["ref", "fused"])
def test_gen_step_matches_reference(ref, mode):
    (gen_step, _, _, _), cparams, stu, gen, z, y = _port(ref, mode)
    cap = _Capture(gen.parameters())
    loss, parts = gen_step(gen, cap, stu, cparams, z, y)
    np.testing.assert_allclose(float(loss), ref["gen_loss"], rtol=TOL)
    for k in ("ce", "bn", "div"):
        np.testing.assert_allclose(float(parts[k]), ref["parts"][k],
                                   rtol=TOL, atol=TOL)
    assert ref["parts"]["div"] != 0.0
    want = interop.ref_to_state(ref["g_grad"])
    names = [n for n, _ in gen.named_parameters()]
    assert sorted(names) == sorted(want)
    for n, g in zip(names, cap.grads):
        _close_rel(g, want[n].numpy())


@pytest.mark.parametrize("mode", ["ref", "fused"])
def test_student_step_matches_reference(ref, mode):
    (_, student_step, _, _), cparams, stu, gen, z, y = _port(ref, mode)
    cap = _Capture(T_T.leaves(stu))
    loss = student_step(stu, cap, gen, cparams, z, y)
    np.testing.assert_allclose(float(loss), ref["dis_loss"], rtol=TOL)
    want = T_T.leaves(interop.tree_from_reference(ref["s_grad"],
                                                  device="cpu"))
    for g, w in zip(cap.grads, want):
        _close_rel(g, w.numpy())


def test_groups_and_modes():
    llama = T_base.get_smoke_config("llama3.2-3b")
    qwen = T_base.get_smoke_config("qwen1.5-4b")
    got = T_DL.group_lm_clients([llama, qwen, llama])
    assert got == [(llama, (0, 2)), (qwen, (1,))]
    want = R_DL.group_lm_clients([R_base.get_smoke_config(a) for a in (
        "llama3.2-3b", "qwen1.5-4b", "llama3.2-3b")])
    assert [i for _, i in got] == [i for _, i in want]
    with pytest.raises(ValueError, match="cannot train"):
        T_DL.make_llm_dense_steps(llama, [llama], kernel_vjp_mode="autodiff",
                                  device="cpu")
    with pytest.raises(ValueError, match="unknown kernel_vjp mode"):
        T_DL.make_llm_dense_steps(llama, [llama], kernel_vjp_mode="pallas",
                                  device="cpu")


def test_oneshot_with_injected_draws_matches_reference_loop(ref):
    """One epoch of ``dense_llm_oneshot`` (no local steps, the reference's weights
    and draws injected) against the example's loop over the reference's
    steps: t_g generator steps, then a student step. At g_lr = 1e-5, so
    that Adam's sign flips on near-zero gradients stay below the
    tolerance (ROADMAP.md Queue 3)."""
    j = lambda t: jax.tree.map(jnp.asarray, t)
    jc = [j(p) for p in ref["cparams"]]
    gstep, sstep, g_opt, s_opt = ref["steps"]
    gp, stu = j(ref["gen"]), j(ref["stu"])
    gs = g_opt.init(gp)
    for _ in range(T_one.T_G):
        gp, gs, gl, parts = gstep(gp, gs, stu, jc, ref["z"], ref["y"])
    _, _, dl = sstep(stu, s_opt.init(stu), gp, jc, ref["z"], ref["y"])

    oc = T_one.LLMOneShotConfig(client_steps=0, epochs=1, g_lr=1e-5)
    tcfg = lambda a: T_base.get_smoke_config(a).replace(vocab_size=VOCAB)
    scfg = tcfg(STUDENT)
    res = T_one.dense_llm_oneshot(
        oc, device="cpu", log=None,
        noise=lambda epoch: (torch.tensor(ref["z"]), torch.tensor(ref["y"])),
        client_params=[interop.lm_params_from_reference(p, tcfg(a),
                                                        device="cpu")
                       for p, a in zip(ref["cparams"], CLIENTS)],
        student_params=interop.lm_params_from_reference(ref["stu"], scfg,
                                                        device="cpu"),
        gen=interop.tok_generator_from_reference(ref["gen"], seq=SEQ,
                                                 d_model=scfg.d_model,
                                                 device="cpu"))
    np.testing.assert_allclose(res.gen_loss[0], float(gl), rtol=TOL)
    for k in ("ce", "bn", "div"):
        np.testing.assert_allclose(res.gen_parts[0][k], float(parts[k]),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(res.dis_loss[0], float(dl), rtol=TOL)


def test_oneshot_runs_one_round_on_the_cpu(capsys):
    res = T_one.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "1 round" in out and "epoch 12" in out
    assert res.ledger.rounds == 1 and res.ledger.downlink_bytes == 0
    assert res.ledger.uplink_bytes == sum(param_bytes(p)
                                          for p in res.client_params)
    # the same bytes as the reference's uploads of these architectures
    want = sum(r_param_bytes(R_T.init_model(
        jax.random.PRNGKey(0),
        R_base.get_smoke_config(a).replace(vocab_size=VOCAB)))
        for a in CLIENTS)
    assert res.ledger.uplink_bytes == want
    assert all(np.isfinite(res.gen_loss + res.dis_loss))
