"""LLM-scale DENSE with the ssm (mamba2) and hybrid (zamba2) families,
the port against the JAX package, at smoke widths in float32 (the train
step is held in ``test_torch_ssm_train.py``):

  * one generator step and one student step (``core/dense_llm``) of a
    federation of a mamba2 and a zamba2 client (3 mamba blocks) and a
    mamba2 student sharing a 256-token vocabulary, the reference's weights and draws
    carried across: the losses against the reference's steps, the
    gradients against ``jax.grad`` of its losses;
  * ``dense_llm_oneshot`` with that federation on the CPU: one round,
    and the ``full_ssm()`` preset.

The port runs its plain route (``kernel_vjp="ref"``: ``ssd_chunked``, the
materialized KL) and its kernel route (``"fused"``: ``SSDScan``,
``FlashAttention`` and ``DistillKL``, whose CPU wrappers run their plain
pairs). Tolerance 1e-4 (float32 on both sides, summed in another order
over trunks and a vocabulary); gradients relative to each tensor's
largest entry. Gradients, not Adam updates, are compared (ROADMAP.md
Queue 3).
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
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.configs import base as T_base
from repro_torch.core import dense_llm as T_DL
from repro_torch.fl.protocol import param_bytes
from repro_torch.launch import dense_llm_oneshot as T_one
from repro_torch.models import transformer as T_T

TOL = 1e-4
VOCAB, SEQ, NZ, D_G, BATCH = 256, 32, 16, 64, 4
CLIENTS = ("mamba2-130m", "zamba2-7b")
STUDENT = "mamba2-130m"
# smoke widths; zamba2 at 3 mamba blocks (one super-block with the shared
# block, one tail block) keeps every part of the hybrid at less compile time
DEPTH = {"zamba2-7b": 3}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close_rel(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= tol * scale


class _Capture:
    """An optimizer stand-in that keeps the gradients it is given."""

    def __init__(self, params):
        self.params = list(params)

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]


# ---------------------------------------------------------- the DENSE steps --

@pytest.fixture(scope="module")
def ref():
    """The reference's federation, generator, draws, its two steps and
    jax.grad of their losses (``dense_llm.py``'s loss functions)."""
    keys = jax.random.split(jax.random.PRNGKey(0), len(CLIENTS) + 4)
    ccfgs = [_cfg(R_base, a) for a in CLIENTS]
    init = jax.jit(R_T.init_model, static_argnums=1)
    cparams = [_np(init(k, c)) for c, k in zip(ccfgs, keys)]
    scfg = _cfg(R_base, STUDENT)
    stu = _np(init(keys[-4], scfg))
    gen = _np(R_gen.tok_generator_init(keys[-3], nz=NZ, seq=SEQ,
                                       d_model=scfg.d_model, d_g=D_G,
                                       n_classes=VOCAB))
    z = np.asarray(jax.random.normal(keys[-2], (BATCH, NZ)))
    y = np.asarray(jax.random.randint(keys[-1], (BATCH, SEQ), 0, VOCAB))
    jc = [_j(p) for p in cparams]
    gstep, sstep, g_opt, s_opt = R_DL.make_llm_dense_steps(
        scfg, ccfgs, gen_seq=SEQ, nz=NZ, g_lr=1e-5, s_lr=3e-4)
    _, _, gl, parts = gstep(_j(gen), g_opt.init(_j(gen)), _j(stu), jc, z, y)
    _, _, dl = sstep(_j(stu), s_opt.init(_j(stu)), _j(gen), jc, z, y)

    def gen_loss(gp):
        embeds = R_gen.tok_generator(gp, z, y[:, 0])
        avg = R_DL.ensemble_lm_logits(ccfgs, jc, embeds)
        s_lg, _, _ = R_T.forward(_j(stu), scfg, embeds=embeds, remat=False)
        af, sf = avg.reshape(-1, VOCAB), s_lg.reshape(-1, VOCAB)
        return R_LS.ce_loss(af, y.reshape(-1)) \
            + R_DL.embed_stats_loss(ccfgs, jc, embeds) \
            + 0.5 * R_LS.div_loss(af, sf, mode="ref")

    def stu_loss(sp):
        embeds = R_gen.tok_generator(_j(gen), z, y[:, 0])
        avg = R_DL.ensemble_lm_logits(ccfgs, jc, embeds)
        s_lg, _, _ = R_T.forward(sp, scfg, embeds=embeds, remat=False)
        return R_LS.distill_loss(avg.reshape(-1, VOCAB),
                                 s_lg.reshape(-1, VOCAB), mode="ref")

    return dict(cparams=cparams, stu=stu, gen=gen, z=z, y=y,
                gen_loss=float(gl),
                parts={k: float(v) for k, v in parts.items()},
                dis_loss=float(dl),
                g_grad=_np(jax.jit(jax.grad(gen_loss))(_j(gen))),
                s_grad=_np(jax.jit(jax.grad(stu_loss))(_j(stu))))


def _cfg(base, arch):
    """``arch``'s smoke config from the reference's or the port's
    registry, at the shared vocabulary and ``DEPTH``."""
    cfg = base.get_smoke_config(arch)
    return cfg.replace(vocab_size=VOCAB,
                       n_layers=DEPTH.get(arch, cfg.n_layers))


def _tcfg(arch):
    return _cfg(T_base, arch)


def _port(ref, mode):
    ccfgs = [_tcfg(a) for a in CLIENTS]
    cparams = [interop.lm_params_from_reference(p, c, device="cpu")
               for p, c in zip(ref["cparams"], ccfgs)]
    scfg = _tcfg(STUDENT)
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
    for (n, _), g in zip(gen.named_parameters(), cap.grads):
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


def test_oneshot_with_ssm_clients_runs_one_round():
    """The one-shot round with the mamba2/zamba2 federation on the CPU,
    and the full-width preset's shape."""
    oc = T_one.LLMOneShotConfig(client_archs=CLIENTS, student_arch=STUDENT,
                                client_steps=2, epochs=2, batch=BATCH)
    res = T_one.dense_llm_oneshot(oc, device="cpu", log=None)
    assert res.ledger.rounds == 1 and res.ledger.downlink_bytes == 0
    assert res.ledger.uplink_bytes == sum(param_bytes(p)
                                          for p in res.client_params)
    assert all(np.isfinite(res.gen_loss + res.dis_loss + res.client_losses))
    full = T_one.full_ssm()
    assert full.client_archs == ("mamba2-130m",) * 2
    assert full.student_arch == "mamba2-130m" and not full.smoke
    cfg = full.arch_config(full.student_arch)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (24, 768, 50280)
    assert (full.batch, full.gen_seq, full.client_seq) == (4, 256, 256)
