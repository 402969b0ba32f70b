"""DENSE two-stage server training (Algorithm 1; ``repro/core/dense.py``).

Stage 1 (data generation): T_G generator steps per epoch minimizing
L_gen = L_CE + λ1·L_BN + λ2·L_div against the frozen client ensemble and
the current student, whose decision boundary defines L_div.

Stage 2 (model distillation): a student step on the same latent batch
minimizing KL(D(x̂) ‖ f_S(x̂)).

This is the reference's python epoch driver: one host sync per epoch,
where the losses are read. The frozen ensemble is held in the grouped
representation, stacked once at setup (``core/ensemble.grouped_teacher``)
and evaluated with ``grouped_ensemble_logits``: one network a client
architecture, as the reference's server holds it. Both KL sites go
through the mode the execution policy resolves (``configs/backend.py``):
on a CUDA device the K1 kernel pair, with the teacher gradient on in the
generator step (L_div) and off in the student step (L_dis).

Not ported yet, and refused with ``NotImplementedError``: the fused
(device-resident) epoch driver, checkpoints, ``nan_policy`` skip and
rollback, and the chunked teacher.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs.backend import resolve_device, resolve_exec_policy
from repro_torch.core import losses as LS
from repro_torch.core.ensemble import Client, grouped_teacher
from repro_torch.core.generator import img_generator_init
from repro_torch.models.cnn import CNN, CNNSpec, cnn_apply, cnn_init, cnn_logits


@dataclass
class DenseHistory:
    gen_loss: list = field(default_factory=list)
    gen_parts: list = field(default_factory=list)
    dis_loss: list = field(default_factory=list)
    acc: list = field(default_factory=list)


def _check_ported(scfg) -> None:
    nan_policy = getattr(scfg, "nan_policy", "raise")
    if nan_policy in ("skip", "rollback"):
        raise NotImplementedError(f"nan_policy={nan_policy!r} is not "
                                  "ported yet; the port runs 'raise'")
    if nan_policy != "raise":
        raise ValueError(f"unknown nan_policy {nan_policy!r} "
                         "(expected 'raise', 'skip' or 'rollback')")
    if getattr(scfg, "checkpoint_every", 0):
        raise NotImplementedError("server checkpoints are not ported yet")


def make_dense_steps(clients: Sequence[Client], scfg, *, use_bn: bool = True,
                     use_div: bool = True, device="cuda",
                     teacher: Callable | None = None):
    """The two steps of an epoch, closed over the frozen ensemble:
    ``teacher(x, with_bn_stats=False)``, by default the grouped teacher
    (``grouped_teacher(clients)``, stacked here once).

    Returns (gen_step, student_step):

      * ``gen_step(gen, g_opt, student, z, y) -> (loss, parts)`` takes one
        Adam step of the generator;
      * ``student_step(student, s_opt, gen, z) -> loss`` takes one SGD
        step of the student and updates its BN running statistics.

    Losses come back as 0-d tensors on the device (no host sync). Only
    the optimizer's own tensors get gradients (``torch.autograd.grad``),
    so the clients and, in the generator step, the student are left as
    they are. ``use_bn`` / ``use_div=False`` are the paper's ablations
    (Table 6).
    """
    kl_mode = resolve_exec_policy(scfg, device=device).distill_kl
    if teacher is None:
        teacher = grouped_teacher(clients)

    def gen_step(gen, g_opt, student, z, y):
        x = gen(z)
        if use_bn:
            avg, stats = teacher(x, with_bn_stats=True)
            l_bn = LS.bn_loss(stats)
        else:
            avg = teacher(x)
            l_bn = torch.zeros((), device=x.device)
        if use_div:
            l_div = LS.div_loss(avg, cnn_logits(student, x), mode=kl_mode)
        else:
            l_div = torch.zeros((), device=x.device)
        l_ce = LS.ce_loss(avg, y)
        total = l_ce + scfg.lambda_bn * l_bn + scfg.lambda_div * l_div
        g_opt.step(torch.autograd.grad(total, g_opt.params))
        return total.detach(), {"ce": l_ce.detach(), "bn": l_bn.detach(),
                                "div": l_div.detach()}

    distill_step = make_distill_step(clients, scfg, device=device,
                                     teacher=teacher)

    def student_step(student, s_opt, gen, z):
        with torch.no_grad():
            x = gen(z)
        return distill_step(student, s_opt, x)

    return gen_step, student_step


def make_distill_step(clients: Sequence[Client], scfg, *, device="cuda",
                      teacher: Callable | None = None):
    """The distillation step of Eq. (6), shared by DENSE's stage 2 and
    the one-shot baselines (``fl/baselines.py``).

    Returns ``step(student, s_opt, x) -> loss``: one SGD step of the
    student on KL(D(x) ‖ f_S(x)) over the images x, with its BN running
    statistics updated in place. The ensemble is ``teacher`` (by default
    ``grouped_teacher(clients)``, stacked here) and runs without
    autograd, its eval BN folded into its convs; the KL goes through the
    mode the execution policy resolves, without the teacher-side
    gradient (the kernel's dL/dt stream is skipped).
    """
    kl_mode = resolve_exec_policy(scfg, device=device).distill_kl
    if teacher is None:
        teacher = grouped_teacher(clients)

    def step(student, s_opt, x):
        with torch.no_grad():
            avg = teacher(x)
        logits, _ = cnn_apply(student, x, train=True, with_stats=False)
        loss = LS.distill_loss(avg, logits, mode=kl_mode,
                               with_teacher_grad=False)
        s_opt.step(torch.autograd.grad(loss, s_opt.params))
        return loss.detach()

    return step


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def check_clients_on(clients: Sequence[Client], dev: torch.device) -> None:
    """The server runs where its clients' models live."""
    for i, c in enumerate(clients):
        if _model_device(c.model) != dev:
            raise ValueError(f"client {i} lives on {_model_device(c.model)},"
                             f" the server runs on {dev}")


def train_dense_server(clients: Sequence[Client], scfg,
                       student_spec: CNNSpec | None = None, *,
                       device="cuda",
                       generator: torch.Generator | None = None,
                       init_generator: torch.Generator | None = None,
                       noise: Callable | None = None,
                       gen: torch.nn.Module | None = None,
                       student: CNN | None = None,
                       eval_fn: Callable | None = None,
                       use_bn: bool = True, use_div: bool = True,
                       eval_every: int = 0):
    """Run Algorithm 1. Returns (student, gen, history).

    ``noise(epoch) -> (z, y, extra)`` gives each epoch's latent batch
    z (synth_batch, nz), its labels y (synth_batch,) and the latents of
    the extra student steps, extra (s_steps − 1, synth_batch, nz); the
    tests inject the reference's draws through it. By default they are
    drawn from ``generator``, a ``torch.Generator`` on ``device`` seeded
    with ``scfg.seed``. ``gen`` / ``student`` are the initial generator
    and student; when None they are drawn from ``init_generator`` (a CPU
    generator, seeded ``scfg.seed``). The student is trained in place.

    A non-finite generator or student loss raises ``FloatingPointError``
    at the end of its epoch (``nan_policy="raise"``).
    """
    dev = resolve_device(device)
    _check_ported(scfg)
    student_spec = student_spec or CNNSpec(
        kind=scfg.global_kind, num_classes=scfg.num_classes,
        in_ch=scfg.in_ch, width=scfg.width, image_size=scfg.image_size)
    if init_generator is None:
        init_generator = torch.Generator().manual_seed(scfg.seed)
    if gen is None:
        gen = img_generator_init(nz=scfg.nz, img_size=scfg.image_size,
                                 out_ch=scfg.in_ch, generator=init_generator,
                                 device=dev)
    if student is None:
        student = cnn_init(student_spec, generator=init_generator,
                           device=dev)
    check_clients_on(clients, dev)
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(scfg.seed)
        b, nz, n_extra = scfg.synth_batch, scfg.nz, max(scfg.s_steps - 1, 0)

        def noise(epoch):
            z = torch.randn((b, nz), generator=generator, device=dev)
            y = torch.randint(0, scfg.num_classes, (b,),
                              generator=generator, device=dev)
            return z, y, torch.randn((n_extra, b, nz), generator=generator,
                                     device=dev)

    gen_step, student_step = make_dense_steps(
        clients, scfg, use_bn=use_bn, use_div=use_div, device=dev)
    g_opt = optim.adam(list(gen.parameters()), scfg.g_lr)
    s_opt = optim.sgd(list(student.parameters()), scfg.s_lr,
                      momentum=scfg.s_momentum)

    hist = DenseHistory()
    for epoch in range(scfg.epochs):
        z, y, extra = noise(epoch)
        for _ in range(scfg.t_g):
            gl, parts = gen_step(gen, g_opt, student, z, y)
        dl = student_step(student, s_opt, gen, z)
        for z_i in extra:       # s_steps > 1 (beyond the paper)
            dl = student_step(student, s_opt, gen, z_i)
        hist.gen_loss.append(float(gl))
        hist.gen_parts.append({k: float(v) for k, v in parts.items()})
        hist.dis_loss.append(float(dl))
        if not (np.isfinite(hist.gen_loss[-1])
                and np.isfinite(hist.dis_loss[-1])):
            raise FloatingPointError(
                f"non-finite loss at epoch {epoch} (gen={hist.gen_loss[-1]},"
                f" dis={hist.dis_loss[-1]})")
        if eval_fn is not None and eval_every and (epoch + 1) % eval_every == 0:
            hist.acc.append((epoch + 1, eval_fn(student, student_spec)))
    return student, gen, hist


@torch.no_grad()
def evaluate(model: CNN, x: np.ndarray, y: np.ndarray,
             batch: int = 512) -> float:
    """Top-1 accuracy with eval-mode BN, on the model's device; one host
    sync at the end."""
    dev = _model_device(model)
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(0, len(y), batch):
        xb = torch.from_numpy(np.asarray(x[i:i + batch])).to(dev)
        yb = torch.from_numpy(np.asarray(y[i:i + batch])).to(dev)
        correct += (cnn_logits(model, xb).argmax(-1) == yb).sum()
    return int(correct) / len(y)
