"""The paper's one-shot FL baselines (§3.1.3; ``repro/fl/baselines.py``).

  FedDF    — ensemble distillation on a transfer set. With no proxy
             data in the data-free comparison it distills on uniform
             noise in [-1, 1).
  Fed-DAFL — DAFL's generator trained against the ensemble with one-hot
             CE, activation and information-entropy losses (no BN or
             boundary terms), then distilled from.
  Fed-ADI  — DeepInversion: input batches optimized directly with CE,
             BN-statistic, TV and L2 priors, then distilled from.

Every baseline distills with DENSE's own step (Eq. 6,
``core.dense.make_distill_step``) at the same student budget: s_steps
student steps an epoch, SGD at s_lr / s_momentum. That step takes its KL
through the execution policy, so on a CUDA device every baseline step
runs the K1 pair with the teacher gradient off. (The reference's
baselines call ``distill_loss`` in its ``ref`` mode whatever the policy;
the two modes compute the same function.)

Every baseline holds the frozen ensemble as the grouped teacher,
stacked once at setup (``core.ensemble.grouped_teacher``), as the
reference's do (``repro/fl/baselines.py:39-46``). Each
baseline takes an optional ``noise(epoch)`` source in place of its random
draws and optional initial models, as ``train_dense_server`` does, so
that the tests can inject the reference's ``jax.random`` draws. A
non-finite loss raises ``FloatingPointError`` at the end of its epoch
(the reference's baselines go on with it). The epoch driver
(``loop_mode``) is DENSE's: each baseline runs its own loop, whichever
the policy resolves, as the reference's do.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch import optim
from repro_torch.configs.backend import resolve_device
from repro_torch.core import losses as LS
from repro_torch.core.dense import check_clients_on, make_distill_step
from repro_torch.core.ensemble import Client, grouped_teacher
from repro_torch.core.generator import ImgGenerator, img_generator_init
from repro_torch.models.cnn import CNN, CNNSpec, cnn_init


def _student_spec(scfg) -> CNNSpec:
    return CNNSpec(kind=scfg.global_kind, num_classes=scfg.num_classes,
                   in_ch=scfg.in_ch, width=scfg.width,
                   image_size=scfg.image_size)


class _Run:
    """What every baseline sets up: the device, the grouped teacher, the
    student and its SGD, the shared distillation step, the random
    sources, and a device flag that every loss is ANDed into (read once
    an epoch)."""

    def __init__(self, name, clients, scfg, student_spec, *, device,
                 generator, init_generator):
        self.name, self.scfg = name, scfg
        self.dev = resolve_device(device)
        check_clients_on(clients, self.dev)
        self.spec = student_spec or _student_spec(scfg)
        self.init = init_generator if init_generator is not None \
            else torch.Generator().manual_seed(scfg.seed)
        self.draws = generator if generator is not None \
            else torch.Generator(device=self.dev).manual_seed(scfg.seed)
        self.teacher = grouped_teacher(clients)
        self.distill = make_distill_step(clients, scfg, device=self.dev,
                                         teacher=self.teacher)
        self.ok = torch.ones((), dtype=torch.bool, device=self.dev)

    def new_student(self, student: CNN | None) -> tuple:
        """The student (drawn from the init generator unless given) and
        its SGD."""
        if student is None:
            student = cnn_init(self.spec, generator=self.init,
                               device=self.dev)
        return student, optim.sgd(list(student.parameters()),
                                  self.scfg.s_lr,
                                  momentum=self.scfg.s_momentum)

    def track(self, loss: torch.Tensor) -> None:
        self.ok &= torch.isfinite(loss)

    def end_epoch(self, epoch: int) -> None:
        if not bool(self.ok):
            raise FloatingPointError(
                f"{self.name}: non-finite loss in epoch {epoch}")


# ------------------------------------------------------------------ FedDF --

def fed_df(clients: Sequence[Client], scfg,
           student_spec: CNNSpec | None = None, *, device="cuda",
           generator: torch.Generator | None = None,
           init_generator: torch.Generator | None = None,
           noise: Callable | None = None, student: CNN | None = None):
    """FedDF on noise. ``noise(epoch)`` gives the epoch's student inputs,
    (s_steps, synth_batch, H, W, C) in [-1, 1); by default drawn
    uniformly from ``generator`` (on the device, seeded ``scfg.seed``).
    The student is drawn from ``init_generator`` (CPU, seeded
    ``scfg.seed``) unless given, and trained in place.
    Returns (student, student_spec)."""
    run = _Run("fed_df", clients, scfg, student_spec, device=device,
               generator=generator, init_generator=init_generator)
    student, s_opt = run.new_student(student)
    if noise is None:
        shape = (scfg.s_steps, scfg.synth_batch, scfg.image_size,
                 scfg.image_size, scfg.in_ch)

        def noise(epoch):
            return torch.rand(shape, generator=run.draws,
                              device=run.dev) * 2.0 - 1.0

    for epoch in range(scfg.epochs):
        for x in noise(epoch):
            run.track(run.distill(student, s_opt, x))
        run.end_epoch(epoch)
    return student, run.spec


# --------------------------------------------------------------- Fed-DAFL --

def make_dafl_gen_step(clients: Sequence[Client], *, alpha: float = 0.1,
                       beta: float = 5.0, teacher: Callable | None = None):
    """Fed-DAFL's generator step: ``gen_step(gen, g_opt, z) -> loss``, one
    optimizer step on L_oh + α·L_a + β·L_ie against the ensemble
    (``teacher``, by default ``grouped_teacher(clients)``): CE on the
    ensemble's own argmax, −mean|D(x)|, and Σ p̄ log(p̄ + 1e-8) of the
    batch-mean softmax p̄ (the negative entropy)."""
    if teacher is None:
        teacher = grouped_teacher(clients)

    def gen_step(gen, g_opt, z):
        avg = teacher(gen(z))
        l_oh = LS.ce_loss(avg, avg.argmax(-1))
        l_a = -torch.mean(torch.abs(avg))
        mean_p = torch.mean(torch.softmax(avg, dim=-1), dim=0)
        l_ie = torch.sum(mean_p * torch.log(mean_p + 1e-8))
        total = l_oh + alpha * l_a + beta * l_ie
        g_opt.step(torch.autograd.grad(total, g_opt.params))
        return total.detach()

    return gen_step


def fed_dafl(clients: Sequence[Client], scfg,
             student_spec: CNNSpec | None = None, *, alpha: float = 0.1,
             beta: float = 5.0, device="cuda",
             generator: torch.Generator | None = None,
             init_generator: torch.Generator | None = None,
             noise: Callable | None = None, gen: ImgGenerator | None = None,
             student: CNN | None = None):
    """Fed-DAFL. Each epoch takes t_g Adam steps (g_lr) of the generator
    on the epoch's first latent batch, then s_steps student steps on the
    generator's images, step j on latent batch j. ``noise(epoch)`` gives
    those batches, (max(s_steps, 1), synth_batch, nz); by default normal
    draws from ``generator``. (The reference draws a fresh batch after
    each student step and drops the epoch's last one.) The generator,
    then the student, are drawn from ``init_generator`` unless given.
    Returns (student, student_spec)."""
    run = _Run("fed_dafl", clients, scfg, student_spec, device=device,
               generator=generator, init_generator=init_generator)
    if gen is None:
        gen = img_generator_init(nz=scfg.nz, img_size=scfg.image_size,
                                 out_ch=scfg.in_ch, generator=run.init,
                                 device=run.dev)
    student, s_opt = run.new_student(student)
    gen_step = make_dafl_gen_step(clients, alpha=alpha, beta=beta,
                                  teacher=run.teacher)
    g_opt = optim.adam(list(gen.parameters()), scfg.g_lr)
    if noise is None:
        shape = (max(scfg.s_steps, 1), scfg.synth_batch, scfg.nz)

        def noise(epoch):
            return torch.randn(shape, generator=run.draws, device=run.dev)

    for epoch in range(scfg.epochs):
        zs = noise(epoch)
        for _ in range(scfg.t_g):
            run.track(gen_step(gen, g_opt, zs[0]))
        for j in range(scfg.s_steps):
            with torch.no_grad():
                x = gen(zs[j])
            run.track(run.distill(student, s_opt, x))
        run.end_epoch(epoch)
    return student, run.spec


# ---------------------------------------------------------------- Fed-ADI --

def make_adi_step(clients: Sequence[Client], *, tv_coef: float = 1e-4,
                  l2_coef: float = 1e-5, bn_coef: float = 1.0,
                  teacher: Callable | None = None):
    """Fed-ADI's input step: ``adi_step(x_opt, y) -> loss``. ``x_opt`` is
    an optimizer over the one input batch x (B, H, W, C), leaf of
    autograd; one step on L_CE(D(x), y) + bn_coef·L_BN + tv_coef·L_TV +
    l2_coef·mean(x²) against the ensemble (``teacher``, by default
    ``grouped_teacher(clients)``), L_TV the mean squared difference of
    neighbours along H plus along W; then x is clipped to [-1, 1] in
    place."""
    if teacher is None:
        teacher = grouped_teacher(clients)

    def adi_step(x_opt, y):
        (x,) = x_opt.params
        avg, stats = teacher(x, with_bn_stats=True)
        dh = x[:, 1:] - x[:, :-1]
        dw = x[:, :, 1:] - x[:, :, :-1]
        l_tv = torch.mean(dh * dh) + torch.mean(dw * dw)
        loss = (LS.ce_loss(avg, y) + bn_coef * LS.bn_loss(stats)
                + tv_coef * l_tv + l2_coef * torch.mean(x * x))
        x_opt.step(torch.autograd.grad(loss, [x]))
        with torch.no_grad():
            x.clamp_(-1.0, 1.0)
        return loss.detach()

    return adi_step


def fed_adi(clients: Sequence[Client], scfg,
            student_spec: CNNSpec | None = None, *, adi_lr: float = 0.05,
            tv_coef: float = 1e-4, l2_coef: float = 1e-5,
            bn_coef: float = 1.0, refresh_every: int = 20, device="cuda",
            generator: torch.Generator | None = None,
            init_generator: torch.Generator | None = None,
            noise: Callable | None = None, student: CNN | None = None):
    """Fed-ADI. At every epoch with ``epoch % refresh_every == 0`` (epoch
    0 included) a new input batch and its labels are drawn and a new Adam
    (adi_lr) starts on it; each epoch takes t_g input steps, then s_steps
    student steps on the current batch. ``noise(epoch)`` gives the
    refreshed (x, y), x (synth_batch, H, W, C), y (synth_batch,); by
    default x = 0.5·N(0, 1) and y uniform over the classes, from
    ``generator``. Returns (student, student_spec)."""
    if refresh_every < 1:
        raise ValueError(f"refresh_every must be >= 1, got {refresh_every}")
    run = _Run("fed_adi", clients, scfg, student_spec, device=device,
               generator=generator, init_generator=init_generator)
    student, s_opt = run.new_student(student)
    adi_step = make_adi_step(clients, tv_coef=tv_coef, l2_coef=l2_coef,
                             bn_coef=bn_coef, teacher=run.teacher)
    if noise is None:
        shape = (scfg.synth_batch, scfg.image_size, scfg.image_size,
                 scfg.in_ch)

        def noise(epoch):
            x = torch.randn(shape, generator=run.draws, device=run.dev)
            y = torch.randint(0, scfg.num_classes, (scfg.synth_batch,),
                              generator=run.draws, device=run.dev)
            return x * 0.5, y

    for epoch in range(scfg.epochs):
        if epoch % refresh_every == 0:
            x0, y = noise(epoch)
            x = x0.detach().clone().requires_grad_(True)
            y = y.long()
            x_opt = optim.adam([x], adi_lr)
        for _ in range(scfg.t_g):
            run.track(adi_step(x_opt, y))
        for _ in range(scfg.s_steps):
            run.track(run.distill(student, s_opt, x.detach()))
        run.end_epoch(epoch)
    return student, run.spec
