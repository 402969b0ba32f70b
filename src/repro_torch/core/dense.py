"""DENSE two-stage server training (Algorithm 1; ``repro/core/dense.py``).

Stage 1 (data generation): T_G generator steps per epoch minimizing
L_gen = L_CE + λ1·L_BN + λ2·L_div against the frozen client ensemble and
the current student, whose decision boundary defines L_div.

Stage 2 (model distillation): a student step on the same latent batch
minimizing KL(D(x̂) ‖ f_S(x̂)).

The frozen ensemble is held in the grouped representation, stacked once
at setup (``core/ensemble.grouped_teacher``, in slices of the policy's
``stack_chunk``) and evaluated with ``grouped_ensemble_logits``, one
network a client architecture, streamed in slices of ``teacher_chunk``
clients when that is set, as the reference's server holds it. With
``ensemble_shard_mode="clients"`` the teacher runs on the client mesh
(``fl.sharding.resolve_mesh``, ``repro/core/dense.py:104-127``): each
rank holds its own clients of every group the axis divides, and the
group sums are all-reduced over it (``core/ensemble.py``); on the card
the fused driver captures those all-reduces in its graph. Both KL
sites go through the mode the execution policy resolves
(``configs/backend.py``): on a CUDA device the K1 kernel pair, with the
teacher gradient on in the generator step (L_div) and off in the
student step (L_dis).

Two epoch drivers, as the reference has them (the policy's ``loop``;
``scfg.loop_mode`` pins one):

  * ``"python"`` (the cpu profile's) — one epoch at a time, eagerly,
    the losses read on the host after each.
  * ``"fused"`` (the cuda profile's) — chunks of ``scfg.loop_chunk``
    epochs (``_chunk_bounds``: a chunk never crosses an eval or
    checkpoint boundary), each epoch's losses stacked on the device and
    read once a chunk. On the card the first epoch of the run runs
    eagerly, as the warm-up (Triton compiles K1, cuDNN picks its
    algorithms), then one epoch of t_g generator steps and s_steps
    student steps is captured as a CUDA graph (``core/graph.py``) and
    replayed for every later epoch of every chunk; on the CPU the same
    chunks run eagerly. Each epoch's latents are drawn outside the graph,
    with ``noise(epoch)``, into static buffers, so the latent stream is
    the python driver's. Adam's count lives on the device
    (``optim.adam.count_on_device``), so that each replay takes its own
    bias corrections. The two drivers give the same student, generator
    and losses bit for bit on the CPU.

Self-healing and resume (DESIGN.md §10), as the reference has them:
``scfg.nan_policy`` ``"raise"`` (a non-finite loss stops the run at the
end of its epoch, or of its chunk under the fused driver, naming it),
``"skip"`` (each step guards its own update on the device: a step whose
loss or gradient norm is not finite changes no parameter, optimizer
state or BN running statistic) and ``"rollback"`` (a bad epoch is undone
from a snapshot of the last good one; under the fused driver a chunk
with a bad epoch is undone whole, from a snapshot taken before it, and
the history keeps all its epochs); ``scfg.checkpoint_every`` /
``checkpoint_path`` save the full server state every N epochs and
restore it on entry. Snapshots, restores and checkpoint loads copy in
place, so a captured graph goes on reading the live tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import (checkpoint_exists, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.backend import resolve_device, resolve_exec_policy
from repro_torch.core import losses as LS
from repro_torch.core.ensemble import Client, grouped_teacher
from repro_torch.core.generator import img_generator_init
from repro_torch.core.graph import CapturedEpoch
from repro_torch.models.cnn import CNN, CNNSpec, cnn_apply, cnn_init, cnn_logits


@dataclass
class DenseHistory:
    gen_loss: list = field(default_factory=list)
    gen_parts: list = field(default_factory=list)
    dis_loss: list = field(default_factory=list)
    acc: list = field(default_factory=list)
    # how the run went: its epoch driver, the host reads of its losses,
    # and on the card under the fused driver the graph's replays and the
    # seconds its capture took
    loop: str = "python"
    host_reads: int = 0
    graph_replays: int = 0
    capture_seconds: float | None = None


NAN_POLICIES = ("raise", "skip", "rollback")


def _check_nan_policy(scfg) -> str:
    nan_policy = getattr(scfg, "nan_policy", "raise")
    if nan_policy not in NAN_POLICIES:
        raise ValueError(f"unknown nan_policy {nan_policy!r} "
                         "(expected 'raise', 'skip' or 'rollback')")
    return nan_policy


def _finite(loss: torch.Tensor, grads) -> torch.Tensor:
    """The skip guard, a 0-d bool on the device: the loss and the
    gradients' global norm are finite."""
    return torch.isfinite(loss) & torch.isfinite(optim.global_norm(grads))


def make_dense_steps(clients: Sequence[Client], scfg, *, use_bn: bool = True,
                     use_div: bool = True, device="cuda",
                     teacher: Callable | None = None,
                     nan_guard: bool = False, mesh=None):
    """The two steps of an epoch, closed over the frozen ensemble:
    ``teacher(x, with_bn_stats=False)``, by default the grouped teacher
    (``grouped_teacher``, stacked here once, with the policy's
    ``teacher_chunk`` and ``stack_chunk``, as the reference's
    ``make_dense_steps`` reads them).

    Returns (gen_step, student_step):

      * ``gen_step(gen, g_opt, student, z, y) -> (loss, parts)`` takes one
        Adam step of the generator;
      * ``student_step(student, s_opt, gen, z) -> loss`` takes one SGD
        step of the student and updates its BN running statistics.

    Losses come back as 0-d tensors on the device (no host sync). Only
    the optimizer's own tensors get gradients (``torch.autograd.grad``),
    so the clients and, in the generator step, the student are left as
    they are. ``use_bn`` / ``use_div=False`` are the paper's ablations
    (Table 6). ``nan_guard`` (``nan_policy="skip"``) guards each update
    on the device (``_finite``, ``optim``'s ``step_if``); without it the
    steps launch what they launched before the guard existed. ``mesh``
    (default: ``fl.sharding.resolve_mesh`` of the policy) shards the
    teacher's client groups.
    """
    pol = resolve_exec_policy(scfg, device=device)
    kl_mode = pol.distill_kl
    if teacher is None:
        if mesh is None:
            from repro_torch.fl.sharding import resolve_mesh
            mesh = resolve_mesh(pol, device=device)
        teacher = grouped_teacher(clients, chunk=pol.teacher_chunk,
                                  stack_chunk=pol.stack_chunk, mesh=mesh)

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
        grads = torch.autograd.grad(total, g_opt.params)
        if nan_guard:
            g_opt.step_if(grads, _finite(total, grads))
        else:
            g_opt.step(grads)
        return total.detach(), {"ce": l_ce.detach(), "bn": l_bn.detach(),
                                "div": l_div.detach()}

    distill_step = make_distill_step(clients, scfg, device=device,
                                     teacher=teacher, nan_guard=nan_guard)

    def student_step(student, s_opt, gen, z):
        with torch.no_grad():
            x = gen(z)
        return distill_step(student, s_opt, x)

    return gen_step, student_step


def make_distill_step(clients: Sequence[Client], scfg, *, device="cuda",
                      teacher: Callable | None = None,
                      nan_guard: bool = False, mesh=None):
    """The distillation step of Eq. (6), shared by DENSE's stage 2 and
    the one-shot baselines (``fl/baselines.py``).

    Returns ``step(student, s_opt, x) -> loss``: one SGD step of the
    student on KL(D(x) ‖ f_S(x)) over the images x, with its BN running
    statistics updated in place. The ensemble is ``teacher`` (by default
    ``grouped_teacher`` with the policy's chunks, stacked here, on
    ``mesh`` or the policy's) and runs without
    autograd, its eval BN folded into its convs; the KL goes through the
    mode the execution policy resolves, without the teacher-side
    gradient (the kernel's dL/dt stream is skipped). With ``nan_guard``
    a step whose loss or gradient norm is not finite leaves the student,
    its BN running statistics and the optimizer as they were, decided on
    the device.
    """
    pol = resolve_exec_policy(scfg, device=device)
    kl_mode = pol.distill_kl
    if teacher is None:
        if mesh is None:
            from repro_torch.fl.sharding import resolve_mesh
            mesh = resolve_mesh(pol, device=device)
        teacher = grouped_teacher(clients, chunk=pol.teacher_chunk,
                                  stack_chunk=pol.stack_chunk, mesh=mesh)

    def step(student, s_opt, x):
        with torch.no_grad():
            avg = teacher(x)
        if nan_guard:
            stats = list(student.buffers())
            before = [b.clone() for b in stats]
        logits, _ = cnn_apply(student, x, train=True, with_stats=False)
        loss = LS.distill_loss(avg, logits, mode=kl_mode,
                               with_teacher_grad=False)
        grads = torch.autograd.grad(loss, s_opt.params)
        if nan_guard:
            ok = _finite(loss, grads)
            s_opt.step_if(grads, ok)
            with torch.no_grad():
                for b, old in zip(stats, before):
                    b.copy_(torch.where(ok, b, old))
        else:
            s_opt.step(grads)
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


# ------------------------------------------------- server state, on disk --

RNG_KEY = "rng"


def server_state(gen, g_opt, student, s_opt, epoch: int,
                 generator: torch.Generator | None = None) -> dict:
    """The server's full state as the reference's checkpoint names it:
    ``gen_p`` and ``stu_p`` (BN statistics included) in the reference's
    layouts (``interop``), ``g_state`` (Adam's m, v by parameter name,
    and t), ``s_state`` (the momentum, zero for the BN statistics, as
    the reference's SGD state holds them) and ``epoch``. The latent
    source's state, when the run draws its own, goes under ``rng``: the
    reference keeps a key there instead."""
    from repro_torch import interop
    names = [n for n, _ in gen.named_parameters()]
    state = {"gen_p": interop.generator_to_ref(gen),
             "g_state": {"m": interop.state_to_ref(dict(zip(names, g_opt.m))),
                         "v": interop.state_to_ref(dict(zip(names, g_opt.v))),
                         "t": np.asarray(g_opt.count(), np.int32)},
             "stu_p": interop.cnn_to_ref(student),
             "s_state": {},
             "epoch": np.asarray(epoch, np.int64)}
    if s_opt.bufs is not None:
        momentum = {n: torch.zeros_like(b)
                    for n, b in student.net.named_buffers()}
        momentum.update(zip((n for n, _ in student.net.named_parameters()),
                            s_opt.bufs))
        state["s_state"] = interop.state_to_ref(momentum)
    if generator is not None:
        state[RNG_KEY] = generator.get_state().numpy()
    return state


@torch.no_grad()
def load_server_state(state: dict, gen, g_opt, student, s_opt,
                      generator: torch.Generator | None = None) -> int:
    """Copy a ``server_state`` tree (as ``restore_checkpoint`` gives it
    back) into the live models, optimizers and latent source; returns
    the epochs it had done."""
    from repro_torch import interop
    interop.load_ref(gen, state["gen_p"])
    interop.load_ref(student, state["stu_p"])
    names = [n for n, _ in gen.named_parameters()]
    for key, dst in (("m", g_opt.m), ("v", g_opt.v)):
        got = interop.ref_to_state(state["g_state"][key])
        for n, t in zip(names, dst, strict=True):
            t.copy_(got[n])
    g_opt.set_count(int(state["g_state"]["t"]))
    if s_opt.bufs is not None:
        got = interop.ref_to_state(state["s_state"])
        for (n, _), t in zip(student.net.named_parameters(), s_opt.bufs,
                             strict=True):
            t.copy_(got[n])
    if generator is not None:
        generator.set_state(torch.from_numpy(state[RNG_KEY]))
    return int(state["epoch"])


def load_server_models(path: str, gen, student) -> None:
    """Load a server checkpoint's generator and student (``gen_p``,
    ``stu_p``) into ``gen`` and ``student``: the port's files and the
    reference's alike."""
    from repro_torch import interop
    from repro_torch.checkpoint import load_tree
    interop.load_ref(gen, load_tree(path, "gen_p"))
    interop.load_ref(student, load_tree(path, "stu_p"))


def _check_resumable(path: str, own_rng: bool) -> None:
    with np.load(path if path.endswith(".npz") else path + ".npz") as f:
        files = set(f.files)
    if "key" in files and RNG_KEY not in files:
        raise ValueError(
            f"{path} is a server checkpoint of the JAX reference: its "
            "epochs draw from a jax.random key, which this port cannot "
            "replay, so it cannot resume that run (load_server_models "
            "reads its generator and student)")
    if own_rng != (RNG_KEY in files):
        raise ValueError(
            f"{path} was saved by a run that "
            f"{'drew' if RNG_KEY in files else 'was given'} its latents, "
            f"and this run {'draws' if own_rng else 'is given'} them: "
            "resume it as it was started")


@torch.no_grad()
def _snapshot(gen, g_opt, student, s_opt) -> dict:
    """A copy of everything an epoch changes (``nan_policy="rollback"``),
    Adam's count included wherever it lives (no host read)."""
    return {"gen": {k: v.clone() for k, v in gen.state_dict().items()},
            "stu": {k: v.clone() for k, v in student.state_dict().items()},
            "m": [t.clone() for t in g_opt.m],
            "v": [t.clone() for t in g_opt.v],
            "t": g_opt.t if g_opt.t_dev is None else g_opt.t_dev.clone(),
            "bufs": [t.clone() for t in s_opt.bufs or ()]}


@torch.no_grad()
def _restore(snap: dict, gen, g_opt, student, s_opt) -> None:
    """Put a ``_snapshot`` back, every tensor in place."""
    gen.load_state_dict(snap["gen"])
    student.load_state_dict(snap["stu"])
    for dst, src in ((g_opt.m, snap["m"]), (g_opt.v, snap["v"]),
                     (s_opt.bufs or [], snap["bufs"])):
        for d, t in zip(dst, src, strict=True):
            d.copy_(t)
    if g_opt.t_dev is None:
        g_opt.t = snap["t"]
    else:
        g_opt.t_dev.copy_(snap["t"])


def _chunk_bounds(epochs: int, chunk: int, eval_every: int,
                  ckpt_every: int = 0, start: int = 0):
    """[start, epochs) in chunks of at most ``chunk`` epochs, none
    crossing an eval or checkpoint boundary (0 disables either kind), as
    ``repro/core/dense.py:241-258`` bounds them: the bounds after a
    checkpoint are the same whether the run started at 0 or resumed
    there, so a resumed fused run replays the same chunks."""
    bounds, e = [], start
    while e < epochs:
        nxt = min(e + chunk, epochs)
        if eval_every:
            nxt = min(nxt, ((e // eval_every) + 1) * eval_every)
        if ckpt_every:
            nxt = min(nxt, ((e // ckpt_every) + 1) * ckpt_every)
        bounds.append((e, nxt))
        e = nxt
    return bounds


class _EpochRunner:
    """One epoch of Algorithm 1 (t_g generator steps, then s_steps student
    steps) on static latent buffers. ``epoch(z, y, extra, replay)``
    copies the latents in and returns the epoch's losses as one (5,)
    float32 tensor on the device: gen_loss, its ce, bn and div parts,
    and dis_loss. With ``replay`` on the card (the fused driver) the
    first call runs eagerly on a side stream, as the warm-up a capture
    wants, the second captures the epoch (``CapturedEpoch``) and every
    call from then on replays it; otherwise the epoch runs eagerly."""

    def __init__(self, steps, models, z, y, extra, t_g: int):
        self.steps, self.models, self.t_g = steps, models, t_g
        self.z, self.y, self.extra = (torch.empty_like(t)
                                      for t in (z, y, extra))
        self.warm = False
        self.graph: CapturedEpoch | None = None

    def _run(self):
        gen_step, student_step = self.steps
        gen, g_opt, student, s_opt = self.models
        for _ in range(self.t_g):
            gl, parts = gen_step(gen, g_opt, student, self.z, self.y)
        dl = student_step(student, s_opt, gen, self.z)
        for z_i in self.extra:          # s_steps > 1 (beyond the paper)
            dl = student_step(student, s_opt, gen, z_i)
        return torch.stack([gl, parts["ce"], parts["bn"], parts["div"],
                            dl]).float()

    def epoch(self, z, y, extra, replay: bool) -> torch.Tensor:
        for dst, src in ((self.z, z), (self.y, y), (self.extra, extra)):
            dst.copy_(src)
        if not (replay and self.z.is_cuda):
            return self._run()
        if self.warm:
            if self.graph is None:
                self.graph = CapturedEpoch(self._run)
            return self.graph.replay().clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = self._run()
        main = torch.cuda.current_stream()
        main.wait_stream(side)
        out.record_stream(main)
        self.warm = True
        return out


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
                       eval_every: int = 0,
                       _poison_epochs=(), _stop_after_epoch: int = 0):
    """Run Algorithm 1. Returns (student, gen, history).

    ``noise(epoch) -> (z, y, extra)`` gives each epoch's latent batch
    z (synth_batch, nz), its labels y (synth_batch,) and the latents of
    the extra student steps, extra (s_steps − 1, synth_batch, nz); the
    tests inject the reference's draws through it. By default they are
    drawn from ``generator``, a ``torch.Generator`` on ``device`` seeded
    with ``scfg.seed``, in epoch order. ``gen`` / ``student`` are the
    initial generator and student; when None they are drawn from
    ``init_generator`` (a CPU generator, seeded ``scfg.seed``). The
    student is trained in place.

    The epoch driver is the policy's ``loop`` (module doc): ``"python"``
    on the CPU, ``"fused"`` on the card, ``scfg.loop_mode`` to pin one;
    the fused driver runs chunks of ``scfg.loop_chunk`` epochs
    (``_chunk_bounds``), one host read a chunk. The history says which
    driver ran, its host reads and, on the card, the graph's replays and
    capture seconds.

    ``scfg.nan_policy`` says what a non-finite generator or student loss
    means: ``"raise"`` (``FloatingPointError`` at the end of its epoch,
    or of its chunk under the fused driver, naming the epochs),
    ``"skip"`` (the bad step changes nothing, decided on the device;
    the epoch's losses are recorded as they were) or ``"rollback"`` (the
    epoch is undone from a snapshot of the last good one; under the
    fused driver its whole chunk, the history keeping all of it).

    With ``scfg.checkpoint_every`` > 0 and ``scfg.checkpoint_path`` set,
    the full server state (``server_state``) is saved every N epochs and
    a checkpoint at that path is restored on entry: the run goes on from
    the epoch after it, with the latent source's state restored, so it
    replays the remaining epochs exactly; the history covers only those.
    A reference server checkpoint cannot be resumed (``ValueError``).

    ``_poison_epochs`` / ``_stop_after_epoch`` are test hooks: NaN-fill
    the listed epochs' latent batch, and return after that many epochs
    (under the fused driver, at the end of the chunk that reaches it),
    before the checkpoint is saved (a killed run).
    """
    dev = resolve_device(device)
    nan_policy = _check_nan_policy(scfg)
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
    else:
        generator = None                # the caller's source: not saved

    gen_step, student_step = make_dense_steps(
        clients, scfg, use_bn=use_bn, use_div=use_div, device=dev,
        nan_guard=nan_policy == "skip")
    g_opt = optim.adam(list(gen.parameters()), scfg.g_lr)
    s_opt = optim.sgd(list(student.parameters()), scfg.s_lr,
                      momentum=scfg.s_momentum)

    ck_every = int(getattr(scfg, "checkpoint_every", 0) or 0)
    ck_path = getattr(scfg, "checkpoint_path", "") or ""
    ckpt_on = bool(ck_every and ck_path)
    start_epoch = 0
    if ckpt_on and checkpoint_exists(ck_path):
        _check_resumable(ck_path, generator is not None)
        like = server_state(gen, g_opt, student, s_opt, 0, generator)
        start_epoch = load_server_state(restore_checkpoint(ck_path, like),
                                        gen, g_opt, student, s_opt,
                                        generator)

    loop = resolve_exec_policy(scfg, device=dev).loop
    hist = DenseHistory(loop=loop)
    poison = frozenset(_poison_epochs or ())
    fused = loop == "fused"
    if fused:
        g_opt.count_on_device()
        bounds = _chunk_bounds(scfg.epochs,
                               max(1, int(getattr(scfg, "loop_chunk", 8))),
                               eval_every, ck_every if ckpt_on else 0,
                               start_epoch)
    else:
        bounds = [(e, e + 1) for e in range(start_epoch, scfg.epochs)]
    runner = None

    def losses(epoch):
        nonlocal runner
        z, y, extra = noise(epoch)
        if epoch in poison:
            z = torch.full_like(z, float("nan"))
        if runner is None:
            runner = _EpochRunner((gen_step, student_step),
                                  (gen, g_opt, student, s_opt), z, y, extra,
                                  scfg.t_g)
        return runner.epoch(z, y, extra, replay=fused)

    for lo, hi in bounds:
        # a chunk (python driver: an epoch) is undone whole if bad
        snap = _snapshot(gen, g_opt, student, s_opt) \
            if nan_policy == "rollback" else None
        rows = torch.stack([losses(e) for e in range(lo, hi)]).tolist()
        hist.host_reads += 1                # one read a chunk
        if runner.graph is not None:
            hist.graph_replays = runner.graph.replays
            hist.capture_seconds = runner.graph.capture_seconds
        bad = False
        for gl, ce, bn, div, dl in rows:
            hist.gen_loss.append(gl)
            hist.gen_parts.append({"ce": ce, "bn": bn, "div": div})
            hist.dis_loss.append(dl)
            bad |= not (np.isfinite(gl) and np.isfinite(dl))
        if bad and nan_policy == "raise":
            where = f"epoch {lo}" if hi - lo == 1 else f"epochs [{lo}, {hi})"
            raise FloatingPointError(
                f"non-finite loss at {where} (gen={hist.gen_loss[lo - hi:]}, "
                f"dis={hist.dis_loss[lo - hi:]}); set "
                "scfg.nan_policy='skip' or 'rollback' to self-heal")
        if bad and nan_policy == "rollback":
            _restore(snap, gen, g_opt, student, s_opt)
        if eval_fn is not None and eval_every and hi % eval_every == 0:
            hist.acc.append((hi, eval_fn(student, student_spec)))
        if _stop_after_epoch and hi >= _stop_after_epoch:
            return student, gen, hist       # a killed run: no save
        if ckpt_on and hi % ck_every == 0:
            save_checkpoint(ck_path, server_state(gen, g_opt, student, s_opt,
                                                  hi, generator),
                            meta={"epoch": hi, "epochs": int(scfg.epochs)})
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
