"""Run the PyTorch port of DENSE on one CUDA card and check it.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one NVIDIA card (an H100
is the target). Needs ``torch`` built for CUDA and ``triton``; the
kernels are built from the sources in the checkout, with Triton's cache
under ``build/triton``. It imports ``repro_torch`` and nothing of JAX.

Phases; any failure exits non-zero before the result line is printed:

  1. setup: the card's name and power limit (``nvidia-smi``), no TF32 in
     matrix products or convolutions (full float32, as the JAX reference
     computes);
  2. kernels: K1f and K1b (both teacher-gradient settings) against their
     plain PyTorch versions at the main path's shape (128, 10), a ragged
     (1000, 32003) and a vocabulary-scale (4096, 32768), in float32 and
     bfloat16, each timed with CUDA events beside the plain version and
     its bound;
  3. the main path at the paper's full width (``paper_cifar.CONFIG``:
     five width-1.0 resnet18 clients on 32x32x3 images, batch 128,
     synth_batch 128, nz 100, t_g 30), depth cut to one local epoch and
     two server epochs: ``build_federation`` → ``fedavg`` →
     ``train_dense_server`` → ``evaluate``. The K1 launch counts are
     zeroed just before it and must each read epochs·(t_g + s_steps)
     just after;
  4. one server epoch of the main path under ``torch.profiler``: device
     busy share and kernel time by name;
  5. one server step of a small federation on the card (K1 kernels) and
     on the CPU (the plain ``ref`` KL) from the same weights and images:
     the losses, their gradient with respect to the images and the
     student's update must agree to 1e-4 (the CPU path is held to the JAX
     package by the tests).

Output: a line with the card's name and power limit, one JSON line per
phase, the ``{"kernels": [...]}`` line, and last the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SHAPES = ((128, 10), (1000, 32003), (4096, 32768))     # (R, V)
MAIN_SHAPE = (128, 10)
# f32: the kernel and its plain version differ only in summation order.
# bf16 inputs: both upcast the same values and compute in float32, so the
# float32 outputs (kl, lse) keep 1e-5; the gradients are stored in
# bfloat16, where one rounding on either side of a boundary is one ulp
# (2^-8 relative): two ulps of slack.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 1e-5)}
TOL_GRAD = {"float32": (1e-5, 1e-5), "bfloat16": (1.6e-2, 1e-6)}
STEP_TOL = 1e-4


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------- setup --

def setup():
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi did not report the card: {e!r}")
    print(smi, flush=True)
    precision = full_float32(torch)
    import triton

    emit({"setup": {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "float32_precision": precision,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "triton": triton.__version__, "python": sys.version.split()[0]}})
    return torch, smi


def full_float32(torch) -> dict:
    """No TF32 in matrix products or convolutions, forward or backward:
    float32 as the JAX reference computes it. Recent torch keeps a
    precision per backend and operation, with TF32 the default for cuDNN
    convolutions; the legacy ``allow_tf32`` flags are for older torch."""
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}
    torch.backends.fp32_precision = "ieee"
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.fp32_precision = "ieee"
    conv.fp32_precision = "ieee"
    return {"generic": torch.backends.fp32_precision,
            "cuda_matmul": torch.backends.cuda.matmul.fp32_precision,
            "cudnn": torch.backends.cudnn.fp32_precision,
            "cudnn_conv": conv.fp32_precision}


# -------------------------------------------------------------- kernels --

def cuda_ms(torch, fn, samples: int = 21) -> float:
    """Median over ``samples`` of the per-call time of a run of calls,
    from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    inner = max(1, min(20, int(2e-3 / max(time.perf_counter() - t0, 1e-6))))
    times = []
    for _ in range(samples):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def compare(torch, got, want, tol):
    rtol, atol = tol
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return ok, float(err.max())


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(torch):
    from repro_torch.kernels import distill_kl as K

    rows = {"fwd": [], "bwd": []}
    for R, V in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            gen = torch.Generator(device="cuda").manual_seed(R + V)
            t = (torch.randn(R, V, device="cuda", generator=gen) * 3).to(dtype)
            s = (torch.randn(R, V, device="cuda", generator=gen) * 3).to(dtype)
            g = torch.rand(R, device="cuda", generator=gen)
            isz = t.element_size()

            kl, lse_t, lse_s = K.distill_kl_fwd(t, s)
            torch.cuda.synchronize()
            plain = K.distill_kl_fwd_plain(t, s)
            checks = [compare(torch, a, b, TOL[dname])
                      for a, b in zip((kl, lse_t, lse_s), plain)]
            b_ms, b_by = bound(2 * R * V * isz + 3 * R * 4, 11 * R * V)
            rows["fwd"].append({
                "shape": [R, V], "dtype": dname,
                "ok": all(c[0] for c in checks),
                "max_abs_err": max(c[1] for c in checks),
                "tol": TOL[dname],
                "ms": cuda_ms(torch, lambda: K.distill_kl_fwd(t, s)),
                "plain_ms": cuda_ms(torch,
                                    lambda: K.distill_kl_fwd_plain(t, s)),
                "bound_ms": b_ms, "bound_by": b_by})

            for wtg in (True, False):
                out = K.distill_kl_bwd(t, s, lse_t, lse_s, kl, g,
                                       with_teacher_grad=wtg)
                torch.cuda.synchronize()
                want = K.distill_kl_bwd_plain(t, s, lse_t, lse_s, kl, g,
                                              with_teacher_grad=wtg)
                checks = [compare(torch, a, b, TOL_GRAD[dname])
                          for a, b in zip(out, want) if b is not None]
                n_out = 2 if wtg else 1
                b_ms, b_by = bound(
                    (2 + n_out) * R * V * isz + (4 if wtg else 3) * R * 4,
                    (10 if wtg else 6) * R * V)
                rows["bwd"].append({
                    "shape": [R, V], "dtype": dname,
                    "with_teacher_grad": wtg,
                    "ok": all(c[0] for c in checks),
                    "max_abs_err": max(c[1] for c in checks),
                    "tol": TOL_GRAD[dname],
                    "ms": cuda_ms(torch, lambda: K.distill_kl_bwd(
                        t, s, lse_t, lse_s, kl, g, with_teacher_grad=wtg)),
                    "plain_ms": cuda_ms(torch, lambda: K.distill_kl_bwd_plain(
                        t, s, lse_t, lse_s, kl, g, with_teacher_grad=wtg)),
                    "bound_ms": b_ms, "bound_by": b_by})
            del t, s, g, kl, lse_t, lse_s, plain
            torch.cuda.empty_cache()
    for name, rs in rows.items():
        for r in rs:
            emit({"kernel_check": {"name": f"distill_kl_{name}", **r}})
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks disagree with the plain versions: "
             f"{bad}")
    return rows


# ------------------------------------------------------------ main path --

def main_path(torch, scfg, dev="cuda"):
    from repro_torch.core import evaluate, train_dense_server
    from repro_torch.data import make_classification_data
    from repro_torch.fl import CommLedger, build_federation, fedavg
    from repro_torch.kernels import distill_kl as K

    data = make_classification_data(
        scfg.seed, num_classes=scfg.num_classes, size=scfg.image_size,
        ch=scfg.in_ch, train_per_class=scfg.train_per_class,
        test_per_class=scfg.test_per_class)
    xt, yt = data["test"]

    def timed(fn):
        sync(torch, dev)
        t0 = time.perf_counter()
        out = fn()
        sync(torch, dev)
        return out, time.perf_counter() - t0

    ledger = CommLedger()
    for k in K.launches:
        K.launches[k] = 0
    (clients, _), t_fed = timed(lambda: build_federation(
        scfg, data, device=dev, ledger=ledger, seed=scfg.seed))
    avg, t_avg = timed(lambda: fedavg(clients))
    (student, _, hist), t_dense = timed(lambda: train_dense_server(
        clients, scfg, device=dev))
    acc_dense, t_eval = timed(lambda: evaluate(student, xt, yt))
    launches = dict(K.launches)

    want = scfg.epochs * (scfg.t_g + scfg.s_steps)
    # a CPU run (a rehearsal) takes the plain versions and launches nothing
    if torch.device(dev).type == "cuda" and \
            launches != {"distill_kl_fwd": want, "distill_kl_bwd": want}:
        fail(f"K1 launches on the main path {launches}, expected {want} each")
    losses = hist.gen_loss + hist.dis_loss + [
        v for p in hist.gen_parts for v in p.values()]
    if len(hist.gen_loss) != scfg.epochs or not all(
            map(lambda v: v == v and abs(v) != float("inf"), losses)):
        fail(f"main-path losses are not finite: {hist}")
    if ledger.rounds != 1 or ledger.downlink_bytes != 0:
        fail(f"not one-shot: {ledger.rounds} rounds, "
             f"{ledger.downlink_bytes} B down")
    acc_clients = [evaluate(c.model, xt, yt) for c in clients]
    acc_avg = evaluate(avg, xt, yt)
    if not all(0.0 <= a <= 1.0 for a in acc_clients + [acc_avg, acc_dense]):
        fail("accuracy out of [0, 1]")
    emit({"main_path": {
        "seconds": {"build_federation": t_fed, "fedavg": t_avg,
                    "train_dense_server": t_dense,
                    "dense_per_epoch": t_dense / scfg.epochs,
                    "evaluate": t_eval},
        "launches": launches, "expected_launches_each": want,
        "uplink_bytes": ledger.uplink_bytes, "rounds": ledger.rounds,
        "acc": {"clients": acc_clients, "fedavg": acc_avg,
                "dense": acc_dense},
        "gen_loss": hist.gen_loss, "dis_loss": hist.dis_loss,
        "gen_parts": hist.gen_parts,
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if torch.device(dev).type == "cuda" else None)}})
    return clients, launches


# -------------------------------------------------------------- profile --

def profile_epoch(torch, scfg, clients, dev="cuda"):
    """One server epoch (t_g generator steps, s_steps student steps) of the
    main path under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import optim
    from repro_torch.core import img_generator_init, make_dense_steps
    from repro_torch.models import CNNSpec, cnn_init

    spec = CNNSpec(kind=scfg.global_kind, num_classes=scfg.num_classes,
                   in_ch=scfg.in_ch, width=scfg.width,
                   image_size=scfg.image_size)
    init = torch.Generator().manual_seed(1)
    gen = img_generator_init(nz=scfg.nz, img_size=scfg.image_size,
                             out_ch=scfg.in_ch, generator=init, device=dev)
    student = cnn_init(spec, generator=init, device=dev)
    gen_step, student_step = make_dense_steps(clients, scfg, device=dev)
    g_opt = optim.adam(list(gen.parameters()), scfg.g_lr)
    s_opt = optim.sgd(list(student.parameters()), scfg.s_lr,
                      momentum=scfg.s_momentum)
    noise = torch.Generator(device=dev).manual_seed(2)
    z = torch.randn((scfg.synth_batch, scfg.nz), device=dev,
                    generator=noise)
    y = torch.randint(0, scfg.num_classes, (scfg.synth_batch,),
                      device=dev, generator=noise)

    def epoch():
        for _ in range(scfg.t_g):
            gen_step(gen, g_opt, student, z, y)
        student_step(student, s_opt, gen, z)
        sync(torch, dev)

    epoch()                                   # warm-up
    t0 = time.perf_counter()
    epoch()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    activities = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        epoch()
    profiled_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + dev_us / 1e3
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    k1_ms = sum(v for k, v in per_kernel.items() if "_kl_" in k)
    # the profiler slows the host several times over: the idle share is
    # taken against the same epoch's time without it
    emit({"profile_epoch": {
        "epoch_ms": epoch_ms, "profiled_epoch_ms": profiled_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / epoch_ms,
        "k1_ms": k1_ms, "n_kernel_names": len(per_kernel),
        "top_kernels_ms": top}})


# ----------------------------------------------------- card against CPU --

class _Capture:
    """An optimizer stand-in that keeps the gradients it is given."""

    def __init__(self, params):
        self.params = list(params)

    def step(self, grads):
        self.grads = [g.detach().cpu() for g in grads]


def step_agreement(torch, devices=("cuda", "cpu")):
    """One server step of a small federation, from the same weights and
    inputs, on the card (K1 kernels) and on the CPU (the materialized
    ``ref`` KL):

      * the generator step's losses (L_CE, L_BN, L_div) on fixed images,
        and their gradient with respect to the images: the ensemble's
        forward and backward and K1 with dL/dt on;
      * the student step's loss, and the student after its SGD step and
        BN update: K1 with dL/dt off.

    Float32 on both sides, summed in another order: losses relative, the
    image gradient relative to its largest entry, the student entrywise
    with rtol = atol, all to STEP_TOL. The generator itself is left out
    here (the main path runs it on the card, the tests hold it to the
    JAX package): at this size its BatchNorms normalize nearly constant
    channels, so float32 noise moves its images by ~5e-5 and its
    parameter gradient by percents on either device."""
    import numpy as np

    from repro_torch import optim
    from repro_torch.configs import DenseExperimentConfig, resolve_exec_policy
    from repro_torch.core import Client, make_dense_steps
    from repro_torch.models import CNNSpec, cnn_apply, cnn_init

    scfg = DenseExperimentConfig(
        n_clients=3, num_classes=4, image_size=8, width=0.125, nz=16,
        synth_batch=16, client_kinds=("resnet18",) * 3,
        global_kind="resnet18")
    spec = CNNSpec(kind="resnet18", num_classes=4, width=0.125, image_size=8)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (32, 8, 8, 3)).astype(np.float32)
    z = rng.standard_normal((16, 16)).astype(np.float32)
    y = rng.integers(0, 4, 16)
    images = np.tanh(rng.standard_normal((16, 8, 8, 3))).astype(np.float32)

    class Fixed(torch.nn.Module):
        """A generator that always returns the same images."""

        def __init__(self, x):
            super().__init__()
            self.x = torch.nn.Parameter(x)

        def forward(self, z):
            return self.x

    out = []
    for dev in devices:
        init = torch.Generator().manual_seed(0)
        clients = [Client(spec=spec, model=cnn_init(spec, generator=init,
                                                    device=dev))
                   for _ in range(scfg.n_clients)]
        with torch.no_grad():       # move the running statistics off init
            for c in clients:
                cnn_apply(c.model, torch.tensor(x, device=dev), train=True)
        student = cnn_init(spec, generator=init, device=dev)
        gen_step, student_step = make_dense_steps(clients, scfg, device=dev)
        zt, yt = torch.tensor(z, device=dev), torch.tensor(y, device=dev)
        fixed = Fixed(torch.tensor(images, device=dev))
        cap = _Capture(fixed.parameters())
        loss, parts = gen_step(fixed, cap, student, zt, yt)
        s_opt = optim.sgd(list(student.parameters()), scfg.s_lr,
                          momentum=scfg.s_momentum)
        dis = student_step(student, s_opt, fixed, zt)
        out.append((
            np.array([float(loss), *(float(v) for v in parts.values()),
                      float(dis)]),
            cap.grads[0],
            [t.detach().cpu() for t in student.state_dict().values()]))
    (sa, ga, pa), (sb, gb, pb) = out
    scalar_err = float(np.max(np.abs(sa - sb) / np.maximum(np.abs(sb), 1)))
    grad_err = float((ga - gb).abs().max() / gb.abs().max())
    # |a - b| <= atol + rtol |b| with rtol = atol = STEP_TOL
    state_err = max(float(((a - b).abs() - STEP_TOL * b.abs()).max())
                    for a, b in zip(pa, pb))
    emit({"steps_cuda_vs_cpu": {
        "kl_modes": [resolve_exec_policy(scfg, device=d).distill_kl
                     for d in devices],
        "losses_max_rel_err": scalar_err,
        "image_grad_max_err_rel_to_max": grad_err,
        "student_update_max_err_beyond_rtol": state_err,
        "tol": STEP_TOL}})
    if max(scalar_err, grad_err, state_err) > STEP_TOL:
        fail(f"a server step on the card disagrees with the CPU: losses "
             f"{scalar_err}, image gradient {grad_err}, student update "
             f"{state_err}")


# ----------------------------------------------------------------- main --

def main() -> None:
    t_start = time.perf_counter()
    torch, smi = setup()
    from repro_torch.configs import CONFIG

    rows = kernel_phase(torch)
    scfg = dataclasses.replace(CONFIG, local_epochs=1, epochs=2)
    emit({"cuts": {"local_epochs": [CONFIG.local_epochs, scfg.local_epochs],
                   "epochs": [CONFIG.epochs, scfg.epochs],
                   "kept": {"n_clients": scfg.n_clients,
                            "client_kinds": list(scfg.client_kinds),
                            "width": scfg.width,
                            "image_size": scfg.image_size,
                            "batch_size": scfg.batch_size,
                            "synth_batch": scfg.synth_batch,
                            "nz": scfg.nz, "t_g": scfg.t_g,
                            "alpha": scfg.alpha}}})
    clients, launches = main_path(torch, scfg)
    profile_epoch(torch, scfg, clients)
    del clients
    step_agreement(torch)

    def entry(name, rs, replaces):
        main = next(r for r in rs if r["shape"] == list(MAIN_SHAPE)
                    and r["dtype"] == "float32"
                    and r.get("with_teacher_grad", True))
        return {"name": name, "route": "triton",
                "source": "src/repro_torch/kernels/distill_kl.py",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": main["max_abs_err"], "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None,
                "shape": list(MAIN_SHAPE), "dtype": "float32",
                "by_shape": rs}

    print(smi, flush=True)
    emit({"seconds_total": time.perf_counter() - t_start})
    emit({"kernels": [
        entry("distill_kl_fwd", rows["fwd"],
              "src/repro/kernels/distill_kl.py:127"),
        entry("distill_kl_bwd", rows["bwd"],
              "src/repro/kernels/distill_kl.py:186")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
