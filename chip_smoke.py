"""Run the PyTorch port of DENSE on one CUDA card and check it.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one NVIDIA card (an H100
is the target). Needs ``torch`` built for CUDA, ``triton`` and the CUDA
toolkit's ``nvcc``; the kernels are built from the sources in the
checkout, the CUDA C++ ones into ``build/cuda`` (one ``nvcc`` per source,
started together) and Triton's cache under ``build/triton``. It imports
``repro_torch`` and nothing of JAX.

Phases, in the order they run; any failure exits non-zero before the
result line is printed:

  1. setup: the card's name and power limit (``nvidia-smi``), no TF32 in
     matrix products or convolutions (full float32, as the JAX reference
     computes), the CUDA C++ build (K4, K2, K3, one ``nvcc`` each, all
     started together) with ``nvcc -Xptxas -v``'s register and spill
     counts;
  2. K1f and K1b (Triton, both teacher-gradient settings) against their
     plain PyTorch versions, timed with CUDA events beside their bound,
     at the DENSE main path's shape (128, 10), a ragged (1000, 32003), a
     vocabulary-scale (4096, 32768) and the LLM path's (1024, 128256)
     (B·gen_seq rows of llama's vocabulary), in float32 and bfloat16;
  3. K4 (its ``sm90`` route, the split-context kernel and its merge) at
     the serve shape (R 8, Hq 24, Hkv 8, D 128, page 16, M 32, ragged
     seq_lens with 0 and a full table), a D = 32 shape, zamba2-7b's
     shared block (Hq = Hkv = 32, D = 112) and a long shape (M 256,
     up to 4096 tokens), in float32 and bfloat16 (and float16 at the
     serve and long shapes), against its plain version, beside its
     device time (``torch.profiler``), the first version (the ``simt``
     route) on the same inputs and ``F.scaled_dot_product_attention`` on
     the K/V already gathered into a contiguous cache (a yardstick only:
     it leaves the paging out). The pools are rotated through copies
     larger than the L2 cache, so each call reads them from device
     memory, as a decode step does;
  4. K2 (K2f, K2q, K2kv, CUDA C++) against its plain versions in float32
     without TF32 and in bfloat16 (and float16 at the server, train, long
     and D = 64 shapes), at the server shape (B 4, Hq 24, Hkv 8, S 256,
     D 128), the train shape (B 8), one 4096-token sequence, a ragged
     D = 32 shape with a window and dead rows, D = 64 and D = 112
     (zamba2's shared block at B 2, S 512); timed beside its bound and
     ``F.scaled_dot_product_attention`` (its autograd backward for K2q
     and K2kv). Each K2f row names its route: ``sm90`` (the tensor-core
     kernel, bfloat16 and float16 at D 64 and 128), whose rows also time
     the ``simt`` kernel (the first version) on the same inputs, or
     ``simt``; every K2f row also gives its kernel's device time from
     ``torch.profiler``;
  5. the DENSE main path at the paper's full width (``paper_cifar.CONFIG``:
     five width-1.0 resnet18 clients on 32x32x3 images, batch 128,
     synth_batch 128, nz 100, t_g 30), depth cut to one local epoch and
     two server epochs: ``build_federation`` → ``fedavg`` →
     ``train_dense_server`` → ``evaluate``. Every launch count is zeroed
     just before it; K1's must each read epochs·(t_g + s_steps) just
     after, every other kernel's 0;
  6. one server epoch of the main path under ``torch.profiler``: device
     busy share and kernel time by name;
  7. one server step of a small federation on the card (K1 kernels) and
     on the CPU (the plain ``ref`` KL) from the same weights and images:
     the losses, their gradient with respect to the images and the
     student's update must agree to 1e-4 (the CPU path is held to the JAX
     package by the tests);
  8. serve_check: llama3.2-3b at full width (d_model 3072, vocab 128256)
     with depth cut to 2 layers, float32 without TF32: the paged engine
     (K4) and the dense engine give the same tokens for 6 ragged
     requests in 4 slots, and K4 launches decode steps × layers times,
     every launch on the ``sm90`` route;
  9. serve, the serving main path: llama3.2-3b at full width and depth,
     bfloat16, random weights from a seeded ``torch.Generator``; 16
     requests (prompts of 64–448 tokens, 32–64 new, max_len 512) through
     8 slots of the paged engine, page 16. Every launch count is zeroed
     just before it; K4's must read decode steps × 28 just after, all on
     ``sm90``, the others 0. Then one decode step of 8 running requests under
     ``torch.profiler``: device idle share and the top kernels, with
     K4's share;
 10. train_check: one train step of llama3.2-3b at full width, 2 layers,
     float32: the K2 route and the plain route agree to 1e-4;
 11. dense_llm_check: one generator step and one student step of the
     example's heterogeneous federation (smoke widths) on the card and on
     the CPU agree to 1e-4;
 12. llm_main_path, the LLM DENSE main path at full width and depth
     (``dense_llm_oneshot.full()``: two llama3.2-3b clients, a llama3.2-3b
     student, bfloat16): 3 local train steps a client, the one-shot
     upload, 2 epochs of 3 generator steps and a student step. Every
     launch count is zeroed before each step and checked after it (a
     train step: K2f 2L, K2q L, K2kv L; a generator step: (n+1)L of each
     and one K1f, K1b; a student step: (n+1)L K2f, L K2q and K2kv, one
     K1f, K1b), every K2f, K2q and K2kv launch on the ``sm90`` route;
     then one epoch under ``torch.profiler`` with K2's share, each K2
     kernel's time by route;
 13. K3 (K3f, K3b, CUDA C++) against its plain versions (the chunked
     formula in PyTorch and autograd through it): mamba2-130m's train
     shape (8, 256, 24 heads, P 64, N 128, chunk 256) and zamba2-7b's
     prefill (1, 448, 112 heads, P 64, N 64, a ragged tail) in bfloat16
     and float32, one 4096-token sequence (16 chunks) in bfloat16, and a
     ragged, grouped shape with an initial state in float32, also held to
     the sequential recurrence; timed beside its bound (no PyTorch call
     computes the scan);
 14. ssm_serve_check: zamba2-7b (7 layers: a super-block of 6 mamba
     blocks and the shared block, and one tail block) and mamba2-130m (2
     layers) at full width, float32: paged ≡ dense engine for 6 requests
     of up to 300 tokens (two chunks, a ragged tail) in 4 slots, K3f once
     a mamba block a prefill and K4 once a shared-block application a
     decode step, on ``sm90``;
 15. ssm_serve: zamba2-7b at full width and depth (81 mamba blocks, 13
     applications of the shared block, bfloat16), the serve phase's 16
     requests through 8 slots: K3f must read prefills × 81 and K4 decode
     steps × 13 (on ``sm90``); then one profiled decode step;
 16. ssm_train_check: one zamba2-7b train step at full width, 7 layers,
     float32, batch 2 × 512 (two chunks): the K3/K2 route and the plain
     route agree to 1e-4 (K3f 2 × 7 with remat, K3b 7, K2 on the one
     shared-block application);
 17. ssm_llm_main_path, the LLM DENSE main path with the ssm family
     (``dense_llm_oneshot.full_ssm()``: two mamba2-130m clients and a
     mamba2-130m student, full width and depth, bfloat16), counted step by
     step as in 12 with K3f and K3b in place of K2; then one epoch under
     ``torch.profiler`` with K3's share.

Output: a line with the card's name and power limit, one JSON line per
phase, the ``{"kernels": [...]}`` line, and last the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import itertools
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
BF16_OPS_PER_S = 989e12

# (R, V); (1024, 128256) is the LLM path's: B·gen_seq rows of llama's vocab
SHAPES = ((128, 10), (1000, 32003), (4096, 32768), (1024, 128256))
MAIN_SHAPE = (128, 10)
# f32: the kernel and its plain version differ only in summation order.
# bf16 inputs: both upcast the same values and compute in float32, so the
# float32 outputs (kl, lse) keep 1e-5; the gradients are stored in
# bfloat16, where one rounding on either side of a boundary is one ulp
# (2^-8 relative): two ulps of slack.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 1e-5)}
TOL_GRAD = {"float32": (1e-5, 1e-5), "bfloat16": (1.6e-2, 1e-6)}
STEP_TOL = 1e-4
# The per-head scalars of a mamba block (a_log, dt_bias, d_skip) get one
# gradient entry a head, a sum over every position of the batch of terms
# that cancel (dcs's row and column sums of dseg, its reverse cumsum):
# float32 summation order shows at ~1e-4 of the largest entry there, so
# they are held to 1e-3; ssm_train_check reports the plain route against
# itself at another chunk size as the floor of that noise.
SCALAR_TOL = 1e-3
SCALARS = ("a_log", "dt_bias", "d_skip")

# K4 shapes: (R, Hq, Hkv, D, page, M). The serve shape is llama3.2-3b's
# heads at the serve phase's 8 slots and max_len 512; the D = 32 one has
# smoke()'s heads; the D = 112 one zamba2-7b's shared block at the same
# slots; the long one llama3.2-3b's heads at 8 requests of up to 4096
# tokens (ragged, ~67 MB of live K/V in bfloat16). float16 runs beside
# float32 and bfloat16 at the serve and long shapes (K4_FP16). atol
# only: the outputs are convex combinations of V.
K4_SHAPES = ((8, 24, 8, 128, 16, 32), (6, 4, 2, 32, 16, 8),
             (8, 32, 32, 112, 16, 32), (8, 24, 8, 128, 16, 256))
K4_SERVE_SHAPE = K4_SHAPES[0]
K4_FP16 = (K4_SHAPES[0], K4_SHAPES[3])
TOL_K4 = {"float32": (0.0, 1e-5), "bfloat16": (0.0, 1e-2),
          "float16": (0.0, 1e-2)}
# K2 shapes: (name, B, Hq, Hkv, Sq, Sk, D, causal, window). The server's
# and the train step's are llama3.2-3b's heads at the LLM main path's
# batches; "long" one 4096-token sequence; "ragged_d32" the smoke heads
# with Sq > Sk (dead rows), a window and ragged tiles, and "ragged_d64"
# and "ragged_d128" the same at the sm90 routes' head dims, off every tile
# of K2f, K2q and K2kv; "d64" musicgen's heads; "d112" zamba2-7b's shared
# block at ssm_train_check's batch. float16 runs beside float32 and
# bfloat16 at the shapes the sm90 routes take (K2_FP16). Tolerance:
# float32 without TF32 on both sides, 1e-4; 16-bit gradients are stored
# in the input dtype, 1e-2 of each tensor's largest entry (the sm90
# backward also rounds P and dS to the 16-bit type before their
# products, inside that). K2f's sm90 route (bfloat16, float16 at
# D 64 and 128) rounds P to the 16-bit type before PV, so each o entry may
# move by u·max|v| (u = 2^-9 bfloat16, 2^-12 float16): o is held to
# atol = 2u·max|v|, rtol 0, and lse (float32 scores, float32 l) to 1e-4.
K2_SHAPES = (("server", 4, 24, 8, 256, 256, 128, True, 0),
             ("train", 8, 24, 8, 256, 256, 128, True, 0),
             ("long", 1, 24, 8, 4096, 4096, 128, True, 0),
             ("ragged_d32", 2, 4, 2, 300, 200, 32, True, 64),
             ("ragged_d64", 2, 8, 2, 333, 250, 64, True, 100),
             ("ragged_d128", 2, 6, 2, 270, 199, 128, True, 80),
             ("d64", 4, 32, 32, 256, 256, 64, True, 0),
             ("d112", 2, 32, 32, 512, 512, 112, True, 0))
K2_FP16 = ("server", "train", "long", "ragged_d64", "ragged_d128", "d64")
TOL_K2 = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 1e-2}
UNIT_ROUNDOFF = {"bfloat16": 2.0 ** -9, "float16": 2.0 ** -12}
# K3 shapes: (name, B, S, H, P, G, N, chunk, dtype, with an initial state).
# mamba2-130m's heads at a train step of the SSM LLM path (B 8, seq 256:
# one chunk), zamba2-7b's at a prefill of 448 tokens (a ragged tail), one
# 4096-token sequence (16 chunks), and a small ragged, grouped shape that
# is also held to the sequential recurrence (``ref.ssd``/``ssd_grads``).
# Tolerance, relative to each tensor's largest entry: float32 1e-4; in
# bfloat16 y is stored in bfloat16 (1e-2), the states and gradients are
# float32 from the same bfloat16 inputs (1e-4).
K3_SHAPES = (("mamba2_train", 8, 256, 24, 64, 1, 128, 256, "bfloat16", False),
             ("zamba2_prefill", 1, 448, 112, 64, 1, 64, 256, "bfloat16",
              False),
             ("long", 1, 4096, 24, 64, 1, 128, 256, "bfloat16", False),
             ("ragged_grouped", 2, 300, 4, 32, 2, 16, 64, "float32", True),
             ("mamba2_train", 8, 256, 24, 64, 1, 128, 256, "float32", False),
             ("zamba2_prefill", 1, 448, 112, 64, 1, 64, 256, "float32",
              False))
TOL_K3 = {"float32": 1e-4, "bfloat16": 1e-2}
L2_BYTES = 50 * 2 ** 20


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

    from repro_torch.kernels import cuda_build

    t0 = time.perf_counter()
    try:
        cuda_build.build(["paged_attention", "flash_attention",
                          "flash_attention_sm90", "ssd_scan"])
    except RuntimeError as e:
        fail(str(e))
    emit({"cuda_build": {
        "seconds": time.perf_counter() - t0, "dir": str(cuda_build.BUILD),
        "ptxas": {n: [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]
                  for n, log in cuda_build.build_logs.items()}}})
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

def launch_counts() -> list:
    """Every kernel's launch counter (a dict each)."""
    from repro_torch.kernels import (distill_kl, flash_attention,
                                     paged_attention, ssd_scan)

    return [distill_kl.launches, paged_attention.launches,
            flash_attention.launches, ssd_scan.launches]


def zero_counts() -> None:
    """Every launch counter and K2's and K4's route counts to 0."""
    from repro_torch.kernels import flash_attention, paged_attention

    for counts in (*launch_counts(), flash_attention.fwd_routes,
                   flash_attention.bwd_routes, paged_attention.routes):
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    return {k: v for counts in launch_counts() for k, v in counts.items()}


def read_routes() -> dict:
    """K2's and K4's launches by route since the last ``zero_counts``:
    ``fwd_sm90``, ``fwd_simt`` (K2f), ``bwd_sm90``, ``bwd_simt`` (K2q and
    K2kv, each launch once), ``k4_sm90``, ``k4_simt``."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PK

    return {f"{kind}_{route}": c for kind, counts in (
        ("fwd", FA.fwd_routes), ("bwd", FA.bwd_routes), ("k4", PK.routes))
        for route, c in counts.items()}


def check_k4_routes(label, launches, routes) -> None:
    """Every K4 launch of a phase took the sm90 route."""
    n = launches["paged_attention"]
    if routes["k4_sm90"] != n or routes["k4_simt"]:
        fail(f"{label}: K4's launches by route {routes}, expected all {n} "
             f"on sm90")


def expected(**nonzero) -> dict:
    """Every counter at 0 but those named."""
    want = {k: 0 for k in read_counts()}
    assert set(nonzero) <= set(want), nonzero
    want.update(nonzero)
    return want


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


def bound(nbytes: float, ops: float, peak: float = FP32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
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
    zero_counts()
    (clients, _), t_fed = timed(lambda: build_federation(
        scfg, data, device=dev, ledger=ledger, seed=scfg.seed))
    avg, t_avg = timed(lambda: fedavg(clients))
    (student, _, hist), t_dense = timed(lambda: train_dense_server(
        clients, scfg, device=dev))
    acc_dense, t_eval = timed(lambda: evaluate(student, xt, yt))
    launches = read_counts()

    want = scfg.epochs * (scfg.t_g + scfg.s_steps)
    # a CPU run (a rehearsal) takes the plain versions and launches nothing
    if torch.device(dev).type == "cuda" and launches != expected(
            distill_kl_fwd=want, distill_kl_bwd=want):
        fail(f"launches on the main path {launches}, expected {want} of "
             "each K1 kernel and no K4")
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

def device_ms(prof) -> dict:
    """Device time in ms by kernel name from a ``torch.profiler`` run."""
    per_kernel = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + dev_us / 1e3
    return per_kernel


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
    per_kernel = device_ms(prof)
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


# ------------------------------------------------------------------- K4 --

def k4_inputs(torch, shape, dtype, seed, dev="cuda"):
    """q, pools with a full table per request, and ragged seq_lens with a
    0 (its table row on the null block) and a full table."""
    R, hq, hkv, d, page, m = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_blocks = 1 + R * m
    q = torch.randn(R, hq, d, generator=gen, device=dev).to(dtype)
    kp, vp = (torch.randn(n_blocks, page, hkv, d, generator=gen,
                          device=dev).to(dtype) for _ in range(2))
    bt = (torch.arange(R * m, dtype=torch.int32, device=dev)
          + 1).reshape(R, m)
    seq = torch.randint(1, m * page + 1, (R,), generator=gen, device=dev,
                        dtype=torch.int32)
    seq[0], seq[-1] = 0, m * page
    bt[0] = 0
    return q, kp, vp, bt, seq


def gathered(torch, kp, vp, bt, seq):
    """The K/V of each request gathered into a contiguous (R, Hkv, T, D)
    cache and its live mask (R, 1, 1, T), for SDPA."""
    R, m = bt.shape
    page, hkv, d = kp.shape[1:]
    idx = bt.long()

    def one(pool):
        return pool[idx].reshape(R, m * page, hkv, d).transpose(1, 2) \
            .contiguous()

    live = torch.arange(m * page, device=bt.device)[None, :] < seq[:, None]
    return one(kp), one(vp), live[:, None, None, :]


def rotating(fn, arg_sets):
    """A call of ``fn`` on the next of ``arg_sets`` each time."""
    it = itertools.cycle(arg_sets)
    return lambda: fn(*next(it))


def k4_phase(torch):
    """K4's sm90 route against its plain version at every K4 shape, timed
    beside its bound, the plain version, SDPA on the gathered K/V, its
    device time without the wrapper's host time (the kernel and its
    merge, ``torch.profiler``) and the first version (``simt``) on the
    same inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as PK

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for shape in K4_SHAPES:
        R, hq, hkv, d, page, m = shape
        dtypes = (torch.float32, torch.bfloat16) + (
            (torch.float16,) if shape in K4_FP16 else ())
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            q, kp, vp, bt, seq = k4_inputs(torch, shape, dtype, sum(shape))
            got = PK.paged_attention(q, kp, vp, bt, seq)
            torch.cuda.synchronize()
            want = PK.paged_attention_plain(q, kp, vp, bt, seq)
            ok, err = compare(torch, got, want, TOL_K4[dname])
            zero_rows = bool((got[seq == 0] == 0).all())
            # copies of the pools (and of the gathered caches) beyond twice
            # the L2 cache: each timed call reads its inputs from HBM
            isz = kp.element_size()
            n_copies = max(1, min(64, -(-2 * L2_BYTES
                                        // (2 * kp.numel() * isz))))
            pools = [(q, kp.clone(), vp.clone(), bt, seq)
                     for _ in range(n_copies)]
            caches = [(q[:, :, None], *gathered(torch, *p[1:3], bt, seq))
                      for p in pools]
            live = int(seq.sum())
            nbytes = (2 * live * hkv * d * isz + 2 * R * hq * d * isz
                      + 4 * (int((-(-seq // page)).sum()) + R))
            b_ms, b_by = bound(nbytes, live * hq * (4 * d + 5))
            n_split, pps = PK.split_plan(R, hkv, m, page, n_sm)
            sm90 = rotating(PK.paged_attention, pools)
            simt = rotating(lambda *a: PK.paged_attention(*a, route="simt"),
                            pools)
            device = device_ms_per_call(
                torch, sm90, lambda n: "sm90_paged_attention" in n)
            rows.append({
                "shape": {"R": R, "Hq": hq, "Hkv": hkv, "D": d, "page": page,
                          "M": m}, "seq_lens": seq.tolist(), "dtype": dname,
                "route": "sm90", "splits": n_split, "pages_a_split": pps,
                "ok": ok and zero_rows, "zero_rows_exact": zero_rows,
                "max_abs_err": err, "tol": TOL_K4[dname],
                "ms": cuda_ms(torch, sm90), "device_ms": device,
                "first_version_ms": cuda_ms(torch, simt),
                "first_version_device_ms": device_ms_per_call(
                    torch, simt, lambda n: "paged_attention_kernel<" in n
                    and "sm90_" not in n),
                "plain_ms": cuda_ms(torch, rotating(PK.paged_attention_plain,
                                                    pools)),
                "library_ms": cuda_ms(torch, rotating(
                    lambda qq, k, v, mask: F.scaled_dot_product_attention(
                        qq, k, v, attn_mask=mask, enable_gqa=True), caches)),
                "library": "F.scaled_dot_product_attention on the gathered "
                           "K/V (paging left out)",
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_share_of_device_ms": b_ms / device if device
                else None, "live_tokens": live,
                "l2_rotation_copies": n_copies})
            del pools, caches
            torch.cuda.empty_cache()
    for r in rows:
        emit({"kernel_check": {"name": "paged_attention", **r}})
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} K4 checks disagree with the plain version: {bad}")
    return rows


# -------------------------------------------------------------- serving --

def serve_requests(rng, n, vocab, prompt_range, new_range):
    """``n`` (prompt, max_new) pairs with lengths drawn from ``rng``."""
    return [(rng.integers(0, vocab, int(rng.integers(*prompt_range)),
                          dtype="int32"), int(rng.integers(*new_range)))
            for _ in range(n)]


def run_engine(eng, requests):
    rids = [eng.submit(p, max_new=g) for p, g in requests]
    out = eng.drain()
    return [out[r] for r in rids]


def trunk_blocks(cfg) -> tuple[int, int]:
    """(attention blocks, mamba blocks) one pass of the trunk runs: a
    hybrid applies its shared block once per super-block."""
    from repro_torch.models.transformer import hybrid_shape

    if cfg.family == "ssm":
        return 0, cfg.n_layers
    if cfg.family == "hybrid":
        return hybrid_shape(cfg)[0], cfg.n_layers
    return cfg.n_layers, 0


def serve_launches(cfg, prefills: int, decode_steps: int) -> dict:
    """The serving path's counts: K3f once per mamba block a prefill, K4
    once per attention block a paged decode step (prefill with a cache
    attends on the plain path, as in the reference)."""
    n_attn, n_mamba = trunk_blocks(cfg)
    return expected(paged_attention=decode_steps * n_attn,
                    ssd_scan_fwd=prefills * n_mamba)


def serve_check(torch, dev="cuda", arch="llama3.2-3b", n_layers=2,
                label="serve_check", prompt_range=(16, 161), max_len=192):
    """Paged (K4) ≡ dense at ``arch``'s full width, ``n_layers`` deep,
    float32: the same tokens from both engines, and the launches of
    each."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.models import transformer as T

    full = get_config(arch)
    cfg = full.replace(n_layers=n_layers, dtype="float32",
                       param_dtype="float32")
    params = T.init_model(cfg, seed=1, device=dev)
    reqs = serve_requests(np.random.default_rng(1), 6, cfg.vocab_size,
                          prompt_range, (8, 25))
    kw = {"max_reqs": 4, "max_len": max_len, "device": dev}
    zero_counts()
    paged_eng = ServeEngine(cfg, params, mode="paged", **kw)
    paged = run_engine(paged_eng, reqs)
    launches, routes = read_counts(), read_routes()
    zero_counts()
    dense = run_engine(ServeEngine(cfg, params, mode="dense", **kw), reqs)
    dense_launches = read_counts()
    steps = paged_eng.stats["decode_steps"]
    same = all(np.array_equal(a, b) for a, b in zip(paged, dense))
    want = serve_launches(cfg, len(reqs), steps)
    want_dense = serve_launches(cfg, len(reqs), 0)
    emit({label: {
        "arch": arch, "family": cfg.family,
        "cfg": {"d_model": cfg.d_model, "vocab": cfg.vocab_size,
                "n_layers": [full.n_layers, cfg.n_layers],
                "dtype": cfg.dtype},
        "requests": [[len(p), g] for p, g in reqs], "max_reqs": 4,
        "paged_equals_dense": same, "decode_steps": steps,
        "launches": launches, "expected_launches": want,
        "k4_routes": {r: routes[f"k4_{r}"] for r in ("sm90", "simt")},
        "launches_dense_mode": dense_launches,
        "tokens_first_request": paged[0].tolist()}})
    if not same:
        fail(f"{label}: paged and dense engines disagree: {paged} vs {dense}")
    if launches != want or dense_launches != want_dense:
        fail(f"{label}: launches {launches} (paged), {dense_launches} "
             f"(dense), expected {want} and {want_dense}")
    check_k4_routes(label, launches, routes)
    del params, paged_eng
    torch.cuda.empty_cache()


def serve_main_path(torch, dev="cuda", arch="llama3.2-3b", label="serve"):
    """The serving main path at ``arch``'s full width and depth."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.models import transformer as T

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = T.init_model(cfg, seed=0, device=dev)
    sync(torch, dev)
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    reqs = serve_requests(np.random.default_rng(0), 16, cfg.vocab_size,
                          (64, 449), (32, 65))
    eng = ServeEngine(cfg, params, max_reqs=8, max_len=512, page=16,
                      device=dev)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    sync(torch, dev)
    t0 = time.perf_counter()
    out = run_engine(eng, reqs)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches, routes = read_counts(), read_routes()
    st = eng.stats
    steps = st["decode_steps"]
    generated = sum(len(o) for o in out)
    want = serve_launches(cfg, len(reqs), steps)
    ok_tokens = all(len(o) == g and int(o.min()) >= 0
                    and int(o.max()) < cfg.vocab_size
                    for o, (_, g) in zip(out, reqs))
    emit({label: {
        "cfg": {"name": cfg.name, "family": cfg.family,
                "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                "heads": [cfg.n_heads, cfg.n_kv_heads],
                "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                "ssm": [cfg.ssm_state, cfg.ssm_head_dim, cfg.n_ssm_heads],
                "vocab": cfg.vocab_size, "dtype": cfg.dtype,
                "params": n_params},
        "requests": len(reqs), "prompt_lens": [len(p) for p, _ in reqs],
        "max_new": [g for _, g in reqs], "max_reqs": 8, "max_len": 512,
        "page": eng.page, "init_s": t_init, "wall_s": wall,
        "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
        "decode_steps": steps, "generated": generated,
        "tok_per_s": generated / wall,
        "decode_tok_per_s": (generated - len(reqs)) / st["decode_s"],
        "ms_per_decode_step": st["decode_s"] / max(steps, 1) * 1e3,
        "launches": launches, "expected_launches": want,
        "k4_routes": {r: routes[f"k4_{r}"] for r in ("sm90", "simt")},
        "blocks_attention_mamba": trunk_blocks(cfg),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}})
    if not ok_tokens:
        fail(f"the {label} phase's token streams are malformed")
    if launches != want or steps == 0:
        fail(f"launches on the {label} path {launches}, expected {want}: "
             f"{steps} decode steps x {trunk_blocks(cfg)[0]} of K4, "
             f"{len(reqs)} prefills x {trunk_blocks(cfg)[1]} of K3f")
    check_k4_routes(label, launches, routes)
    del eng
    torch.cuda.empty_cache()
    profile_decode(torch, cfg, params, reqs[:8], dev,
                   label=f"profile_{label}_decode" if label != "serve"
                   else "profile_decode")
    return launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def profile_decode(torch, cfg, params, reqs, dev="cuda",
                   label="profile_decode"):
    """One decode step of 8 running requests under torch.profiler, and
    the finite logits of a further step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T
    from repro_torch.launch.engine import ServeEngine

    eng = ServeEngine(cfg, params, max_reqs=8, max_len=512, page=16,
                      device=dev)
    for p, _ in reqs:
        eng.submit(p, max_new=8)
    eng.step()                      # admits all 8, then one decode step
    eng.step()                      # warm
    t0 = time.perf_counter()
    eng.step()
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
    per_kernel = device_ms(prof)
    busy_ms = sum(per_kernel.values())
    k4_ms = sum(v for k, v in per_kernel.items() if "paged_attention" in k)
    k4_merge_ms = sum(v for k, v in per_kernel.items()
                      if "paged_attention_merge" in k)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    # where the host's time goes: self CPU time by operator, and the
    # number of kernels one step launches
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if "CUDA" not in str(getattr(e, "device_type", ""))),
                  key=lambda t: -t[1])[:12]
    n_kernels = sum(e.count for e in prof.key_averages()
                    if e.key in per_kernel)
    with torch.inference_mode():
        logits, _ = T.forward_paged(
            params, cfg, tokens=torch.tensor(eng._cur, device=dev)[:, None],
            positions=torch.tensor(eng._seq, device=dev), cache=eng._pools,
            block_tables=eng._bt)
        finite = bool(torch.isfinite(logits).all())
    emit({label: {
        "running": sum(s is not None for s in eng._slots),
        "step_ms": step_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / step_ms,
        "k4_ms": k4_ms, "k4_merge_ms": k4_merge_ms,
        "k4_share_of_busy": k4_ms / busy_ms if busy_ms
        else None, "n_kernel_names": len(per_kernel),
        "kernels_launched": n_kernels, "top_kernels_ms": top,
        "top_host_ops_self_ms_count": host,
        "logits_shape": list(logits.shape), "logits_finite": finite}})
    if not finite or tuple(logits.shape) != (8, 1, cfg.vocab_size):
        fail(f"decode logits of shape {tuple(logits.shape)}, finite "
             f"{finite}")
    if busy_ms == 0:
        fail("the profiler saw no device time in a decode step")


# ------------------------------------------------------------------- K2 --

def device_ms_per_call(torch, fn, match, calls: int = 20) -> float:
    """Device time a call of the kernels whose names satisfy ``match``,
    from ``torch.profiler`` over ``calls`` calls after a warm-up: the
    kernel alone, without the wrapper's host time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(v for k, v in device_ms(prof).items() if match(k)) / calls


def k2_kernel(which, route):
    """Matches the device name of K2's ``which`` kernel (``fwd``, ``dq``,
    ``dkv``) on ``route``: ``sm90_dq_kernel<...>`` on sm90,
    ``dq_kernel<...>`` on simt (K3's ``ssd_fwd_kernel`` is neither)."""
    if route == "sm90":
        return lambda name: f"sm90_{which}_kernel<" in name
    return lambda name: (f"{which}_kernel<" in name and "sm90_" not in name
                         and "ssd_" not in name)


def k2_phase(torch):
    """K2f, K2q and K2kv against their plain versions, timed beside their
    bound and beside F.scaled_dot_product_attention (forward, and its
    autograd backward as the yardstick of the backward pair). Every row
    names its route and gives its kernel's device time without the
    wrapper's host time; an sm90 row also times the simt kernel (the
    first version) on the same inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    rows = {"fwd": [], "dq": [], "dkv": []}
    for name, B, hq, hkv, sq, sk, d, causal, window in K2_SHAPES:
        kw = {"causal": causal, "window": window}
        live = FA.mask(sq, sk, device="cuda", **kw)
        n_live = int(live.sum()) * B * hq
        sdpa_kw = ({"is_causal": True} if causal and not window
                   and sq == sk else {"attn_mask": live})
        dtypes = (torch.float32, torch.bfloat16) + (
            (torch.float16,) if name in K2_FP16 else ())
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            tol = TOL_K2[dname]
            route = FA.fwd_route(dtype, d)
            broute = FA.bwd_route(dtype, d)
            isz = 4 if dtype == torch.float32 else 2
            peak = FP32_OPS_PER_S if dtype == torch.float32 \
                else BF16_OPS_PER_S
            gen = torch.Generator(device="cuda").manual_seed(sq + sk + d)
            q = torch.randn(B, hq, sq, d, generator=gen,
                            device="cuda").to(dtype)
            k, v = (torch.randn(B, hkv, sk, d, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            do = torch.randn(B, hq, sq, d, generator=gen,
                             device="cuda").to(dtype)
            o, lse = FA.flash_attention_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            po, plse = FA.flash_attention_fwd_plain(q, k, v, **kw)
            if route == "sm90":
                o_tol = (0.0, 2 * UNIT_ROUNDOFF[dname]
                         * float(v.float().abs().max()))
                lse_tol = (1e-4, 1e-4)
            else:
                o_tol = lse_tol = (tol, tol)
            ok_o, err_o = compare(torch, o, po, o_tol)
            ok_l, err_l = compare(torch, lse, plse, lse_tol)
            dead = plse == FA.NEG_INF
            dead_exact = bool((lse[dead] == FA.NEG_INF).all()
                              and (o[dead] == 0).all())
            # both backward versions from the kernel's residuals; the sm90
            # route reads dO in the input dtype, where do is made
            dof = do.float().reshape(B * hq, sq, d)
            delta = (dof * o).sum(dim=-1)
            do_k = do.reshape(B * hq, sq, d) if broute == "sm90" else dof
            dq = FA.flash_attention_bwd_dq(q, k, v, do_k, lse, delta, **kw)
            dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do_k, lse, delta,
                                                **kw)
            torch.cuda.synchronize()
            want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
            errs = [_grad_err(a, b) for a, b in zip((dq, dk, dv), want)]
            abs_errs = [float((a.float() - b.float()).abs().max())
                        for a, b in zip((dq, dk, dv), want)]
            dq_dead = bool((dq.reshape(B * hq, sq, d)[dead] == 0).all())

            qr, kr, vr = (t.detach().clone().requires_grad_(True)
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(qr, kr, vr,
                                                 enable_gqa=True, **sdpa_kw)
            lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                out, (qr, kr, vr), do, retain_graph=True))
            plain_bwd = cuda_ms(torch, lambda: FA.flash_attention_bwd_plain(
                q, k, v, o, lse, do, **kw))
            shape = {"name": name, "B": B, "Hq": hq, "Hkv": hkv, "Sq": sq,
                     "Sk": sk, "D": d, "causal": causal, "window": window}
            qkv_bytes = (B * hq * sq + 2 * B * hkv * sk) * d * isz
            row_bytes = B * hq * sq * 4
            common = {"shape": shape, "dtype": dname, "tol": tol,
                      "live_pairs": n_live, "dead_rows": int(dead.sum())}
            b_ms, b_by = bound(qkv_bytes + B * hq * sq * d * 4 + row_bytes,
                               4 * d * n_live, peak)
            fwd = lambda: FA.flash_attention_fwd(q, k, v, **kw)
            simt = lambda: FA._fwd_launch(q, k, v, causal, window,
                                          1 / d ** 0.5, "simt")
            row = {
                **common, "route": route, "ok": ok_o and ok_l and dead_exact,
                "max_abs_err": max(err_o, err_l), "o_max_abs_err": err_o,
                "lse_max_abs_err": err_l, "o_tol": list(o_tol),
                "lse_tol": list(lse_tol), "dead_rows_exact": dead_exact,
                "ms": cuda_ms(torch, fwd),
                "device_ms": device_ms_per_call(torch, fwd,
                                                k2_kernel("fwd", route)),
                "plain_ms": cuda_ms(torch, lambda: FA.flash_attention_fwd_plain(
                    q, k, v, **kw)),
                "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, enable_gqa=True, **sdpa_kw)),
                "bound_ms": b_ms, "bound_by": b_by}
            if route == "sm90":
                row["simt_ms"] = cuda_ms(torch, simt)
                row["simt_device_ms"] = device_ms_per_call(
                    torch, simt, k2_kernel("fwd", "simt"))
            if name == "long" and dtype != torch.float32:
                row["tflops_live"] = 4 * d * n_live / (row["ms"] * 1e-3) \
                    / 1e12
            rows["fwd"].append(row)
            # the backward reads q, k, v, dO (in its route's dtype), lse
            # and delta once and writes dq, or dk and dv
            in_bytes = qkv_bytes + 2 * row_bytes \
                + B * hq * sq * d * (isz if broute == "sm90" else 4)
            for which, ok, abs_err, rel_err, out_bytes, ops, extra in (
                    ("dq", errs[0] <= tol and dq_dead, abs_errs[0], errs[0],
                     B * hq * sq * d * isz, 6 * d * n_live,
                     {"dead_rows_exact": dq_dead}),
                    ("dkv", max(errs[1:]) <= tol, max(abs_errs[1:]),
                     max(errs[1:]), 2 * B * hkv * sk * d * isz,
                     8 * d * n_live, {})):
                launch = getattr(FA, f"flash_attention_bwd_{which}")
                call = lambda r: lambda: launch(
                    q, k, v, do_k if r == broute else dof, lse, delta,
                    route=r, **kw)
                b_ms, b_by = bound(in_bytes + out_bytes, ops, peak)
                row = {**common, "route": broute, "ok": ok,
                       "max_abs_err": abs_err, "max_rel_err": rel_err,
                       **extra, "ms": cuda_ms(torch, call(broute)),
                       "device_ms": device_ms_per_call(
                           torch, call(broute), k2_kernel(which, broute)),
                       "plain_ms": plain_bwd, "library_ms": lib_bwd,
                       "bound_ms": b_ms, "bound_by": b_by}
                if broute == "sm90":
                    row["simt_ms"] = cuda_ms(torch, call("simt"))
                    row["simt_device_ms"] = device_ms_per_call(
                        torch, call("simt"), k2_kernel(which, "simt"))
                if name == "long" and dtype != torch.float32:
                    row["tflops_live"] = ops / (row["ms"] * 1e-3) / 1e12
                rows[which].append(row)
            del q, k, v, do, o, lse, po, plse, dof, do_k, delta, dq, dk, \
                dv, want, qr, kr, vr, out
            torch.cuda.empty_cache()
    for which, rs in rows.items():
        for r in rs:
            emit({"kernel_check": {"name": f"flash_attention_{which}"
                                   if which == "fwd"
                                   else f"flash_attention_bwd_{which}",
                                   **r}})
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        fail(f"{len(bad)} K2 checks disagree with the plain versions: {bad}")
    routes = {(which, r["shape"]["name"], r["dtype"]): r["route"]
              for which, rs in rows.items() for r in rs}
    if any((r == "sm90") != (dt != "float32" and n in K2_FP16)
           for (_, n, dt), r in routes.items()):
        fail(f"K2 took an unexpected route: {routes}")
    return rows


# ------------------------------------------------------------------- K3 --

def k3_inputs(torch, B, S, H, P, G, N, dtype, init, seed, dev="cuda"):
    """x, dt (float32, as the model passes it), a, b, c, an initial state
    (zeros unless ``init``), dy and d(final state), on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    x = r(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(r(B, S, H) - 1.0)
    a = -torch.exp(r(H) * 0.3)
    b, c = ((r(B, S, G, N) * 0.3).to(dtype) for _ in range(2))
    s0 = r(B, H, P, N) * 0.5 if init else torch.zeros(B, H, P, N,
                                                      device=dev)
    return x, dt, a, b, c, s0, r(B, S, H, P), r(B, H, P, N)


def k3_work(B, S, H, P, G, N, cl, isz):
    """(forward bytes, forward operations, backward bytes, backward
    operations) that these inputs need: the live (l >= s) pairs within
    each chunk's valid positions, 2(N + P) flops a pair forward and
    2(3N + 2P) backward, 4PN a position forward (y_off, the state
    deposit) and 10PN backward; each input read and each output written
    once (the forward writes the chunk states, as in training)."""
    nc = -(-S // cl)
    lens = [min(cl, S - i * cl) for i in range(nc)]
    pairs = sum(n * (n + 1) // 2 for n in lens)
    bh = B * H
    fwd_ops = bh * (pairs * 2 * (N + P) + 4 * S * P * N)
    bwd_ops = bh * (pairs * 2 * (3 * N + 2 * P) + 10 * S * P * N)
    xs, bcs, st = B * S * H * P, B * S * G * N, bh * P * N
    fwd_bytes = (2 * xs + 2 * bcs) * isz + 4 * (B * S * H + H + 2 * st
                                                + bh * nc * P * N)
    bwd_bytes = (xs + 2 * bcs) * isz + 4 * (B * S * H + H + bh * nc * P * N
                                            + xs + st) \
        + 4 * (xs + B * S * H + H + 2 * bcs + st)
    return fwd_bytes, fwd_ops, bwd_bytes, bwd_ops


def k3_phase(torch, shapes=K3_SHAPES, dev="cuda"):
    """K3f and K3b against their plain versions (the chunked formula in
    PyTorch and autograd through it), at the small shape also against the
    sequential recurrence, timed beside their bound. No single PyTorch
    call computes the SSD scan: library_ms is None."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import ssd_scan as K3

    rows = {"fwd": [], "bwd": []}
    for name, B, S, H, P, G, N, cl, dname, init in shapes:
        dtype = getattr(torch, dname)
        tol = TOL_K3[dname]
        x, dt, a, b, c, s0, dy, dfin = k3_inputs(
            torch, B, S, H, P, G, N, dtype, init, S + H + N, dev)
        y, fin, st = K3.ssd_scan_fwd(x, dt, a, b, c, s0, chunk=cl,
                                     return_chunk_states=True)
        torch.cuda.synchronize()
        py, pfin, pst = K3.ssd_scan_fwd_plain(x, dt, a, b, c, s0, chunk=cl)
        errs_f = [_grad_err(y, py), _grad_err(fin, pfin),
                  _grad_err(st, pst)]
        ok_f = errs_f[0] <= tol and max(errs_f[1:]) <= 1e-4
        grads = K3.ssd_scan_bwd(x, dt, a, b, c, st, dy, dfin, chunk=cl)
        torch.cuda.synchronize()
        want = K3.ssd_scan_bwd_plain(x, dt, a, b, c, pst, dy, dfin, chunk=cl)
        errs_b = [_grad_err(g, w) for g, w in zip(grads, want)]
        ok_b = max(errs_b) <= 1e-4
        oracle = {}
        if name == "ragged_grouped":       # the sequential recurrence too
            ry, rfin = R.ssd(x, dt, a, b, c, initial_state=s0)
            rg = R.ssd_grads(x, dt, a, b, c, s0, dy, dfin)
            oracle = {"y": _grad_err(y, ry), "final": _grad_err(fin, rfin),
                      "grads": max(_grad_err(g, w) for g, w in zip(grads,
                                                                   rg))}
            ok_f = ok_f and max(oracle["y"], oracle["final"]) <= 1e-4
            ok_b = ok_b and oracle["grads"] <= 1e-4
        isz = x.element_size()
        peak = FP32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
        fb, fo, bb, bo = k3_work(B, S, H, P, G, N, cl, isz)
        shape = {"name": name, "B": B, "S": S, "H": H, "P": P, "G": G,
                 "N": N, "chunk": cl, "nc": -(-S // cl),
                 "initial_state": init}
        b_ms, b_by = bound(fb, fo, peak)
        rows["fwd"].append({
            "shape": shape, "dtype": dname, "ok": ok_f,
            "max_abs_err": max(float((y.float() - py.float()).abs().max()),
                               float((fin - pfin).abs().max())),
            "max_rel_err": {"y": errs_f[0], "final": errs_f[1],
                            "chunk_states": errs_f[2]},
            "vs_sequential": oracle.get("y"), "tol": tol,
            "ms": cuda_ms(torch, lambda: K3.ssd_scan_fwd(
                x, dt, a, b, c, s0, chunk=cl, return_chunk_states=True)),
            "plain_ms": cuda_ms(torch, lambda: K3.ssd_scan_fwd_plain(
                x, dt, a, b, c, s0, chunk=cl)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "ops": fo, "bytes": fb, "ctas": B * H})
        b_ms, b_by = bound(bb, bo, peak)
        rows["bwd"].append({
            "shape": shape, "dtype": dname, "ok": ok_b,
            "max_abs_err": max(float((g - w).abs().max())
                               for g, w in zip(grads, want)),
            "max_rel_err": dict(zip(("dx", "ddt", "da", "db", "dc", "dinit"),
                                    errs_b)),
            "vs_sequential": oracle.get("grads"), "tol": 1e-4,
            "ms": cuda_ms(torch, lambda: K3.ssd_scan_bwd(
                x, dt, a, b, c, st, dy, dfin, chunk=cl)),
            "plain_ms": cuda_ms(torch, lambda: K3.ssd_scan_bwd_plain(
                x, dt, a, b, c, pst, dy, dfin, chunk=cl)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "ops": bo, "bytes": bb, "ctas": B * H})
        del x, dt, a, b, c, s0, dy, dfin, y, fin, st, py, pfin, pst, grads, \
            want
        torch.cuda.empty_cache()
    for which, rs in rows.items():
        for r in rs:
            emit({"kernel_check": {"name": f"ssd_scan_{which}", **r}})
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        fail(f"{len(bad)} K3 checks disagree with the plain versions: {bad}")
    return rows


# ------------------------------------------------- LLM DENSE on the card --

def _grad_err(a, b) -> float:
    """max |a − b| over max |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def train_launches(cfg) -> dict:
    """One train step's counts: each attention block K2f (twice with
    remat: the forward and its recomputation), K2q and K2kv once; each
    mamba block K3f (twice with remat) and K3b once."""
    n_attn, n_mamba = trunk_blocks(cfg)
    r = 2 if cfg.remat else 1
    return expected(flash_attention_fwd=r * n_attn,
                    flash_attention_bwd_dq=n_attn,
                    flash_attention_bwd_dkv=n_attn,
                    ssd_scan_fwd=r * n_mamba, ssd_scan_bwd=n_mamba)


def train_check(torch, dev="cuda", arch="llama3.2-3b", n_layers=2,
                batch=(8, 256), label="train_check"):
    """One train step of ``arch`` at full width, ``n_layers`` deep,
    float32 without TF32, through the kernel route (K2, K3) and the plain
    ("ref") route from the same weights and batch: loss, grad_norm and
    every clipped gradient agree to STEP_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches, make_lm_data
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T

    full = get_config(arch)
    cfg = full.replace(n_layers=n_layers, dtype="float32",
                       param_dtype="float32")
    params = T.init_model(cfg, seed=3, device=dev)
    toks = make_lm_data(3, vocab=cfg.vocab_size, n_tokens=200_000)
    x, y = next(lm_batches(toks, batch[0], batch[1], seed=3, steps=1))
    data = {"tokens": torch.from_numpy(x).to(dev),
            "labels": torch.from_numpy(y).to(dev)}
    out = {}
    routes = {"fused": cfg.replace(kernel_vjp_mode="fused"),
              "ref": cfg.replace(kernel_vjp_mode="ref")}
    if cfg.ssm_state:       # the plain route at half the chunk: the floor
        routes["ref_half_chunk"] = cfg.replace(
            kernel_vjp_mode="ref", ssm_chunk=cfg.ssm_chunk // 2)
    for mode, c in routes.items():
        state = ST.make_train_state(c, params=params, device=dev)
        state["opt"] = _Capture(state["opt"].params)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        state, m = ST.make_train_step(c)(state, data)
        sync(torch, dev)
        out[mode] = (float(m["loss"]), float(m["grad_norm"]),
                     state["opt"].grads, read_counts(), _peak_gib(torch))
        del state, m
    (la, na, ga, ca, _), (lb, nb, gb, _, _) = out["fused"], out["ref"]
    loss_err = abs(la - lb) / abs(lb)
    norm_err = abs(na - nb) / abs(nb)
    names = _leaf_paths(params)
    is_scalar = [n.rsplit(".", 1)[-1] in SCALARS for n in names]
    errs = sorted(((_grad_err(a, b), name) for a, b, name in
                   zip(ga, gb, names)), reverse=True)
    grad_err = max([e for e, n in errs
                    if n.rsplit(".", 1)[-1] not in SCALARS], default=0.0)
    scalar_err = max([e for e, n in errs
                      if n.rsplit(".", 1)[-1] in SCALARS], default=0.0)
    floor = None
    if "ref_half_chunk" in out:
        gh = out["ref_half_chunk"][2]
        floor = {"all_but_scalars": max(
            [_grad_err(a, b) for a, b, sc in zip(gh, gb, is_scalar)
             if not sc]),
                 "scalars": max(_grad_err(a, b) for a, b, sc in
                                zip(gh, gb, is_scalar) if sc)}
    want = train_launches(cfg)
    emit({label: {
        "arch": arch,
        "cfg": {"d_model": cfg.d_model,
                "n_layers": [full.n_layers, cfg.n_layers],
                "vocab": cfg.vocab_size, "dtype": cfg.dtype,
                "remat": cfg.remat, "batch": list(batch),
                "chunk": cfg.ssm_chunk if cfg.ssm_state else None},
        "loss": [la, lb], "grad_norm": [na, nb], "loss_rel_err": loss_err,
        "grad_norm_rel_err": norm_err, "grads_max_err_rel_to_max": grad_err,
        "scalar_grads_max_err_rel_to_max": scalar_err if any(is_scalar)
        else None, "worst_grads": errs[:6],
        "plain_half_chunk_vs_plain": floor,
        "launches": {k: v[3] for k, v in out.items()},
        "peak_mem_gib": {k: v[4] for k, v in out.items()}, "tol": STEP_TOL,
        "scalar_tol": SCALAR_TOL if any(is_scalar) else None}})
    if max(loss_err, norm_err, grad_err) > STEP_TOL \
            or scalar_err > SCALAR_TOL:
        fail(f"{label}: the kernel train step disagrees with the plain "
             f"route: loss {loss_err}, grad_norm {norm_err}, gradients "
             f"{grad_err}, per-head scalars {scalar_err}")
    plain = {k: v[3] for k, v in out.items() if k != "fused"}
    if ca != want or any(c != expected() for c in plain.values()):
        fail(f"{label} launches {ca} (kernel route), {plain} (plain), "
             f"expected {want} and none")
    del params, out, ga, gb
    torch.cuda.empty_cache()


def dense_llm_check(torch, devices=("cuda", "cpu")):
    """One gen_step and one student_step of the example's heterogeneous
    federation at smoke widths (llama, qwen, musicgen clients, phi3
    student, vocab 256) on the card (K1, K2) and on the CPU (the plain
    versions), from the same weights and noise: losses and the
    generator's and student's gradients agree to STEP_TOL."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import dense_llm as DL
    from repro_torch.core.generator import tok_generator_init
    from repro_torch.models import transformer as T

    archs = ("llama3.2-3b", "qwen1.5-4b", "musicgen-large")
    ccfgs = [get_smoke_config(a).replace(vocab_size=256) for a in archs]
    scfg = get_smoke_config("phi3-medium-14b").replace(vocab_size=256)
    rng = np.random.default_rng(11)
    z = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.integers(0, 256, (8, 32))
    out = {}
    for dev in devices:
        init = torch.Generator().manual_seed(11)
        cparams = [T.init_model(c, generator=init, device=dev)
                   for c in ccfgs]
        stu = T.init_model(scfg, generator=init, device=dev)
        for t in T.leaves(stu):
            t.requires_grad_(True)
        gen = tok_generator_init(nz=16, seq=32, d_model=scfg.d_model, d_g=64,
                                 n_classes=256, generator=init, device=dev)
        gen_step, student_step, _, _ = DL.make_llm_dense_steps(
            scfg, ccfgs, s_lr=3e-4, device=dev)
        zt, yt = torch.tensor(z, device=dev), torch.tensor(y, device=dev)
        g_cap, s_cap = _Capture(gen.parameters()), _Capture(T.leaves(stu))
        zero_counts()
        gl, parts = gen_step(gen, g_cap, stu, cparams, zt, yt)
        dl = student_step(stu, s_cap, gen, cparams, zt, yt)
        sync(torch, dev)
        out[dev] = (np.array([float(gl), *(float(v) for v in parts.values()),
                              float(dl)]), g_cap.grads, s_cap.grads,
                    read_counts(), read_routes())
    (sa, ga, ta, ca, ra), (sb, gb, tb, _, _) = (out[d] for d in devices)
    scalar_err = float(np.max(np.abs(sa - sb) / np.maximum(np.abs(sb), 1)))
    g_err = max(_grad_err(a, b) for a, b in zip(ga, gb))
    s_err = max(_grad_err(a, b) for a, b in zip(ta, tb))
    emit({"dense_llm_check": {
        "losses_cuda": sa.tolist(), "losses_cpu": sb.tolist(),
        "losses_max_rel_err": scalar_err,
        "gen_grad_max_err_rel_to_max": g_err,
        "student_grad_max_err_rel_to_max": s_err,
        "launches_cuda": ca, "routes_cuda": ra, "tol": STEP_TOL}})
    if max(scalar_err, g_err, s_err) > STEP_TOL:
        fail(f"the DENSE LLM steps on the card disagree with the CPU: "
             f"losses {scalar_err}, generator {g_err}, student {s_err}")
    if not all(ca[k] for k in ca if k.startswith(("distill_kl",
                                                   "flash_attention"))):
        fail(f"dense_llm_check launched not every K1/K2 kernel: {ca}")
    if ra["fwd_sm90"] + ra["fwd_simt"] != ca["flash_attention_fwd"] or \
            ra["bwd_sm90"] + ra["bwd_simt"] != \
            ca["flash_attention_bwd_dq"] + ca["flash_attention_bwd_dkv"]:
        fail(f"dense_llm_check: K2's routes {ra} do not add up to its "
             f"launches {ca}")


def _leaf_paths(tree: dict, prefix: str = "") -> list:
    """The dotted paths of a nested dict's tensors, in ``leaves`` order."""
    return [p for k, v in tree.items()
            for p in (_leaf_paths(v, f"{prefix}{k}.") if isinstance(v, dict)
                      else [prefix + k])]


def _peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def server_launches(cfg, n: int, which: str) -> dict:
    """The counts of one server step of a federation of ``n`` clients and
    a student of one config: a generator step runs every trunk forward
    and backward (to the embeddings), a student step every trunk forward
    and the student's backward; each one K1 pair."""
    n_attn, n_mamba = trunk_blocks(cfg)
    bwd = n + 1 if which == "gen_step" else 1
    return expected(flash_attention_fwd=(n + 1) * n_attn,
                    flash_attention_bwd_dq=bwd * n_attn,
                    flash_attention_bwd_dkv=bwd * n_attn,
                    ssd_scan_fwd=(n + 1) * n_mamba,
                    ssd_scan_bwd=bwd * n_mamba,
                    distill_kl_fwd=1, distill_kl_bwd=1)


def llm_main_path(torch, dev="cuda", oc=None, label="llm"):
    """An LLM DENSE main path at full width (``dense_llm_oneshot.full()``
    by default: two llama3.2-3b clients and a llama3.2-3b student, 28
    layers, bfloat16; ``full_ssm()``: three mamba2-130m): each client's
    local train steps, the one-shot upload, then per epoch t_g generator
    steps and one student step. Every launch count is zeroed before each
    step and checked after it."""
    from repro_torch.core import dense_llm as DL
    from repro_torch.core.generator import tok_generator_init
    from repro_torch.data import lm_batches, make_lm_data
    from repro_torch.fl.protocol import CommLedger, param_bytes
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import dense_llm_oneshot as ONE
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T

    oc = ONE.full() if oc is None else oc
    cfgs = [oc.arch_config(a) for a in oc.client_archs]
    n, L = len(cfgs), cfgs[0].n_layers
    if any(c != cfgs[0] for c in cfgs) or oc.arch_config(
            oc.student_arch) != cfgs[0]:
        fail(f"{label}: the launch counts assume one config for every "
             "client and the student")
    emit({f"{label}_cuts": {
        "clients": list(oc.client_archs), "student": oc.student_arch,
        "n_layers": L, "d_model": cfgs[0].d_model,
        "vocab": cfgs[0].vocab_size, "dtype": cfgs[0].dtype,
        "client_steps": oc.client_steps,
        "client_batch": [ONE.CLIENT_BATCH, oc.client_seq],
        "server_batch": [oc.batch, oc.gen_seq], "nz": oc.nz, "d_g": oc.d_g,
        "epochs": oc.epochs, "t_g": ONE.T_G, "cut": "depth of training: "
        "3 local steps a client, 2 server epochs; no width, depth or batch "
        "cut"}})

    routes = {k: 0 for k in read_routes()}

    def stage(fn, want, label):
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        sync(torch, dev)
        t0 = time.perf_counter()
        res = fn()
        sync(torch, dev)
        dt = time.perf_counter() - t0
        got = read_counts()
        if got != want:
            fail(f"launches in {label}: {got}, expected {want}")
        for k, c in read_routes().items():
            routes[k] += c
        return res, dt, _peak_gib(torch)

    ledger = CommLedger()
    client_params, train_s, train_peak, client_loss = [], [], [], []
    for i, cfg in enumerate(cfgs):
        state = ST.make_train_state(cfg, lr=oc.client_lr, seed=i, device=dev)
        step = ST.make_train_step(cfg)
        toks = make_lm_data(i, vocab=cfg.vocab_size,
                            n_tokens=oc.client_tokens)
        for x, y in lm_batches(toks, ONE.CLIENT_BATCH, oc.client_seq, seed=i,
                               steps=oc.client_steps):
            b = {"tokens": torch.from_numpy(x).to(dev),
                 "labels": torch.from_numpy(y).to(dev)}
            (state, m), dt, peak = stage(
                lambda: step(state, b), train_launches(cfg),
                f"client {i}'s train step")
            train_s.append(dt)
            train_peak.append(peak)
            client_loss.append(float(m["loss"]))
        p = DL._frozen(state["params"])
        del state, step, m
        ledger.record("up", f"client{i}", param_bytes(p),
                      "round0-model-upload")
        client_params.append(p)

    stu_cfg = oc.arch_config(oc.student_arch)
    student = T.init_model(stu_cfg, seed=ONE.SEED, device=dev)
    for t in T.leaves(student):
        t.requires_grad_(True)
    gen = tok_generator_init(nz=oc.nz, seq=oc.gen_seq,
                             d_model=stu_cfg.d_model, d_g=oc.d_g,
                             n_classes=stu_cfg.vocab_size,
                             generator=torch.Generator().manual_seed(ONE.SEED),
                             device=dev)
    gen_step, student_step, make_g_opt, make_s_opt = \
        DL.make_llm_dense_steps(stu_cfg, cfgs, g_lr=oc.g_lr, s_lr=oc.s_lr,
                                device=dev)
    g_opt, s_opt = make_g_opt(gen), make_s_opt(student)
    draws = torch.Generator(device=dev).manual_seed(ONE.SEED)
    want_gen = server_launches(stu_cfg, n, "gen_step")
    want_stu = server_launches(stu_cfg, n, "student_step")
    hist = {"gen_loss": [], "gen_parts": [], "dis_loss": []}
    gen_s, stu_s, gen_peak, stu_peak, epoch_s = [], [], [], [], []
    totals = {k: 0 for k in read_counts()}
    for _ in range(oc.epochs):
        z = torch.randn((oc.batch, oc.nz), generator=draws, device=dev)
        y = torch.randint(0, stu_cfg.vocab_size, (oc.batch, oc.gen_seq),
                          generator=draws, device=dev)
        t_epoch = 0.0
        for _ in range(ONE.T_G):
            (gl, parts), dt, peak = stage(
                lambda: gen_step(gen, g_opt, student, client_params, z, y),
                want_gen, "gen_step")
            gen_s.append(dt)
            gen_peak.append(peak)
            t_epoch += dt
        dl, dt, peak = stage(
            lambda: student_step(student, s_opt, gen, client_params, z, y),
            want_stu, "student_step")
        stu_s.append(dt)
        stu_peak.append(peak)
        epoch_s.append(t_epoch + dt)
        hist["gen_loss"].append(float(gl))
        hist["gen_parts"].append({k: float(v) for k, v in parts.items()})
        hist["dis_loss"].append(float(dl))
    for want, k in ((train_launches(cfgs[0]), n * oc.client_steps),
                    (want_gen, oc.epochs * ONE.T_G), (want_stu, oc.epochs)):
        for name, c in want.items():
            totals[name] += c * k
    losses = client_loss + hist["gen_loss"] + hist["dis_loss"] + [
        v for p in hist["gen_parts"] for v in p.values()]
    if not all(v == v and abs(v) != float("inf") for v in losses):
        fail(f"{label} main-path losses are not finite: {hist}, "
             f"{client_loss}")
    # every K2 launch took the route its dtype and head dim choose (sm90
    # for the bfloat16 llama path, both directions)
    dtype, hd = getattr(torch, cfgs[0].dtype), cfgs[0].head_dim
    for kind, route, n in (
            ("fwd", FA.fwd_route(dtype, hd), totals["flash_attention_fwd"]),
            ("bwd", FA.bwd_route(dtype, hd),
             totals["flash_attention_bwd_dq"]
             + totals["flash_attention_bwd_dkv"])):
        if routes[f"{kind}_{route}"] != n:
            fail(f"{label}: K2's launches by route {routes}, expected all "
                 f"{n} of {kind} on {route}")
    if ledger.rounds != 1 or ledger.downlink_bytes != 0 or \
            ledger.uplink_bytes != sum(param_bytes(p) for p in client_params):
        fail(f"not one-shot: {ledger.rounds} rounds, "
             f"{ledger.downlink_bytes} B down")
    emit({f"{label}_main_path": {
        "arch": oc.student_arch,
        "params_per_model": sum(t.numel() for t in T.leaves(student)),
        "seconds": {"train_step": train_s, "gen_step": gen_s,
                    "student_step": stu_s, "epoch": epoch_s},
        "seconds_per_train_step_median": statistics.median(train_s),
        "seconds_per_gen_step_median": statistics.median(gen_s),
        "seconds_per_student_step_median": statistics.median(stu_s),
        "seconds_per_epoch_last": epoch_s[-1],
        "peak_mem_gib": {"train_step": max(train_peak),
                         "gen_step": max(gen_peak),
                         "student_step": max(stu_peak)},
        "launches_per_step": {"train_step": train_launches(cfgs[0]),
                              "gen_step": want_gen,
                              "student_step": want_stu},
        "launches_total": totals,
        "fwd_routes": {r: routes[f"fwd_{r}"] for r in ("sm90", "simt")},
        "bwd_routes": {r: routes[f"bwd_{r}"] for r in ("sm90", "simt")},
        "uplink_bytes": ledger.uplink_bytes, "rounds": ledger.rounds,
        "client_loss": client_loss, **hist}})
    return totals, (gen_step, student_step, g_opt, s_opt, gen, student,
                    client_params, oc, stu_cfg, draws)


def profile_llm_epoch(torch, ctx, dev="cuda", label="profile_llm_epoch"):
    """One server epoch of an LLM main path (t_g generator steps and a
    student step) under torch.profiler: device idle share, top kernels,
    K2's and K3's shares."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.dense_llm_oneshot import T_G

    (gen_step, student_step, g_opt, s_opt, gen, student, cparams, oc,
     stu_cfg, draws) = ctx
    z = torch.randn((oc.batch, oc.nz), generator=draws, device=dev)
    y = torch.randint(0, stu_cfg.vocab_size, (oc.batch, oc.gen_seq),
                      generator=draws, device=dev)

    def epoch():
        for _ in range(T_G):
            gen_step(gen, g_opt, student, cparams, z, y)
        student_step(student, s_opt, gen, cparams, z, y)
        sync(torch, dev)

    t0 = time.perf_counter()
    epoch()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    activities = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        epoch()
    per_kernel = device_ms(prof)
    busy_ms = sum(per_kernel.values())
    k2 = {w: sum(v for k, v in per_kernel.items()
                 if f"{w}_kernel<" in k and "ssd_" not in k)
          for w in ("fwd", "dq", "dkv")}
    k2_by_route = {w: {r: sum(v for k, v in per_kernel.items()
                              if k2_kernel(w, r)(k))
                       for r in ("sm90", "simt")}
                   for w in ("fwd", "dq", "dkv")}
    k3 = {w: sum(v for k, v in per_kernel.items()
                 if f"ssd_{w}_kernel<" in k) for w in ("fwd", "bwd")}
    k1_ms = sum(v for k, v in per_kernel.items() if "_kl_" in k)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    # where the host's time goes: self CPU time by operator, and the
    # number of kernels the epoch launches
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if "CUDA" not in str(getattr(e, "device_type", ""))),
                  key=lambda t: -t[1])[:12]
    n_kernels = sum(e.count for e in prof.key_averages()
                    if e.key in per_kernel)
    emit({label: {
        "epoch_ms": epoch_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / epoch_ms,
        "k2_ms": k2, "k2_ms_by_route": k2_by_route,
        "k2_share_of_busy": sum(k2.values()) / busy_ms
        if busy_ms else None, "k3_ms": k3,
        "k3_share_of_busy": sum(k3.values()) / busy_ms if busy_ms else None,
        "k1_ms": k1_ms,
        "n_kernel_names": len(per_kernel), "kernels_launched": n_kernels,
        "top_kernels_ms": top, "top_host_ops_self_ms_count": host}})
    n_attn, n_mamba = trunk_blocks(stu_cfg)
    if busy_ms == 0 or (n_attn and not all(k2.values())) or (
            n_mamba and not all(k3.values())):
        fail(f"{label}: the profiler saw no device time of a kernel the "
             f"epoch runs: K2 {k2}, K3 {k3}")


# ----------------------------------------------------------------- main --

def k2_entry(name, rs, line, launches):
    """The kernels line's entry of a K2 kernel: the server shape in
    bfloat16 (the LLM main path's gen_step and student_step), its
    launches over the LLM main path."""
    main = next(r for r in rs if r["shape"]["name"] == "server"
                and r["dtype"] == "bfloat16")
    source = "flash_attention_sm90.cu" if main["route"] == "sm90" \
        else "flash_attention.cu"
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": launches[name],
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "dtype": main["dtype"], "k2_route": main["route"],
            "device_ms": main.get("device_ms"), "by_shape": rs}


def k3_entry(name, rs, line, launches):
    """The kernels line's entry of a K3 kernel: mamba2-130m's train shape
    in bfloat16 (the SSM LLM main path's train step), its launches over
    that path."""
    main = next(r for r in rs if r["shape"]["name"] == "mamba2_train"
                and r["dtype"] == "bfloat16")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": f"src/repro/kernels/ssd_scan.py:{line}",
            "launches": launches[name],
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shape": main["shape"],
            "dtype": main["dtype"], "by_shape": rs}


def main() -> None:
    t_start = time.perf_counter()
    torch, smi = setup()
    from repro_torch.configs import CONFIG
    from repro_torch.launch import dense_llm_oneshot as ONE

    rows = kernel_phase(torch)
    k4_rows = k4_phase(torch)
    k2_rows = k2_phase(torch)
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
    serve_check(torch)
    serve_launches = serve_main_path(torch)
    train_check(torch)
    dense_llm_check(torch)
    llm_launches, llm_ctx = llm_main_path(torch)
    profile_llm_epoch(torch, llm_ctx)
    del llm_ctx
    torch.cuda.empty_cache()
    k3_rows = k3_phase(torch)
    serve_check(torch, arch="zamba2-7b", n_layers=7, label="ssm_serve_check",
                prompt_range=(16, 301), max_len=336)
    serve_check(torch, arch="mamba2-130m", n_layers=2,
                label="ssm_serve_check", prompt_range=(16, 301), max_len=336)
    serve_main_path(torch, arch="zamba2-7b", label="ssm_serve")
    train_check(torch, arch="zamba2-7b", n_layers=7, batch=(2, 512),
                label="ssm_train_check")
    ssm_launches, ssm_ctx = llm_main_path(torch, oc=ONE.full_ssm(),
                                          label="ssm_llm")
    profile_llm_epoch(torch, ssm_ctx, label="profile_ssm_llm_epoch")
    del ssm_ctx

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

    R, hq, hkv, d, page, m = K4_SERVE_SHAPE
    k4 = next(r for r in k4_rows if r["dtype"] == "bfloat16"
              and r["shape"] == {"R": R, "Hq": hq, "Hkv": hkv, "D": d,
                                 "page": page, "M": m})
    print(smi, flush=True)
    emit({"seconds_total": time.perf_counter() - t_start})
    emit({"kernels": [
        entry("distill_kl_fwd", rows["fwd"],
              "src/repro/kernels/distill_kl.py:127"),
        entry("distill_kl_bwd", rows["bwd"],
              "src/repro/kernels/distill_kl.py:186"),
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:119",
         "launches": serve_launches["paged_attention"],
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": k4["library_ms"],
         "k4_route": k4["route"], "device_ms": k4["device_ms"],
         "first_version_ms": k4["first_version_ms"],
         "shape": k4["shape"], "dtype": k4["dtype"], "by_shape": k4_rows},
        *(k2_entry(name, k2_rows[which], line, llm_launches)
          for name, which, line in (
              ("flash_attention_fwd", "fwd", 171),
              ("flash_attention_bwd_dq", "dq", 342),
              ("flash_attention_bwd_dkv", "dkv", 370))),
        *(k3_entry(name, k3_rows[which], line, ssm_launches)
          for name, which, line in (("ssd_scan_fwd", "fwd", 143),
                                    ("ssd_scan_bwd", "bwd", 278)))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
