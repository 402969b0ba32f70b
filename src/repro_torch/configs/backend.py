"""Execution policy: which implementation each step uses.

The torch counterpart of ``repro/configs/backend.py`` (its ``_PROFILES``
and ``ExecPolicy``), cut to what the port has. The profile follows the
device the tensors live on:

  * ``cpu``  — the plain PyTorch path: ``distill_kl="ref"``,
    ``kernel_vjp="ref"``.
  * ``cuda`` — the kernels: ``distill_kl="fused"`` (the K1 pair,
    kernels/distill_kl.py, computes L_div and L_dis) and
    ``kernel_vjp="fused"``: K2 (kernels/flash_attention.py, behind
    ``FlashAttention`` with its own backward) runs every attention layer
    without a cache, in training, in the LLM DENSE steps and in the
    ensemble's forward; K3 (kernels/ssd_scan.py, K3f and K3b behind
    ``SSDScan``) runs every mamba block outside decode: in training, in
    the LLM DENSE steps and in every serving prefill, seeded with the
    cache's state; K4 (kernels/paged_attention.py) serves every paged
    decode step.

Both profiles train clients on the grouped engine, ``client_loop =
"grouped"`` (``fl/federation.py``), as every profile of the reference's
registry does; ``client_loop_mode="python"`` pins the per-client loop.
The epoch driver (``loop``, ``core/dense.py``) is ``"python"`` on the
cpu profile and ``"fused"`` on the cuda one, as on the reference's cpu
and gpu profiles: on the card one captured CUDA graph an epoch, replayed
over chunks of ``scfg.loop_chunk`` epochs with one host read a chunk;
``loop_mode="python"`` pins the per-epoch driver.

The federation-scale knobs (DESIGN.md §13) take the reference's
``_SCALE_DEFAULTS`` on both profiles, every one off: ``bucketing``
(``plan_bucketing``: "off", "pow2", "quantile"), ``stack_chunk``,
``fedavg`` (``fedavg_mode``: "flat", "tree") with ``fedavg_branch``, and
``teacher_chunk``. They are federation-size choices, not device ones: a
scenario of m = 1000 clients opts in on its config.

``ensemble_shard`` (``ensemble_shard_mode``: "none", "clients") is
"none" on both profiles, as in the reference; "clients" shards every
stacked client group over the ("clients", "data") mesh of the process
world (``fl/sharding.py``): the grouped local phase, the teacher and
the tree FedAvg.

A knob set on the config (``scfg.distill_kl_mode``,
``scfg.loop_mode``, ``cfg.kernel_vjp_mode`` and friends) wins over the
profile; an unknown value raises ``ValueError``, as in the reference.
``page`` is the block-pool page size of the
serving engine, 16 tokens on both profiles as in the reference's
``_BLOCKS["gpu"]["paged_attention"]``; the other block tables and the
autotuner are not ported.

``full_float32()`` turns TF32 off in matrix products and cuDNN
convolutions, so float32 is computed as the reference computes it;
every entry point calls it where it resolves its policy.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

KL_MODES = ("ref", "fused")
KERNEL_VJP_MODES = ("ref", "autodiff", "fused")
CLIENT_LOOP_MODES = ("python", "grouped")
LOOP_MODES = ("python", "fused")
BUCKETING_MODES = ("off", "pow2", "quantile")
FEDAVG_MODES = ("flat", "tree")
SHARD_MODES = ("none", "clients")

_SCALE_DEFAULTS = {"bucketing": "off", "stack_chunk": 0,
                   "fedavg": "flat", "fedavg_branch": 8,
                   "teacher_chunk": 0}
_PROFILES = {"cpu": {"loop": "python", "ensemble_shard": "none",
                     "distill_kl": "ref", "kernel_vjp": "ref",
                     "client_loop": "grouped", "page": 16,
                     **_SCALE_DEFAULTS},
             "cuda": {"loop": "fused", "ensemble_shard": "none",
                      "distill_kl": "fused", "kernel_vjp": "fused",
                      "client_loop": "grouped", "page": 16,
                      **_SCALE_DEFAULTS}}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises: nothing falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but no CUDA device is present; "
            "pass device='cpu' to run the plain path on the CPU")
    if dev.type not in _PROFILES:
        raise ValueError(f"unsupported device type {dev.type!r} "
                         f"(expected one of {tuple(_PROFILES)})")
    if dev.type == "cuda" and dev.index is None:
        # "cuda" names the current card; tensors report it with its index
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def full_float32() -> dict:
    """No TF32 in matrix products or cuDNN convolutions, forward or
    backward: float32 as the JAX reference computes it. Recent torch
    keeps a precision per backend and operation (cuDNN convolutions
    default to TF32); older torch has the ``allow_tf32`` flags. Harmless
    on the CPU. Returns the settings as they now read."""
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


def check_shard_mode(mode: str) -> None:
    if mode not in SHARD_MODES:
        raise ValueError(f"unknown ensemble_shard_mode {mode!r} "
                         f"(expected one of {SHARD_MODES})")


def check_kl_mode(mode: str) -> None:
    if mode not in KL_MODES:
        raise ValueError(f"unknown distill_kl mode {mode!r} "
                         f"(expected one of {KL_MODES})")


def check_client_loop_mode(mode: str) -> None:
    if mode not in CLIENT_LOOP_MODES:
        raise ValueError(f"unknown client_loop_mode {mode!r} "
                         f"(expected one of {CLIENT_LOOP_MODES})")


def check_kernel_vjp_mode(mode: str) -> None:
    if mode not in KERNEL_VJP_MODES:
        raise ValueError(f"unknown kernel_vjp mode {mode!r} "
                         f"(expected one of {KERNEL_VJP_MODES})")


def check_loop_mode(mode: str) -> None:
    if mode not in LOOP_MODES:
        raise ValueError(f"unknown loop_mode {mode!r} "
                         "(expected 'python' or 'fused')")


def check_bucketing_mode(mode: str) -> None:
    if mode not in BUCKETING_MODES:
        raise ValueError(f"unknown plan_bucketing {mode!r} "
                         f"(expected one of {BUCKETING_MODES})")


def check_fedavg_mode(mode: str) -> None:
    if mode not in FEDAVG_MODES:
        raise ValueError(f"unknown fedavg_mode {mode!r} "
                         f"(expected one of {FEDAVG_MODES})")


def check_chunk_size(name: str, value) -> None:
    """Chunk knobs are non-negative ints; 0 disables chunking."""
    if int(value) != value or int(value) < 0:
        raise ValueError(f"{name} must be a non-negative int, "
                         f"got {value!r}")


def check_fedavg_branch(value) -> None:
    if int(value) != value or int(value) < 2:
        raise ValueError(f"fedavg_branch must be an int >= 2, "
                         f"got {value!r}")


@dataclass(frozen=True)
class ExecPolicy:
    """Every execution decision of a run, with the reference's short
    names (``loop``, not ``loop_mode``)."""
    backend: str = "cpu"
    loop: str = "python"
    ensemble_shard: str = "none"
    distill_kl: str = "ref"
    kernel_vjp: str = "ref"
    client_loop: str = "grouped"
    page: int = 16
    # federation-scale knobs (DESIGN.md §13)
    bucketing: str = "off"
    stack_chunk: int = 0
    fedavg: str = "flat"
    fedavg_branch: int = 8
    teacher_chunk: int = 0


def resolve_exec_policy(scfg=None, *, device="cuda") -> ExecPolicy:
    """Modes for one run on ``device``: the device's profile, overlaid by
    any knob the config sets. ``scfg`` is a ``DenseExperimentConfig``, an
    ``ArchConfig`` (the model layers read its ``kernel_vjp_mode``, as the
    reference's ``arch_policy`` does) or None. An ``ExecPolicy`` is
    returned unchanged."""
    if isinstance(scfg, ExecPolicy):
        return scfg
    backend = resolve_device(device).type
    prof = _PROFILES[backend]
    def knob(name, default):
        v = getattr(scfg, name, None)
        return default if v is None else v

    loop = knob("loop_mode", prof["loop"])
    shard = knob("ensemble_shard_mode", prof["ensemble_shard"])
    distill_kl = knob("distill_kl_mode", prof["distill_kl"])
    kernel_vjp = knob("kernel_vjp_mode", prof["kernel_vjp"])
    client_loop = knob("client_loop_mode", prof["client_loop"])
    bucketing = knob("plan_bucketing", prof["bucketing"])
    stack_chunk = knob("stack_chunk", prof["stack_chunk"])
    fedavg = knob("fedavg_mode", prof["fedavg"])
    fedavg_branch = knob("fedavg_branch", prof["fedavg_branch"])
    teacher_chunk = knob("teacher_chunk", prof["teacher_chunk"])
    check_loop_mode(loop)
    check_shard_mode(shard)
    check_kl_mode(distill_kl)
    check_kernel_vjp_mode(kernel_vjp)
    check_client_loop_mode(client_loop)
    check_bucketing_mode(bucketing)
    check_chunk_size("stack_chunk", stack_chunk)
    check_fedavg_mode(fedavg)
    check_fedavg_branch(fedavg_branch)
    check_chunk_size("teacher_chunk", teacher_chunk)
    return ExecPolicy(backend=backend, loop=loop, ensemble_shard=shard,
                      distill_kl=distill_kl, kernel_vjp=kernel_vjp,
                      client_loop=client_loop,
                      page=prof["page"], bucketing=bucketing,
                      stack_chunk=int(stack_chunk), fedavg=fedavg,
                      fedavg_branch=int(fedavg_branch),
                      teacher_chunk=int(teacher_chunk))
