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

A knob set on the config (``scfg.distill_kl_mode``,
``scfg.client_loop_mode``, ``cfg.kernel_vjp_mode`` and friends) wins
over the profile. Modes the port does not have yet raise
``NotImplementedError`` here, so no caller silently runs another path. ``page`` is the block-pool page size of the
serving engine, 16 tokens on both profiles as in the reference's
``_BLOCKS["gpu"]["paged_attention"]``; the other block tables and the
autotuner are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

KL_MODES = ("ref", "fused")
KERNEL_VJP_MODES = ("ref", "autodiff", "fused")
CLIENT_LOOP_MODES = ("python", "grouped")

_PROFILES = {"cpu": {"distill_kl": "ref", "kernel_vjp": "ref",
                     "client_loop": "grouped", "page": 16},
             "cuda": {"distill_kl": "fused", "kernel_vjp": "fused",
                      "client_loop": "grouped", "page": 16}}

# config knobs whose non-default values select a path the reference has
# and the port does not have yet: knob -> the values the port runs
_PORTED = {"loop_mode": (None, "python"),
           "ensemble_shard_mode": (None, "none"), "teacher_chunk": (None, 0),
           "plan_bucketing": (None, "off"), "stack_chunk": (None, 0),
           "fedavg_mode": (None, "flat")}
# ... and the item of ROADMAP.md's Queue 1 that ports each
_QUEUE_ITEM = {"loop_mode": 7, "ensemble_shard_mode": 12,
               "teacher_chunk": 11, "plan_bucketing": 11, "stack_chunk": 11,
               "fedavg_mode": 11}


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


@dataclass(frozen=True)
class ExecPolicy:
    backend: str = "cpu"
    distill_kl: str = "ref"
    kernel_vjp: str = "ref"
    client_loop: str = "grouped"
    page: int = 16


def resolve_exec_policy(scfg=None, *, device="cuda") -> ExecPolicy:
    """Modes for one run on ``device``: the device's profile, overlaid by
    any knob the config sets. ``scfg`` is a ``DenseExperimentConfig``, an
    ``ArchConfig`` (the model layers read its ``kernel_vjp_mode``, as the
    reference's ``arch_policy`` does) or None. An ``ExecPolicy`` is
    returned unchanged.
    A knob that asks for a path the port does not have raises
    ``NotImplementedError``."""
    if isinstance(scfg, ExecPolicy):
        return scfg
    for knob, ported in _PORTED.items():
        if getattr(scfg, knob, None) not in ported:
            raise NotImplementedError(
                f"{knob}={getattr(scfg, knob)!r} is not ported yet "
                f"(ROADMAP.md, Queue 1 item {_QUEUE_ITEM[knob]}); the "
                f"port runs {knob}={ported[-1]!r}")
    backend = resolve_device(device).type
    prof = _PROFILES[backend]
    def knob(name, default):
        v = getattr(scfg, name, None)
        return default if v is None else v

    pol = ExecPolicy(backend=backend,
                     distill_kl=knob("distill_kl_mode", prof["distill_kl"]),
                     kernel_vjp=knob("kernel_vjp_mode", prof["kernel_vjp"]),
                     client_loop=knob("client_loop_mode",
                                      prof["client_loop"]),
                     page=prof["page"])
    check_kl_mode(pol.distill_kl)
    check_kernel_vjp_mode(pol.kernel_vjp)
    check_client_loop_mode(pol.client_loop)
    return pol
