"""DENSE at LM scale, one shot (``examples/dense_llm_oneshot.py``): a
federation of decoder LMs trains locally, uploads once, and the server
runs the two DENSE stages with the token generator.

    PYTHONPATH=src python -m repro_torch.launch.dense_llm_oneshot \
        [--smoke] [--ssm | --moe] [--layers N] [--device cpu]

``--smoke`` runs the example's heterogeneous federation at smoke widths:
llama, qwen (QKV bias) and musicgen (audio) clients and a phi3 student,
sharing a 256-token vocabulary. Without it, the federation at full width
on the card: two llama3.2-3b clients and a llama3.2-3b student (DENSE's
clients must share a vocabulary), with ``launch/train.py``'s defaults for
local training and the reference's server defaults
(``core/dense_llm.py:103-111``); ``--ssm`` takes ``full_ssm()`` instead,
two mamba2-130m clients and a mamba2-130m student (with ``--smoke``: a
mamba2 and a zamba2 client and a mamba2 student at smoke widths), and
``--moe`` ``full_moe()``, two deepseek-v2-lite-16b clients and a lite
student (with ``--smoke``: a deepseek-v2-lite and a gemma3 client and a
deepseek-v2-236b student, MLA with and without q_lora, the routed
experts and the window pattern). ``--layers N`` cuts every model's
depth: ``full_moe()`` at lite's 27 layers holds three 15.7 B-parameter
models, more than one card's 80 GB. ``LLMOneShotConfig`` holds each. A
vlm cannot be a client or the student (``core/dense_llm.
check_llm_dense_arch``).

Each client trains on its own Markov stream (``make_lm_data(seed=i)``, a
disjoint dialect) with the LM train step, and its upload is recorded in
the ``CommLedger``: one round, nothing broadcast. Then each epoch draws
z and y, takes ``T_G`` generator steps and one student step
(``core/dense_llm.make_llm_dense_steps``). ``noise(epoch) -> (z, y)``
replaces the draws (the tests inject the reference's ``jax.random``
ones); by default they come from a ``torch.Generator`` seeded ``SEED``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.configs.backend import full_float32, resolve_device
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core import dense_llm as DL
from repro_torch.core.generator import tok_generator_init
from repro_torch.data import lm_batches, make_lm_data
from repro_torch.fl.protocol import CommLedger, param_bytes
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T


CLIENT_BATCH = 8        # local training's batch, in both federations
T_G = 3                 # generator steps an epoch
SEED = 99               # the student's, the generator's and the draws'


@dataclass(frozen=True)
class LLMOneShotConfig:
    """The example's federation (the defaults) or, with ``full()``, the
    full-width one. λ_bn = 1 and λ_div = 0.5 in both
    (``make_llm_dense_steps``' defaults)."""
    client_archs: tuple = ("llama3.2-3b", "qwen1.5-4b", "musicgen-large")
    student_arch: str = "phi3-medium-14b"
    smoke: bool = True
    vocab: int | None = 256         # the shared vocabulary; None: the arch's
    n_layers: int | None = None     # every model's depth; None: the arch's
    # local training
    client_steps: int = 40
    client_seq: int = 32
    client_lr: float = 3e-3
    client_tokens: int = 40_000
    # the server
    batch: int = 8
    gen_seq: int = 32
    nz: int = 16
    d_g: int = 64
    epochs: int = 12
    g_lr: float = 1e-3
    s_lr: float = 3e-4

    def arch_config(self, arch: str):
        """``arch``'s config at this run's size, depth and vocabulary; a
        vlm raises (``check_llm_dense_arch``)."""
        cfg = get_smoke_config(arch) if self.smoke else get_config(arch)
        DL.check_llm_dense_arch(cfg)
        if self.n_layers is not None:
            cfg = cfg.replace(n_layers=self.n_layers)
        return cfg if self.vocab is None else cfg.replace(
            vocab_size=self.vocab)


def full() -> LLMOneShotConfig:
    """Two llama3.2-3b clients and a llama3.2-3b student at full width:
    local training at ``launch/train.py``'s defaults (batch 8, seq 256,
    lr 3e-4) for 3 steps a client; the server at batch 4, gen_seq 256,
    nz 64, d_g 256, t_g 3, 2 epochs, g_lr 1e-3, s_lr 1e-4."""
    return LLMOneShotConfig(
        client_archs=("llama3.2-3b",) * 2, student_arch="llama3.2-3b",
        smoke=False, vocab=None, client_steps=3, client_seq=256,
        client_lr=3e-4, client_tokens=200_000, batch=4, gen_seq=256, nz=64,
        d_g=256, epochs=2, s_lr=1e-4)


def full_ssm() -> LLMOneShotConfig:
    """``full()`` with the ssm family: two mamba2-130m clients and a
    mamba2-130m student at full width and depth (24 layers, d_model 768,
    vocab 50280), the same local training and server settings."""
    return dataclasses.replace(full(), client_archs=("mamba2-130m",) * 2,
                               student_arch="mamba2-130m")


def full_moe() -> LLMOneShotConfig:
    """``full()`` with the moe family: two deepseek-v2-lite-16b clients
    and a lite student at full width (d_model 2048, 64 routed experts
    top-6 and 2 shared, MLA, vocab 102400), the same local training and
    server settings. At lite's 27 layers the three models do not fit one
    card: cut them with ``n_layers``."""
    return dataclasses.replace(full(),
                               client_archs=("deepseek-v2-lite-16b",) * 2,
                               student_arch="deepseek-v2-lite-16b")


# the ssm federation at smoke widths: a mamba2 and a zamba2 client, a
# mamba2 student
SMOKE_SSM = LLMOneShotConfig(client_archs=("mamba2-130m", "zamba2-7b"),
                             student_arch="mamba2-130m")
# the moe and window families at smoke widths: a deepseek-v2-lite and a
# gemma3 client, a deepseek-v2-236b student
SMOKE_MOE = LLMOneShotConfig(
    client_archs=("deepseek-v2-lite-16b", "gemma3-4b"),
    student_arch="deepseek-v2-236b")


@dataclass
class LLMOneShotResult:
    client_cfgs: list
    client_params: list
    client_losses: list
    student_cfg: object
    student_params: dict
    gen: torch.nn.Module
    ledger: CommLedger
    gen_loss: list = field(default_factory=list)
    gen_parts: list = field(default_factory=list)
    dis_loss: list = field(default_factory=list)
    seconds: dict = field(default_factory=dict)


def train_client(cfg, seed: int, oc: LLMOneShotConfig, *, device,
                 params: dict | None = None):
    """Local training of one client on its own stream; returns (its
    parameters, detached, and the last loss)."""
    state = ST.make_train_state(cfg, lr=oc.client_lr, seed=seed,
                                params=params, device=device)
    step = ST.make_train_step(cfg)
    toks = make_lm_data(seed, vocab=cfg.vocab_size,
                        n_tokens=oc.client_tokens)
    loss = float("nan")
    for x, y in lm_batches(toks, CLIENT_BATCH, oc.client_seq, seed=seed,
                           steps=oc.client_steps):
        state, m = step(state, {"tokens": torch.from_numpy(x).to(device),
                                "labels": torch.from_numpy(y).to(device)})
        loss = float(m["loss"])
    return DL._frozen(state["params"]), loss


def dense_llm_oneshot(oc: LLMOneShotConfig = LLMOneShotConfig(), *,
                      device="cuda", noise: Callable | None = None,
                      client_params: list | None = None,
                      student_params: dict | None = None,
                      gen: torch.nn.Module | None = None,
                      log: Callable | None = print) -> LLMOneShotResult:
    """One round. ``client_params[i]`` (trained in place) and
    ``student_params``/``gen`` (trained in place) replace the random
    initial weights when given. Float32 runs without TF32
    (``configs.backend.full_float32``)."""
    dev = resolve_device(device)
    full_float32()
    ledger = CommLedger()
    cfgs = [oc.arch_config(a) for a in oc.client_archs]
    params, losses, seconds = [], [], {}
    t0 = time.perf_counter()
    for i, (arch, cfg) in enumerate(zip(oc.client_archs, cfgs)):
        p, loss = train_client(cfg, i, oc, device=dev, params=None
                               if client_params is None else client_params[i])
        ledger.record("up", f"client{i}", param_bytes(p),
                      "round0-model-upload")
        params.append(p)
        losses.append(loss)
        if log:
            log(f"client[{arch}] local LM loss {loss:.3f}")
    seconds["clients"] = time.perf_counter() - t0
    if log:
        log(f"one-shot upload: {ledger.uplink_bytes / 1e6:.1f} MB, "
            f"{ledger.rounds} round")

    stu_cfg = oc.arch_config(oc.student_arch)
    if student_params is None:
        student_params = T.init_model(stu_cfg, seed=SEED, device=dev)
    for t in T.leaves(student_params):
        t.requires_grad_(True)
    if gen is None:
        gen = tok_generator_init(
            nz=oc.nz, seq=oc.gen_seq, d_model=stu_cfg.d_model, d_g=oc.d_g,
            n_classes=stu_cfg.vocab_size,
            generator=torch.Generator().manual_seed(SEED), device=dev)
    gen_step, student_step, make_g_opt, make_s_opt = \
        DL.make_llm_dense_steps(stu_cfg, cfgs, g_lr=oc.g_lr, s_lr=oc.s_lr,
                                device=dev)
    g_opt, s_opt = make_g_opt(gen), make_s_opt(student_params)
    if noise is None:
        draws = torch.Generator(device=dev).manual_seed(SEED)

        def noise(epoch):
            z = torch.randn((oc.batch, oc.nz), generator=draws, device=dev)
            y = torch.randint(0, stu_cfg.vocab_size, (oc.batch, oc.gen_seq),
                              generator=draws, device=dev)
            return z, y

    res = LLMOneShotResult(cfgs, params, losses, stu_cfg, student_params, gen,
                           ledger, seconds=seconds)
    t0 = time.perf_counter()
    for epoch in range(oc.epochs):
        z, y = noise(epoch)
        for _ in range(T_G):
            gl, parts = gen_step(gen, g_opt, student_params, params, z, y)
        dl = student_step(student_params, s_opt, gen, params, z, y)
        res.gen_loss.append(float(gl))
        res.gen_parts.append({k: float(v) for k, v in parts.items()})
        res.dis_loss.append(float(dl))
        if log and (epoch + 1) % 3 == 0:
            p = res.gen_parts[-1]
            log(f"epoch {epoch + 1:2d} gen={res.gen_loss[-1]:7.3f} "
                f"(ce={p['ce']:.3f} bn={p['bn']:.3f} div={p['div']:.3f}) "
                f"distill_kl={res.dis_loss[-1]:.4f}")
    seconds["server"] = time.perf_counter() - t0
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the example's federation at smoke widths")
    fam = ap.add_mutually_exclusive_group()
    fam.add_argument("--ssm", action="store_true",
                     help="the ssm federation (mamba2 clients and student)")
    fam.add_argument("--moe", action="store_true",
                     help="the moe federation (deepseek-v2 clients and "
                     "student)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every model's depth (default: the arch's)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.ssm:
        oc = SMOKE_SSM if a.smoke else full_ssm()
    elif a.moe:
        oc = SMOKE_MOE if a.smoke else full_moe()
    else:
        oc = LLMOneShotConfig() if a.smoke else full()
    if a.layers is not None:
        oc = dataclasses.replace(oc, n_layers=a.layers)
    res = dense_llm_oneshot(oc, device=a.device)
    print(f"done: {len(res.client_cfgs)} clients, {res.ledger.rounds} round,"
          f" {res.ledger.uplink_bytes} B up; a global student distilled from"
          " the ensemble with no data")
    return res


if __name__ == "__main__":
    main()
