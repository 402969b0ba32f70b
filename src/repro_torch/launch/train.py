"""LM training (``repro/launch/train.py:28-85``).

Trains an LM (an attention family, mamba2-130m or zamba2-7b) on the
procedural Markov token stream (``data.make_lm_data``, ``data.lm_batches``,
the reference's streams) with ``launch/steps.make_train_step``: Adam,
global-norm clip 1.0, each block recomputed in the backward where
``cfg.remat`` (the full configs). On the card every attention layer runs
K2 forward and backward, every mamba block K3f and K3b.

Usage (full width unless ``--smoke``; the card unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        [--smoke] --steps 50 --batch 8 --seq 256 [--lr 3e-4] [--device cuda]

``--ckpt PATH`` saves the trained parameters there at the end
(``checkpoint/io.py``: ``PATH.npz`` and ``PATH.json`` with ``arch``,
``steps`` and ``final_loss``), under the reference's keys and layouts
(``interop.lm_params_to_reference``, bfloat16 widened exactly to
float32), so ``repro.checkpoint.restore_checkpoint`` reads it, and
``restore_checkpoint(PATH, state["params"])`` reads the reference's.
Model parallelism (``--model-parallel`` > 1) and training the moe and
vlm families and gemma3's sliding-window pattern (they serve only,
``transformer.check_trainable``) are not ported and raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import interop
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.backend import resolve_device
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data import lm_batches, make_lm_data
from repro_torch.launch import steps as ST


def train(arch: str, *, steps: int, batch: int, seq: int, smoke: bool,
          lr: float = 3e-4, seed: int = 0, model_parallel: int = 1,
          ckpt: str | None = None, log_every: int = 10, device="cuda"):
    """Train ``arch`` for ``steps`` steps of (batch, seq) windows from
    random weights (``seed``). Returns (state, losses), the losses read
    on the host after every step; with ``ckpt`` the parameters are saved
    there (module doc)."""
    if model_parallel != 1:
        raise NotImplementedError("model parallelism is not ported yet "
                                  "(ROADMAP.md, Queue 1 item 12)")
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    state = ST.make_train_state(cfg, lr=lr, seed=seed, device=dev)
    step_fn = ST.make_train_step(cfg)
    toks = make_lm_data(seed, vocab=cfg.vocab_size,
                        n_tokens=max(200_000, batch * (seq + 1) * 4))
    t0 = time.perf_counter()
    losses = []
    for i, (x, y) in enumerate(lm_batches(toks, batch, seq, seed=seed,
                                          steps=steps)):
        b = {"tokens": torch.from_numpy(x).to(dev),
             "labels": torch.from_numpy(y).to(dev)}
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        if (i + 1) % log_every == 0:
            dt = time.perf_counter() - t0
            print(f"step {i + 1:5d} loss {losses[-1]:.4f} "
                  f"ce {float(m['ce']):.4f} ({dt / (i + 1):.2f}s/step)",
                  flush=True)
    if ckpt:
        save_checkpoint(ckpt, interop.lm_params_to_reference(state["params"]),
                        meta={"arch": arch, "steps": steps,
                              "final_loss": losses[-1]})
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    _, losses = train(a.arch, steps=a.steps, batch=a.batch, seq=a.seq,
                      smoke=a.smoke, lr=a.lr,
                      model_parallel=a.model_parallel, ckpt=a.ckpt,
                      device=a.device)
    print(f"first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
