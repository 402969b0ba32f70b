"""LM training (``repro/launch/train.py:28-85``).

Trains any registered LM on the procedural Markov token stream
(``data.make_lm_data``, ``data.lm_batches``, the reference's streams)
with ``launch/steps.make_train_step``: Adam, global-norm clip 1.0, each
block recomputed in the backward where ``cfg.remat`` (the full configs),
the MoE load-balance term in the loss (``router_aux_coef``). A vlm gets
the reference's batch: zero patch embeddings (batch, n_patches,
vision_dim) beside the tokens (``repro/launch/train.py:32-35``). On the
card every GQA layer without a window pattern (the dense, audio and
hybrid families, a vlm's self layers) runs K2 forward and backward, every
mamba block K3f and K3b; gemma3's windowed layers, MLA, the MoE layers
and cross-attention stay on the plain path, as in the reference.

Usage (full width unless ``--smoke``; the card unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        [--smoke] --steps 50 --batch 8 --seq 256 [--lr 3e-4] [--layers N] \
        [--device cuda]

``--ckpt PATH`` saves the trained parameters there at the end
(``checkpoint/io.py``: ``PATH.npz`` and ``PATH.json`` with ``arch``,
``steps`` and ``final_loss``), under the reference's keys and layouts
(``interop.lm_params_to_reference``, bfloat16 widened exactly to
float32), so ``repro.checkpoint.restore_checkpoint`` reads it, and
``restore_checkpoint(PATH, state["params"])`` reads the reference's.
Float32 runs without TF32 (``configs.backend.full_float32``).

``--model-parallel N`` runs on ``launch/mesh.make_host_mesh(N)``, the
("data", "model") mesh over ``torchrun``'s world, as the reference's
driver does (``repro/launch/train.py:37-40``): the MoE layers run
expert-parallel over ``model`` (each rank holds E/N experts a layer,
``launch/shardings.local_params``), every other layer and the batch
replicated. Two ranks on one card (gloo, ``launch/mesh``'s backend
rule) or on the CPU:

    torchrun --nproc_per_node 2 -m repro_torch.launch.train \
        --arch deepseek-v2-lite-16b --smoke --model-parallel 2 [--device cpu]

Every rank logs the same history; ``--ckpt`` gathers the expert rows
over ``model`` and rank 0 alone writes. Without a world and at
``--model-parallel 1`` no mesh is built (a one-rank mesh gives the same
results bit for bit).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import interop
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.backend import full_float32
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data import lm_batches, make_lm_data
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import entry_mesh


def train(arch: str, *, steps: int, batch: int, seq: int, smoke: bool,
          lr: float = 3e-4, seed: int = 0, model_parallel: int = 1,
          ckpt: str | None = None, log_every: int = 10, device="cuda",
          n_layers: int | None = None, dtype: str | None = None):
    """Train ``arch`` (``n_layers`` deep where given, in ``dtype`` where
    given: the compute and parameter dtype) for ``steps`` steps of
    (batch, seq) windows from random weights (``seed``) on
    ``model_parallel`` ranks a model group (module doc). Returns (state,
    history), one dict a step read on the host after it: loss, ce,
    moe_aux and grad_norm as floats, and the step's seconds on the host
    clock (to the metrics' read, which waits for the device); on a mesh
    (``make_host_mesh(model_parallel)`` gives it back) the state holds
    this rank's expert rows. With ``ckpt`` the parameters are saved
    there (module doc)."""
    mesh, dev = entry_mesh(model_parallel, device)
    full_float32()
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    state = ST.make_train_state(cfg, lr=lr, seed=seed, device=dev, mesh=mesh)
    step_fn = ST.make_train_step(cfg, mesh)
    vision = None
    if cfg.family == "vlm":
        vision = torch.zeros((batch, cfg.n_patches, cfg.vision_dim),
                             device=dev)
    toks = make_lm_data(seed, vocab=cfg.vocab_size,
                        n_tokens=max(200_000, batch * (seq + 1) * 4))
    t0 = time.perf_counter()
    history = []
    for i, (x, y) in enumerate(lm_batches(toks, batch, seq, seed=seed,
                                          steps=steps)):
        b = {"tokens": torch.from_numpy(x).to(dev),
             "labels": torch.from_numpy(y).to(dev)}
        if vision is not None:
            b["vision"] = vision
        t_step = time.perf_counter()
        state, m = step_fn(state, b)
        h = {k: float(v) for k, v in m.items()}
        history.append(h | {"seconds": time.perf_counter() - t_step})
        if (i + 1) % log_every == 0:
            dt = time.perf_counter() - t0
            print(f"step {i + 1:5d} loss {h['loss']:.4f} "
                  f"ce {h['ce']:.4f} ({dt / (i + 1):.2f}s/step)",
                  flush=True)
    if ckpt:
        full = SH.gather_params(state["params"], cfg, mesh)
        if mesh is None or mesh.get_rank() == 0:
            save_checkpoint(ckpt, interop.lm_params_to_reference(full),
                            meta={"arch": arch, "steps": steps,
                                  "final_loss": history[-1]["loss"]})
    return state, history


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
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the config's)")
    a = ap.parse_args(argv)
    _, hist = train(a.arch, steps=a.steps, batch=a.batch, seq=a.seq,
                    smoke=a.smoke, lr=a.lr,
                    model_parallel=a.model_parallel, ckpt=a.ckpt,
                    n_layers=a.layers, device=a.device)
    print(f"first loss {hist[0]['loss']:.4f} -> last "
          f"{hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
