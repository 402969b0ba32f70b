"""Serving driver: a batch-style wrapper and CLI over ``ServeEngine``
(``repro/launch/serve.py``).

``serve(arch, batch=..., ...)`` submits ``batch`` synthetic prompts of
one length and drains the engine, returning ``(tokens, stats)``. The
prompts come from ``numpy.random.default_rng(seed)``, not from
``jax.random`` as in the reference, so the two packages draw different
prompts from one seed; the weights are random from ``seed`` too.

Usage (full width unless ``--smoke``; the card unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        [--smoke] --batch 4 --prompt-len 64 --gen 32 [--mode paged|dense] \
        [--device cuda]

``--arch`` is any architecture the reference registers
(``configs.available_archs()``). The engine's default mode is paged for
the dense and audio families, mamba2-130m (ssm) and zamba2-7b (hybrid),
and dense for gemma3-4b (its sliding window), deepseek-v2-lite-16b and
deepseek-v2-236b (MLA and MoE) and llama3.2-vision-11b (cross-attention
onto the engine's zero patch embeddings), which have no paged layout.

``--model-parallel N`` serves on ``launch/mesh.make_host_mesh(N)`` over
``torchrun``'s world, as the reference (``repro/launch/serve.py:35``):
the MoE layers expert-parallel over ``model``, the engine in dense mode,
every rank generating the same tokens. Two ranks on one card (gloo,
``launch/mesh``'s backend rule) or on the CPU:

    torchrun --nproc_per_node 2 -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --smoke --model-parallel 2 [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.backend import full_float32
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.launch.engine import ServeEngine
from repro_torch.launch.mesh import entry_mesh


def serve(arch: str, *, batch: int, prompt_len: int, gen: int,
          smoke: bool = True, model_parallel: int = 1, seed: int = 0,
          params=None, greedy: bool = True, temperature: float = 1.0,
          mode: str | None = None, device="cuda"):
    """``batch`` synthetic requests through a ServeEngine on
    ``model_parallel`` ranks a model group (module doc; no mesh at 1
    without a world). Returns (tokens (batch, gen) int32, stats with
    prefill_s, decode_s and tok_per_s). Float32 runs without TF32
    (``configs.backend.full_float32``)."""
    mesh, device = entry_mesh(model_parallel, device)
    full_float32()
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len), dtype=np.int32)
    eng = ServeEngine(cfg, params, mesh=mesh, max_reqs=batch,
                      max_len=prompt_len + gen, mode=mode, seed=seed,
                      device=device)
    sampling = None if greedy else {"temperature": temperature}
    rids = [eng.submit(prompts[i], max_new=gen, sampling=sampling)
            for i in range(batch)]
    results = eng.drain()
    tokens = np.stack([results[r] for r in rids])
    decode_s = eng.stats["decode_s"]
    return tokens, {"prefill_s": eng.stats["prefill_s"],
                    "decode_s": decode_s,
                    "tok_per_s": batch * gen / max(decode_s, 1e-9)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--mode", choices=["paged", "dense"], default=None,
                    help="engine mode (default: paged where supported)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    toks, stats = serve(a.arch, batch=a.batch, prompt_len=a.prompt_len,
                        gen=a.gen, smoke=a.smoke,
                        model_parallel=a.model_parallel, mode=a.mode,
                        seed=a.seed, device=a.device)
    print("generated shape:", toks.shape)
    print({k: round(v, 3) for k, v in stats.items()})


if __name__ == "__main__":
    main()
