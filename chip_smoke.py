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
     computes), the CUDA C++ build (K4, K2 and its sm90 route, K3 and
     K3's sm90 route, one ``nvcc`` each, all started together) with
     ``nvcc -Xptxas -v``'s register and spill counts;
  2. K1f and K1b (Triton, both teacher-gradient settings) against their
     plain PyTorch versions, timed with CUDA events beside their bound,
     at the DENSE main path's shape (128, 10), a ragged (1000, 32003), a
     vocabulary-scale (4096, 32768), the LLM path's (1024, 128256)
     (B·gen_seq rows of llama's vocabulary) and the moe LLM path's
     (1024, 102400) (deepseek-v2's), in float32 and bfloat16, the
     float32 rows at (128, 10) and (1024, 128256) with their kernels'
     device time (``torch.profiler``); then both again in float32 at those
     two shapes on rows holding NaN and ±inf entries and a whole NaN row
     (what a poisoned epoch hands K1): NaN exactly where the plain version
     gives NaN, ±inf equal, the finite entries within the tolerance; and
     a Triton launch that does nothing, timed the same ways: the floor
     under K1's rows at (128, 10);
  3. K4 (its ``sm90`` route, the split-context kernel and its merge) at
     the serve shape (R 8, Hq 24, Hkv 8, D 128, page 16, M 32, ragged
     seq_lens with 0 and a full table), a D = 32 shape, zamba2-7b's
     shared block (Hq = Hkv = 32, D = 112), musicgen-large's heads (Hq =
     Hkv = 32, D = 64, the audio family's paged decode) and a long shape
     (M 256,
     up to 4096 tokens), in float32 and bfloat16 (and float16 at the
     serve and long shapes), against its plain version, beside its
     device time (``torch.profiler``), the first version (the ``simt``
     route) on the same inputs and ``F.scaled_dot_product_attention`` on
     the K/V already gathered into a contiguous cache (a yardstick only:
     it leaves the paging out). The pools are rotated through copies
     larger than the L2 cache, so each call reads them from device
     memory, as a decode step does;
  4. K2 (K2f, K2q, K2kv, CUDA C++) against its plain versions in float32
     without TF32 and in bfloat16 (and float16 at every shape but D = 32),
     at the server shape (B 4, Hq 24, Hkv 8, S 256, D 128), the train
     shape (B 8), llama3.2-vision-11b's self layers at family_train's
     batch (B 4, Hq 32, Hkv 8: GQA groups of 4), one 4096-token sequence, ragged shapes with a window and
     dead rows at D = 32, 64, 112 and 128, D = 64 and D = 112 (zamba2's
     shared block at B 2, S 512); timed beside its bound and
     ``F.scaled_dot_product_attention`` pinned to a named backend (its
     autograd backward for K2q and K2kv), wall and device time. Each row
     names its kernel's route: ``sm90`` (the tensor-core kernels,
     bfloat16 and float16 at D 64, 112 and 128, and the float32 kernels
     of K2f, K2q and K2kv for the CUDA cores at every D), whose rows also
     time the ``simt`` kernel (the first version) on the same inputs, or
     ``simt`` (16 bits at D 32); every row also gives its kernel's device
     time from ``torch.profiler``;
  5. the DENSE main path at the paper's full width (``paper_cifar.CONFIG``:
     five width-1.0 resnet18 clients on 32x32x3 images, batch 128,
     synth_batch 128, nz 100, t_g 30), depth cut to one local epoch and
     two server epochs: ``build_federation`` → ``fedavg`` →
     ``train_dense_server`` → ``evaluate``, on the default engines: the
     grouped LocalUpdate engine (``client_loop="grouped"``: the five
     clients as one stacked network), the grouped teacher and the fused
     epoch driver (the first epoch eager, then one captured epoch
     replayed as a CUDA graph; one host read a chunk). Every launch
     count is zeroed just before it; K1's must each read
     epochs·(t_g + s_steps) just after, every other kernel's 0; the
     driver must be the fused one with epochs − 1 replays. Then the
     python driver on the same clients, timed beside it;
  6. grouped_check, on the main path's five resnet18 clients at batch
     128, cut to one local epoch on shards of at most 400 images: from the
     same inits, the grouped engine against the per-client loop (params
     and BN running statistics, 1e-3 of 1 + each entry, a limit that the
     phase shows to lie above the loop's one-ulp floor and below five
     planted faults), and the grouped teacher against the looped
     ensemble on one generator batch (logits with and without folded BN,
     L_BN and the image gradient, 1e-4 of each largest entry), in full
     float32; then, in turns in the same process, the local phase each
     way, one server epoch each way, the teacher's device time (summed
     and busy) in a generator step and in a student step each way, and
     each one's peak device memory;
  7. one server epoch of the main path under ``torch.profiler``: device
     busy share and kernel time by name; then the same epoch captured
     and replayed as the fused driver runs it: capture seconds, the
     replay's time, device records and idle share;
  8. paper_tables, the paper's comparison on the main path's five trained
     clients at its cuts: FedDF, Fed-DAFL and Fed-ADI (Table 1), DENSE on
     a federation trained with LDAM (Table 4) and two rounds of
     multi-round DENSE (Table 5), each with its seconds, seconds an epoch
     and accuracy; K1's counts zeroed before each and read after it
     (epochs·s_steps of each for a baseline, epochs·(t_g + s_steps) for
     DENSE+LDAM, two rounds of that for multi-round), the multi-round
     ledger (2 rounds, one broadcast of n_clients models) and the phase's
     peak device memory;
  9. fault_round, the fault-tolerant one-shot round on the main path's
     five trained clients (no second local phase): (a) a NaN upload
     (client 1) and a dropped one (client 3) through
     ``apply_upload_faults`` and ``admit_uploads`` leave clients 0, 2
     and 4, and the ledger 4 delivered, 1 dropped and 1 rejected event
     and 4 uploads' bytes; (b) a sign flip of client 2 is caught by the
     leave-one-out cosine screen (``cos_screen=0.0``), and raises under
     the strict policy and under a quorum of 0.9; (c) the masked teacher
     equals one stacked from the survivors alone to 1e-6 of its largest
     logit, and ``fedavg`` over the survivors runs; (d) three server
     epochs (t_g cut from 30 to 10) on the admitted clients with epoch
     1's latents NaN:
     ``nan_policy="skip"`` with a checkpoint every epoch (epochs 0 and 2
     finite), ``"rollback"``, a run killed after epoch 2 and resumed
     from its checkpoint, and a second uninterrupted skip run: the
     resumed run and rollback may differ from the skip run by no more
     than the two uninterrupted runs differ (cuDNN's and PyTorch's
     deterministic algorithms on, so that is 0), and each run launches
     K1f and K1b epochs·(t_g + s_steps) times; then the skip guard's
     cost a step, the steps with and without it in alternating turns,
     resolved only where it exceeds the spread between turns of one
     kind, and the phase's peak device memory;
 9a. fused_check, the fused driver against the python driver on the
     main path's five trained clients under deterministic algorithms
     (``fused_check``'s docstring), t_g cut from 30 to 10: 3 epochs in
     chunks of 2, a restart
     from the epoch-2 checkpoint, chunk-granular rollback and skip with
     epoch 1 poisoned, bit for bit (else held to 1e-5 of each tensor's
     largest entry), K1's launches exact and one host read a chunk;
 9b. mesh_round, the one-shot round with ``ensemble_shard_mode=
     "clients"`` on a one-rank NCCL world over the card against the same
     round unsharded (``mesh_round``'s docstring), fused_check's cuts:
     the sharded grouped engine, FedAvg (flat, and the tree sharded),
     both DENSE stages on the fused driver with the teacher's
     all-reduces captured in its graph; uploads, both averages, the
     generator, the student and every loss bit for bit, K1's launches
     exact, each run's epoch seconds;
 9c. scale_round, the one-shot round at m = 1000 cnn1 clients
     (``SCALE``: paper_cifar's widths, 50,000 images, α 0.1, batch 64,
     quantile buckets, 64-client slices, tree FedAvg of fan-in 8, the
     teacher in 64-client chunks, 2 fused server epochs, t_g cut from
     30 to 5):
     bucketed local training against the single-plan engine, the
     padded-step waste cut 3x, tree ≡ flat FedAvg, the chunked teacher
     against the unchunked one at m = 200 with both peaks, one round of
     m uploads, K1's launches and every loss finite; a cnn1 + cnn2
     federation's local phase too;
 10. one server step of a small federation on the card (K1 kernels) and
     on the CPU (the plain ``ref`` KL) from the same weights and images:
     the losses, their gradient with respect to the images and the
     student's update must agree to 1e-4 (the CPU path is held to the JAX
     package by the tests);
 11. serve_check: llama3.2-3b at full width (d_model 3072, vocab 128256)
     with depth cut to 2 layers, float32 without TF32: the paged engine
     (K4) and the dense engine give the same tokens for 6 ragged
     requests in 4 slots, and K4 launches decode steps × layers times,
     every launch on the ``sm90`` route;
 12. serve, the serving main path: llama3.2-3b at full width and depth,
     bfloat16, random weights from a seeded ``torch.Generator``; 16
     requests (prompts of 64–448 tokens, 32–64 new, max_len 512) through
     8 slots of the paged engine, page 16. Every launch count is zeroed
     just before it; K4's must read decode steps × 28 just after, all on
     ``sm90``, the others 0. Then one decode step of 8 running requests under
     ``torch.profiler``: device idle share and the top kernels, with
     K4's share;
 13. train_check: one train step of llama3.2-3b at full width, 2 layers,
     float32: the K2 route (K2f, K2q and K2kv on their float32 ``sm90``
     kernels, the routes printed by kernel) and the plain route agree to
     1e-4;
 14. dense_llm_check: one generator step and one student step of the
     example's heterogeneous federation (smoke widths) on the card and on
     the CPU agree to 1e-4;
 15. llm_main_path, the LLM DENSE main path at full width and depth
     (``dense_llm_oneshot.full()``: two llama3.2-3b clients, a llama3.2-3b
     student, bfloat16): 3 local train steps a client, the one-shot
     upload, 2 epochs of 3 generator steps and a student step. Every
     launch count is zeroed before each step and checked after it (a
     train step: K2f 2L, K2q L, K2kv L; a generator step: (n+1)L of each
     and one K1f, K1b; a student step: (n+1)L K2f, L K2q and K2kv, one
     K1f, K1b), every K2f, K2q and K2kv launch on the ``sm90`` route;
     then one epoch under ``torch.profiler`` with K2's share, each K2
     kernel's time by route;
 16. K3 (K3f, K3b, CUDA C++) against its plain versions (the chunked formula
     in PyTorch and autograd through it): mamba2-130m's train shape (8, 256,
     24 heads, P 64, N 128, chunk 256) in bfloat16, float16 and float32,
     zamba2-7b's prefill (1, 448, 112 heads, P 64, N 64) in bfloat16 and
     float32, its train shape (2, 512, two chunks: ssm_hybrid_train's and
     ssm_train_check's) in bfloat16, float16 and float32, one 4096-token
     sequence (16 chunks), zamba2's widths at 300 tokens (a tail of 44)
     with an initial state in bfloat16 and float32 and at 100 (a clamped
     chunk) in bfloat16, and a ragged, grouped shape with an initial
     state in float32, also held to the sequential recurrence; timed beside
     its bound (no PyTorch call computes the scan), each row with its
     kernels' device time (``torch.profiler``). Each row names its route:
     ``sm90`` (the chunk-parallel kernels at P 64, N 64/128 in every dtype:
     tensor cores in 16 bits, CUDA cores in float32), whose rows also time
     the first version (``simt``) on the same inputs, give each kernel's
     device time (``device_ms_by_phase``) and compare two calls bit for
     bit, or ``simt`` (ragged_grouped). K3b reads the states the forward
     wrote and dy in x's dtype, as the model hands it; a 16-bit sm90 K3f
     row gives y's error over its rounding bound, a 16-bit sm90 K3b row
     its gradients' error against the float32 plain version (1e-2 of each
     largest entry, d(initial_state) 1e-4) and against the route's
     roundings emulated (``ssd_scan_bwd_chunked_plain``), each over its
     tolerance; a float32 row holds y, the states and all six gradients to
     1e-4 of the plain versions;
 17. ssm_serve_check: zamba2-7b (7 layers: a super-block of 6 mamba
     blocks and the shared block, and one tail block) and mamba2-130m (2
     layers) at full width, float32: paged ≡ dense engine for 6 requests
     of up to 300 tokens (two chunks, a ragged tail) in 4 slots, K3f once
     a mamba block a prefill and K4 once a shared-block application a
     decode step, both on ``sm90``;
 18. ssm_serve: zamba2-7b at full width and depth (81 mamba blocks, 13
     applications of the shared block, bfloat16), the serve phase's 16
     requests through 8 slots: K3f must read prefills × 81 and K4 decode
     steps × 13, both on ``sm90``; then one profiled decode step;
 19. ssm_train_check: one zamba2-7b train step at full width, 7 layers,
     float32, batch 2 × 512 (two chunks): the K3/K2 route and the plain
     route agree to 1e-4 (K3f 2 × 7 with remat and K3b 7, all on
     ``sm90``, K2 on the one shared-block application: K2f, K2q and K2kv
     on their float32 ``sm90`` kernels); then one mamba2-130m train step
     at full width and depth (24 layers, 129 M parameters), float32,
     batch 8 × 256 (one chunk: K3f and K3b at the mamba2_train kernel
     rows' shape, 48 and 24 launches, all on ``sm90``), held the same way;
     each reports the plain route against itself at half the chunk
     (``plain_half_chunk_vs_plain``), the floor of float32 summation
     order;
 20. ssm_hybrid_train: zamba2-7b's train step in bfloat16 at full width
     (d_model 3584, 32/32 heads of 112, P 64, N 64), depth 81 → 13 (two
     super-blocks of 6 mamba blocks, each followed by the shared block,
     and a tail block), batch 2 × 512: the plain route's first step (loss,
     grad_norm), then 3 steps of the kernel route, each counted (K2f 4,
     K2q 2, K2kv 2, K3f 26, K3b 13), K2 on ``sm90`` at D 112, K3 on
     ``sm90``; the first loss and grad_norm within
     2e-4 of the plain route's (limits set from sound and faulty steps:
     ``scripts/hybrid_step_limits.py``); seconds a step, peak memory,
     and one more step under ``torch.profiler`` with K2's and K3's device
     time by route;
 21. ssm_llm_main_path, the LLM DENSE main path with the ssm family
     (``dense_llm_oneshot.full_ssm()``: two mamba2-130m clients and a
     mamba2-130m student, full width and depth, bfloat16), counted step by
     step as in 14 with K3f and K3b in place of K2, every K3f and K3b
     launch on ``sm90``; then one epoch under ``torch.profiler`` with
     K3's share, K3f's and K3b's device time by route;
 22. the dense-mode families and the audio family's paged cache
     (``family_phases``): serve_check (as 11) for musicgen-large (K4 at
     D 64), qwen1.5-4b and phi3-medium-14b; audio_serve, musicgen-large
     at full width and depth (48 layers, bfloat16) through the serve
     phase's traffic, K4 decode steps × 48 on ``sm90``, and its profiled
     decode step; family_serve, the dense-mode engine in bfloat16 at full
     width on gemma3-4b (a 1536-token prompt, past its 1024 window),
     llama3.2-vision-11b, deepseek-v2-lite-16b (full depth) and
     deepseek-v2-236b (depth 60 → 4), four requests of 16 new tokens
     each: every sampled logit row finite, no K2, K3 or K4 launch,
     prefill seconds, ms a decode step and peak memory; family_check,
     float32 without TF32 at full width (gemma3-4b depth 6 over 1040
     tokens, deepseek-v2-lite-16b depth 2, llama3.2-vision-11b one
     super-block with random patch embeddings and both gates non-zero):
     prefill and 4 teacher-forced decode steps on the card against the
     CPU within 1e-4 of the largest logit, a tolerance the float32 floor
     (against a float64 run on the card) must lie below; long_prefill, a
     4096-token prefill through the blockwise path against the
     materialized one (gemma3-4b depth 6, deepseek-v2-lite-16b depth 2;
     without and with a cache), float32, 1e-4; vlm_kernel_check,
     llama3.2-vision-11b at full width, one super-block, bfloat16, B 2 ×
     S 256, no cache: K2f launches once a self layer, on ``sm90`` at
     D 128, and its logits lie no further from a float32 run's than
     twice the plain route's;
 23. family_train: ``launch.train.train`` in bfloat16 at full width, 3
     steps of B 4 x S 256 from random weights, on gemma3-4b (full depth,
     34 layers), deepseek-v2-lite-16b (depth 27 -> 6) and
     llama3.2-vision-11b (40 -> 10, two super-blocks, the reference's zero
     patch embeddings): every step's loss and grad_norm finite and > 0,
     moe_aux > 0 for lite, seconds a step and peak memory; the vlm's self
     layers K2f 16, K2q 8 and K2kv 8 a step on ``sm90`` at D 128, no K2 in
     gemma3 or lite; then deepseek-v2-236b (60 -> 2) one bfloat16 loss
     and gradient, no optimizer step (its float32 Adam moments would not
     fit beside its weights with a margin);
 24. family_train_check: the train step's loss and every gradient in
     float32 without TF32 at full width on the card against the CPU,
     within 1e-4 of each tensor's largest entry, the float32 floor (the
     card against its float64 run) below it: gemma3-4b depth 6 over 1040
     tokens (past its window), deepseek-v2-lite-16b depth 2 with a
     capacity that drops tokens, llama3.2-vision-11b one super-block with
     random patch embeddings and both gates non-zero, whose kernel route
     (float32 K2f 8, K2q 4, K2kv 4 on ``sm90``) is also held to its plain
     route on the card;
 25. moe_llm_main_path, LLM DENSE with the moe family
     (``dense_llm_oneshot.full_moe()``: two deepseek-v2-lite-16b clients
     and a lite student, full width, depth 27 -> 3, bfloat16), counted
     step by step as in 14: no K2 (MLA), K1f and K1b once a server step at
     (1024, 102400), 8 pairs in the 2 epochs; uplink bytes and one round;
     then one epoch under ``torch.profiler`` with K1's device time and the
     idle share;
 26. pod_distill, after 15's profile on its context: the pod
     distillation step (``launch.steps.make_distill_step``) on its two
     trained llama3.2-3b clients stacked (12.85 GB; the client list then
     views the stack) and its student, bfloat16, batch 4 x 256 of the
     generator's soft embeddings, a one-pod mesh, 3 steps of each route:
     materialized (K1f and K1b once a step at (1024, 128256)) and
     ``chunked_kl`` (64-token chunks, no K1), K2f 4·28, K2q and K2kv 28
     a step on ``sm90`` in both; the first losses agree to 1e-2
     relative; seconds a step and peak memory by route;
 27. pod_distill_check, after 15's context is freed: one step of each
     route in float32 without TF32, llama3.2-3b at full width cut to one
     layer, batch 2 x 64, on the card and on the CPU from the same
     weights: losses and the student's gradients within 1e-4, the card's
     K1 and float32 K2 launches counted;
 28. model_axis, after 25: the model axis at run time on a two-rank
     world spawned on the one card (gloo, ``launch/mesh``'s backend
     rule), deepseek-v2-lite-16b at full width cut to 3 layers (two MoE
     layers, 32 of the 64 experts a rank), float32 without TF32, each
     rank first running its share of the one-rank reference in a world
     of its own: 3 train steps of ``launch.train.train`` at
     ``--model-parallel`` 2 against 1 (losses, grad norms and Adam's
     moments within 1e-4 of each tensor's largest entry, the parameters
     within the larger of 1e-4 and twice the floor of two one-rank runs,
     the replicated parameters bit for bit across the ranks); the dense
     engine on model 2, 4 greedy requests of 16 new tokens (the same
     streams on every rank as the one-rank engine's, its first decode
     logits within 1e-4); one gen_step and one student_step of
     ``full_moe()``'s federation cut to 3 layers on the mesh (K1f and
     K1b once a step each at (1024, 102400) on every rank, the losses
     within 1e-4); then the partitioned trunk, the steps given the dry
     run's specs against the same steps at model 1: lite's 3 train steps,
     and llama3-2-3b at full width cut to 2 layers (12/4 heads a rank): 3
     train steps (K2f, K2q, K2kv on ``sm90``), a prefill and 8 greedy
     decode steps (logits within 1e-5 of their largest entry, tokens
     equal), one materialized pod step (K1f and K1b at (256, 128256) on
     the logits gathered over ``model``); the parameters held where
     every step's gradient is above 1e-3 of its tensor's largest; each
     part's seconds and peak GiB per rank.

Output: a line with the card's name and power limit, one JSON line per
phase, the ``{"kernels": [...]}`` line, and last the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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

# (R, V); (1024, 128256) is the LLM path's: B·gen_seq rows of llama's
# vocab, (1024, 102400) the moe LLM path's, deepseek-v2's vocab
SHAPES = ((128, 10), (1000, 32003), (4096, 32768), (1024, 128256),
          (1024, 102400))
MAIN_SHAPE = (128, 10)
# K1's float32 rows whose kernels' device time is read too
K1_DEVICE_SHAPES = ((128, 10), (1024, 128256))
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
# slots, the D = 64 one musicgen-large's heads (the audio family's paged
# decode, G = 1); the long one llama3.2-3b's heads at 8 requests of up to 4096
# tokens (ragged, ~67 MB of live K/V in bfloat16). float16 runs beside
# float32 and bfloat16 at the serve and long shapes (K4_FP16). atol
# only: the outputs are convex combinations of V.
K4_SHAPES = ((8, 24, 8, 128, 16, 32), (6, 4, 2, 32, 16, 8),
             (8, 32, 32, 112, 16, 32), (8, 24, 8, 128, 16, 256),
             (8, 32, 32, 64, 16, 32))
K4_SERVE_SHAPE = K4_SHAPES[0]
K4_FP16 = (K4_SHAPES[0], K4_SHAPES[3])
TOL_K4 = {"float32": (0.0, 1e-5), "bfloat16": (0.0, 1e-2),
          "float16": (0.0, 1e-2)}
# K2 shapes: (name, B, Hq, Hkv, Sq, Sk, D, causal, window). The server's
# and the train step's are llama3.2-3b's heads at the LLM main path's
# batches; "vlm" llama3.2-vision-11b's self layers (GQA groups of 4 at
# D 128) at family_train's batch; "long" one 4096-token sequence; "ragged_d32" the smoke heads
# with Sq > Sk (dead rows), a window and ragged tiles, and "ragged_d64"
# and "ragged_d128" the same at the sm90 routes' head dims, off every tile
# of K2f, K2q and K2kv; "d64" musicgen's heads; "d112" zamba2-7b's shared
# block at ssm_train_check's and ssm_hybrid_train's batch, and
# "ragged_d112" its head dim with Sq > Sk, a window, ragged tails past 64
# and 128 and GQA groups of 4. float16 runs beside float32 and bfloat16 at
# the shapes the 16-bit sm90 routes take (K2_FP16: every D but 32).
# Tolerance: float32 without TF32 on both sides (K2f's float32 sm90
# kernel included), 1e-4; 16-bit gradients are stored
# in the input dtype, 1e-2 of each tensor's largest entry (the sm90
# backward also rounds P and dS to the 16-bit type before their
# products, inside that). K2f's sm90 route (bfloat16, float16 at
# D 64, 112 and 128) rounds P to the 16-bit type before PV, so each o entry may
# move by u·max|v| (u = 2^-9 bfloat16, 2^-12 float16): o is held to
# atol = 2u·max|v|, rtol 0, and lse (float32 scores, float32 l) to 1e-4.
K2_SHAPES = (("server", 4, 24, 8, 256, 256, 128, True, 0),
             ("train", 8, 24, 8, 256, 256, 128, True, 0),
             ("vlm", 4, 32, 8, 256, 256, 128, True, 0),
             ("long", 1, 24, 8, 4096, 4096, 128, True, 0),
             ("ragged_d32", 2, 4, 2, 300, 200, 32, True, 64),
             ("ragged_d64", 2, 8, 2, 333, 250, 64, True, 100),
             ("ragged_d128", 2, 6, 2, 270, 199, 128, True, 80),
             ("d64", 4, 32, 32, 256, 256, 64, True, 0),
             ("d112", 2, 32, 32, 512, 512, 112, True, 0),
             ("ragged_d112", 2, 8, 2, 301, 230, 112, True, 90))
K2_FP16 = ("server", "train", "vlm", "long", "ragged_d64", "ragged_d128", "d64",
           "d112", "ragged_d112")
TOL_K2 = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 1e-2}
UNIT_ROUNDOFF = {"bfloat16": 2.0 ** -9, "float16": 2.0 ** -12}
# K3 shapes: (name, B, S, H, P, G, N, chunk, dtype, with an initial state).
# mamba2-130m's heads at a train step of the SSM LLM path (B 8, seq 256:
# one chunk), zamba2-7b's at a prefill of 448 tokens (two full chunks),
# one 4096-token sequence (16 chunks), zamba2's widths at 300 tokens (a
# tail of 44, not a multiple of 64) and at 100 (the chunk clamped to 100),
# both with an initial state, and a small ragged, grouped shape that is
# also held to the sequential recurrence (``ref.ssd``/``ssd_grads``). K3f
# and K3b take their sm90 route at P 64 and N 64 or 128 in every dtype
# (every shape but ragged_grouped); the float32 rows are mamba2-130m's
# and zamba2-7b's train shapes and zamba2's prefill and ragged tail.
# Tolerance, relative to each tensor's largest entry: float32 1e-4; in 16
# bits y is stored in 16 bits (1e-2), the states and gradients are
# float32 from the same 16-bit inputs (1e-4). A 16-bit sm90 row also gives
# y's error over its rounding bound 2u (sum|terms| + |y|) elementwise
# (``y_err_over_bound``, at most 1 if the bound holds; u = 2^-9 bfloat16,
# 2^-12 float16).
K3_SHAPES = (("mamba2_train", 8, 256, 24, 64, 1, 128, 256, "bfloat16", False),
             ("mamba2_train", 8, 256, 24, 64, 1, 128, 256, "float16", False),
             ("zamba2_prefill", 1, 448, 112, 64, 1, 64, 256, "bfloat16",
              False),
             ("zamba2_train", 2, 512, 112, 64, 1, 64, 256, "bfloat16",
              False),
             ("zamba2_train", 2, 512, 112, 64, 1, 64, 256, "float16", False),
             ("long", 1, 4096, 24, 64, 1, 128, 256, "bfloat16", False),
             ("ragged_tail", 1, 300, 112, 64, 1, 64, 256, "bfloat16", True),
             ("clamped", 1, 100, 112, 64, 1, 64, 256, "bfloat16", True),
             ("ragged_grouped", 2, 300, 4, 32, 2, 16, 64, "float32", True),
             ("mamba2_train", 8, 256, 24, 64, 1, 128, 256, "float32", False),
             ("zamba2_prefill", 1, 448, 112, 64, 1, 64, 256, "float32",
              False),
             ("zamba2_train", 2, 512, 112, 64, 1, 64, 256, "float32", False),
             ("ragged_tail", 1, 300, 112, 64, 1, 64, 256, "float32", True))
TOL_K3 = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 1e-2}
# K3b: its gradients; on its sm90 route also against the chunked plain
# version with the route's roundings emulated (the same arithmetic: sums in
# another order, a value rounded to the neighbouring 16-bit number), as
# tests/test_torch_cuda.py holds it
K3B_GRADS = ("dx", "ddt", "da", "db", "dc", "dinit")
TOL_K3B_EMULATED = {"bfloat16": 2e-3, "float16": 5e-4}
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
        smi = card()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi did not report the card: {e!r}")
    print(smi, flush=True)
    precision = full_float32(torch)
    import triton

    from repro_torch.kernels import cuda_build

    t0 = time.perf_counter()
    try:
        cuda_build.build(["paged_attention", "flash_attention",
                          "flash_attention_sm90", "ssd_scan",
                          "ssd_scan_sm90"])
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


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


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
    """Every launch counter and K2's, K3's and K4's route counts to 0."""
    from repro_torch import kernels

    for counts in kernels.counters():
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    return {k: v for counts in launch_counts() for k, v in counts.items()}


def read_routes() -> dict:
    """K2's, K3's and K4's launches by route since the last
    ``zero_counts``: ``fwd_sm90``, ``fwd_simt`` (K2f), ``bwd_sm90``,
    ``bwd_simt`` (K2q and K2kv, each launch once), ``dq_sm90``,
    ``dq_simt`` (K2q), ``dkv_sm90``, ``dkv_simt`` (K2kv), ``k3f_sm90``,
    ``k3f_simt``, ``k3b_sm90``, ``k3b_simt`` (a call once), ``k4_sm90``,
    ``k4_simt``."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PK
    from repro_torch.kernels import ssd_scan as K3

    return {f"{kind}_{route}": c for kind, counts in (
        ("fwd", FA.fwd_routes), ("bwd", FA.bwd_routes),
        ("dq", FA.dq_routes), ("dkv", FA.dkv_routes),
        ("k3f", K3.fwd_routes), ("k3b", K3.bwd_routes), ("k4", PK.routes))
        for route, c in counts.items()}


def check_k4_routes(label, launches, routes) -> None:
    """Every K4 launch of a phase took the sm90 route."""
    n = launches["paged_attention"]
    if routes["k4_sm90"] != n or routes["k4_simt"]:
        fail(f"{label}: K4's launches by route {routes}, expected all {n} "
             f"on sm90")


def k3f_route(torch, cfg) -> str:
    """The route K3f (and K3b, by one rule) takes in ``cfg``'s mamba
    blocks: sm90 at mamba2-130m's and zamba2-7b's widths in every dtype
    (float32 on the CUDA cores), simt at other widths."""
    from repro_torch.kernels import ssd_scan as K3

    return K3.fwd_route(getattr(torch, cfg.dtype), cfg.ssm_head_dim,
                        cfg.ssm_state)


def check_k2_routes(label, launches, routes, dtype, d) -> None:
    """Every K2f, K2q and K2kv launch of a phase took the route its dtype
    and head dim choose (``FA.route``), counted by kernel and with K2q
    and K2kv together."""
    from repro_torch.kernels import flash_attention as FA

    want = {f"{kind}_{r}": 0 for kind in ("fwd", "bwd", "dq", "dkv")
            for r in ("sm90", "simt")}
    for kind, which in (("fwd", "fwd"), ("bwd", "dq"), ("bwd", "dkv")):
        name = "flash_attention_" + ("fwd" if which == "fwd" else
                                     f"bwd_{which}")
        r = FA.route(which, dtype, d)
        want[f"{kind}_{r}"] += launches[name]
        if which != "fwd":
            want[f"{which}_{r}"] += launches[name]
    got = {k: routes[k] for k in want}
    if got != want:
        fail(f"{label}: K2's launches by route {got}, expected {want}")


def check_k3_routes(label, launches, routes, route) -> None:
    """Every K3f and every K3b launch of a phase took ``route``."""
    for kind, name in (("k3f", "ssd_scan_fwd"), ("k3b", "ssd_scan_bwd")):
        n = launches[name]
        if routes[f"{kind}_{route}"] != n or sum(
                routes[f"{kind}_{r}"] for r in ("sm90", "simt")) != n:
            fail(f"{label}: {kind.upper()}'s launches by route {routes}, "
                 f"expected all {n} on {route}")


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
            profiled = dname == "float32" and (R, V) in K1_DEVICE_SHAPES
            rows["fwd"].append({
                "shape": [R, V], "dtype": dname,
                "ok": all(c[0] for c in checks),
                "max_abs_err": max(c[1] for c in checks),
                "tol": TOL[dname],
                "ms": cuda_ms(torch, lambda: K.distill_kl_fwd(t, s)),
                "plain_ms": cuda_ms(torch,
                                    lambda: K.distill_kl_fwd_plain(t, s)),
                "bound_ms": b_ms, "bound_by": b_by,
                **(device_profile(
                    torch, lambda: K.distill_kl_fwd(t, s),
                    {"K1f": lambda n: "_kl_fwd_kernel" in n},
                    label=f"K1f {R}x{V}") if profiled else {})})

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
                    "bound_ms": b_ms, "bound_by": b_by,
                    **(device_profile(
                        torch, lambda: K.distill_kl_bwd(
                            t, s, lse_t, lse_s, kl, g, with_teacher_grad=wtg),
                        {"K1b": lambda n: "_kl_bwd_kernel" in n},
                        label=f"K1b {R}x{V}") if profiled else {})})
            del t, s, g, kl, lse_t, lse_s, plain
            torch.cuda.empty_cache()
    for name, rs in rows.items():
        for r in rs:
            emit({"kernel_check": {"name": f"distill_kl_{name}", **r}})
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks disagree with the plain versions: "
             f"{bad}")
    rows["launch_floor"] = empty_launch_floor(torch)
    emit({"kernel_check": {"name": "empty_triton_launch",
                           **rows["launch_floor"]}})
    return rows


def _empty_kernel(x_ptr):
    """A Triton kernel that does nothing (``triton.jit`` in
    ``empty_launch_floor``)."""
    pass


def empty_launch_floor(torch) -> dict:
    """The time of a Triton launch that does no work, on the host clock
    (CUDA events over a run of launches) and on the device
    (``torch.profiler``): the floor under K1's rows at (128, 10), whose
    bound is nanoseconds."""
    import triton

    kernel = triton.jit(_empty_kernel)
    x = torch.empty(1, device="cuda")

    def launch():
        kernel[(1,)](x, num_warps=1)

    launch()
    torch.cuda.synchronize()
    return {"ms": cuda_ms(torch, launch),
            **device_profile(torch, launch,
                             {"empty": lambda n: "_empty_kernel" in n},
                             label="empty Triton launch")}


# K1 on rows holding NaN and ±inf (what a poisoned epoch under
# nan_policy="skip" hands it): at the main path's and the LLM path's
# shapes, float32
NONFINITE_SHAPES = ((128, 10), (1024, 128256))


def plant_nonfinite(torch, t, s) -> dict:
    """Put NaN and ±inf into some rows of t and s (in place); returns
    which, by row."""
    V = t.shape[1]
    plan = {1: ("t", 3, float("nan")), 2: ("s", 5, float("nan")),
            3: ("t", 0, float("inf")), 4: ("t", V - 1, -float("inf")),
            5: ("s", 7, float("inf")), 6: ("s", V // 2, -float("inf")),
            7: ("t", None, float("nan"))}
    for row, (which, col, val) in plan.items():
        target = t if which == "t" else s
        if col is None:
            target[row] = val
        else:
            target[row, col] = val
    return {str(r): f"{w}[{'all' if c is None else c}] = {v}"
            for r, (w, c, v) in plan.items()}


def compare_nonfinite(torch, got, want, tol):
    """NaN exactly where ``want`` has NaN, ±inf equal, the finite entries
    within ``tol``: (ok, max abs error over the finite entries)."""
    got, want = got.float(), want.float()
    nan_same = bool((torch.isnan(got) == torch.isnan(want)).all())
    inf = torch.isinf(want) | torch.isinf(got)
    inf_same = bool((got[inf] == want[inf]).all())
    fin = torch.isfinite(want) & torch.isfinite(got)
    ok, err = compare(torch, got[fin], want[fin], tol) if bool(fin.any()) \
        else (True, 0.0)
    return nan_same and inf_same and ok, err


def k1_nonfinite_phase(torch):
    """K1f and K1b (both teacher-gradient settings) against their plain
    versions on rows with NaN and ±inf entries and a whole NaN row."""
    from repro_torch.kernels import distill_kl as K

    rows = []
    for R, V in NONFINITE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(R + V + 1)
        t = torch.randn(R, V, device="cuda", generator=gen) * 3
        s = torch.randn(R, V, device="cuda", generator=gen) * 3
        g = torch.rand(R, device="cuda", generator=gen)
        planted = plant_nonfinite(torch, t, s)
        fwd = K.distill_kl_fwd(t, s)
        torch.cuda.synchronize()
        plain = K.distill_kl_fwd_plain(t, s)
        checks = [compare_nonfinite(torch, a, b, TOL["float32"])
                  for a, b in zip(fwd, plain)]
        rows.append({"name": "distill_kl_fwd", "shape": [R, V],
                     "dtype": "float32", "planted": planted,
                     "ok": all(c[0] for c in checks),
                     "max_abs_err_finite": max(c[1] for c in checks),
                     "nan_rows": int(torch.isnan(plain[0]).sum()),
                     "tol": TOL["float32"]})
        kl, lse_t, lse_s = plain
        for wtg in (True, False):
            out = K.distill_kl_bwd(t, s, lse_t, lse_s, kl, g,
                                   with_teacher_grad=wtg)
            torch.cuda.synchronize()
            want = K.distill_kl_bwd_plain(t, s, lse_t, lse_s, kl, g,
                                          with_teacher_grad=wtg)
            checks = [compare_nonfinite(torch, a, b, TOL_GRAD["float32"])
                      for a, b in zip(out, want) if b is not None]
            rows.append({"name": "distill_kl_bwd", "shape": [R, V],
                         "dtype": "float32", "with_teacher_grad": wtg,
                         "ok": all(c[0] for c in checks),
                         "max_abs_err_finite": max(c[1] for c in checks),
                         "tol": TOL_GRAD["float32"]})
        del t, s, g, fwd, plain, kl, lse_t, lse_s
        torch.cuda.empty_cache()
    for r in rows:
        emit({"kernel_check": {**r, "nonfinite": True}})
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"K1 on non-finite rows disagrees with its plain version: {bad}")
    return rows


# ------------------------------------------------------------ main path --

def cifar_data(scfg) -> dict:
    """The procedural stand-in for CIFAR10 that the DENSE paths train on."""
    from repro_torch.data import make_classification_data

    return make_classification_data(
        scfg.seed, num_classes=scfg.num_classes, size=scfg.image_size,
        ch=scfg.in_ch, train_per_class=scfg.train_per_class,
        test_per_class=scfg.test_per_class)


def timed(torch, dev, fn):
    """(fn(), its seconds on the host clock, the device synchronized at
    both ends)."""
    sync(torch, dev)
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    return out, time.perf_counter() - t0


# main_path's seconds, which fault_round sets its own beside
MAIN_PATH_SECONDS: dict = {}


def main_path(torch, scfg, dev="cuda"):
    from repro_torch.configs import resolve_exec_policy
    from repro_torch.core import evaluate, train_dense_server
    from repro_torch.core.dense import _chunk_bounds
    from repro_torch.fl import ClientList, CommLedger, build_federation, fedavg

    data = cifar_data(scfg)
    xt, yt = data["test"]
    client_loop = resolve_exec_policy(scfg, device=dev).client_loop

    clocked = functools.partial(timed, torch, dev)
    ledger = CommLedger()
    zero_counts()
    (clients, _), t_fed = clocked(lambda: build_federation(
        scfg, data, device=dev, ledger=ledger, seed=scfg.seed))
    if client_loop != "grouped" or not isinstance(clients, ClientList):
        fail(f"the main path trained on client_loop={client_loop!r}, not "
             "the grouped engine")
    avg, t_avg = clocked(lambda: fedavg(clients))
    (student, _, hist), t_dense = clocked(lambda: train_dense_server(
        clients, scfg, device=dev))
    acc_dense, t_eval = clocked(lambda: evaluate(student, xt, yt))
    launches = read_counts()

    on_card = torch.device(dev).type == "cuda"
    want = scfg.epochs * (scfg.t_g + scfg.s_steps)
    # a CPU run (a rehearsal) takes the plain versions and launches nothing
    if on_card and launches != expected(distill_kl_fwd=want,
                                        distill_kl_bwd=want):
        fail(f"launches on the main path {launches}, expected {want} of "
             "each K1 kernel and no K4")
    chunks = _chunk_bounds(scfg.epochs, scfg.loop_chunk, 0)
    if on_card and (hist.loop != "fused"
                    or hist.graph_replays != scfg.epochs - 1):
        fail(f"the main path ran the {hist.loop!r} driver with "
             f"{hist.graph_replays} graph replays, expected the fused "
             f"driver and {scfg.epochs - 1}")
    if hist.loop == "fused" and hist.host_reads != len(chunks):
        fail(f"the fused driver read its losses {hist.host_reads} times, "
             f"expected once a chunk, {len(chunks)}")
    # the python driver on the same clients, timed beside it (a reading,
    # no claim)
    (_, _, hist_py), t_py = clocked(lambda: train_dense_server(
        clients, dataclasses.replace(scfg, loop_mode="python", epochs=1),
        device=dev))
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
    MAIN_PATH_SECONDS.update(build_federation=t_fed,
                             dense_per_epoch=t_dense / scfg.epochs)
    emit({"main_path": {
        "client_loop": client_loop, "driver": hist.loop,
        "graph_replays": hist.graph_replays,
        "capture_seconds": hist.capture_seconds,
        "host_reads": hist.host_reads, "chunks": chunks,
        "python_driver": {"seconds_one_epoch": t_py,
                          "host_reads": hist_py.host_reads,
                          "gen_loss": hist_py.gen_loss},
        "groups": [[spec.kind, n] for spec, n in clients.grouped[0]],
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


# -------------------------------------------------------- grouped check --

# grouped_check's cut: one local epoch on each client's first images
GROUPED_SHARD = 400
# float32 (no TF32) on both sides, summed in another order. The teacher's
# logits and image gradient relative to each one's largest entry, L_BN
# relative to itself: 1e-4. The trained params and running statistics,
# max |a - b| / (1 + |b|): 1e-3, since four SGD steps amplify float32
# roundoff. Every run reads both sides of that limit and fails unless it
# lies between them: below, the per-client loop against itself from
# inits moved by one ulp (``floor_one_ulp``); above, five engines that
# are wrong on purpose (``planted_faults``: the stack left at its inits,
# the first or the last step dropped, momentum lost, padded rows
# counted), each caught if either of its two readings is over the limit.
# Readings on an H100: PERF.md, section 6, PR 26.
GROUPED_TOL = 1e-4
GROUPED_TRAIN_TOL = 1e-3


def _rel_max(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def grouped_check(torch, scfg, dev="cuda"):
    """The grouped engine and the grouped teacher against the per-client
    loop and the looped ensemble on the main path's clients, then each
    way timed in turns (see the module docstring, phase 6)."""
    import copy

    import numpy as np

    from repro_torch import optim
    from repro_torch.core import (Client, bn_loss, ce_loss, ensemble_logits,
                                  grouped_teacher, img_generator_init,
                                  make_dense_steps)
    from repro_torch.data import (build_batch_plan, dirichlet_partition,
                                  pad_shards)
    from repro_torch.fl import (ClientList, client_specs, local_update,
                                local_update_grouped)
    from repro_torch.models import (CNNSpec, client_views, cnn_init,
                                    stack_models)

    on_card = torch.device(dev).type == "cuda"
    clocked = functools.partial(timed, torch, dev)
    specs = client_specs(scfg)
    if len(set(specs)) != 1:
        fail("grouped_check wants a homogeneous federation")
    spec = specs[0]
    x, y = cifar_data(scfg)["train"]
    parts = dirichlet_partition(y, scfg.n_clients, scfg.alpha, seed=scfg.seed)
    shards = [(x[p[:GROUPED_SHARD]], y[p[:GROUPED_SHARD]]) for p in parts]
    seeds = [scfg.seed + i for i in range(scfg.n_clients)]
    init = torch.Generator().manual_seed(scfg.seed)
    inits = [cnn_init(spec, generator=init, device=dev) for _ in shards]
    local = dict(lr=scfg.local_lr, momentum=scfg.local_momentum,
                 num_classes=scfg.num_classes)
    xs, ys = pad_shards(shards)
    plan = build_batch_plan([len(s[1]) for s in shards], scfg.batch_size,
                            epochs=1, seeds=seeds)

    def per_client(start=inits):
        models = [copy.deepcopy(m) for m in start]
        for m, (xi, yi), seed in zip(models, shards, seeds):
            local_update(m, xi, yi, epochs=1, batch_size=scfg.batch_size,
                         seed=seed, **local)
        return models

    def grouped():
        stacked = stack_models(inits)
        local_update_grouped(stacked, spec, xs, ys, plan, **local)
        return stacked

    def peak(fn):
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        out, secs = clocked(fn)
        return out, secs, (_peak_gib(torch) if on_card else None)

    def distance(got, want):
        """max |a - b| / (1 + |b|) over the params and over the running
        statistics of every client, and the tensor where each peaks."""
        worst = {"params": (0.0, None), "bn_stats": (0.0, None)}
        for j, model in enumerate(want):
            for name, b in model.net.state_dict().items():
                e = float(((got[j][name].detach() - b).abs()
                           / (1 + b.abs())).max())
                key = "bn_stats" if name.endswith((".bn.mean", ".bn.var")) \
                    else "params"
                if e > worst[key][0]:
                    worst[key] = (e, f"client{j}.{name}")
        return worst

    # the check runs (the first of each way, warm-ups for the timing)
    models, _, _ = peak(per_client)
    stacked, _, _ = peak(grouped)
    # the floor: the loop from inits moved by one float32 ulp
    sign = torch.Generator().manual_seed(scfg.seed + 4)
    nudged = [copy.deepcopy(m) for m in inits]
    with torch.no_grad():
        for m in nudged:
            for p in m.parameters():
                s = torch.randint(0, 2, p.shape, generator=sign) * 2 - 1
                p.mul_(1 + 2.0 ** -23 * s.to(p.device))
    floor = distance([m.net.state_dict() for m in per_client(nudged)],
                     models)
    rows = lambda st: [{k: v[j] for k, v in st.items()}   # noqa: E731
                       for j in range(len(models))]
    got = distance(rows(stacked), models)

    def planted(p=plan, **kw):
        """The grouped engine run wrong on purpose: a changed plan or
        optimizer."""
        st = stack_models(inits)
        local_update_grouped(st, spec, xs, ys, p, **{**local, **kw})
        return rows(st)

    # engines a limit must catch: what each reads against the loop
    faults = {name: {k: e for k, (e, _) in distance(run, models).items()}
              for name, run in (
        ("left_at_inits", [m.net.state_dict() for m in inits]),
        ("first_step_dropped", planted(dataclasses.replace(
            plan, idx=plan.idx[:, 1:], mask=plan.mask[:, 1:]))),
        ("last_step_dropped", planted(dataclasses.replace(
            plan, idx=plan.idx[:, :-1], mask=plan.mask[:, :-1]))),
        ("momentum_lost", planted(momentum=0.0)),
        ("padding_rows_counted", planted(dataclasses.replace(
            plan, mask=np.ones_like(plan.mask)))))}
    floor_max = max(e for e, _ in floor.values())
    caught = min(max(f.values()) for f in faults.values())
    if not floor_max < GROUPED_TRAIN_TOL < caught:
        fail(f"grouped_check: the limit {GROUPED_TRAIN_TOL} does not lie "
             f"between the one-ulp floor {floor} and the planted faults "
             f"{faults}")
    params_err, params_at = got["params"]
    stats_err, stats_at = got["bn_stats"]
    views = client_views(spec, stacked)
    clients = ClientList([Client(spec=spec, model=v, n_data=len(s[1]))
                          for v, s in zip(views, shards)],
                         [(spec, len(views))], [stacked])
    looped = functools.partial(ensemble_logits, views)
    teacher = grouped_teacher(clients)

    g_init = torch.Generator().manual_seed(scfg.seed + 1)
    gen = img_generator_init(nz=scfg.nz, img_size=scfg.image_size,
                             out_ch=scfg.in_ch, generator=g_init, device=dev)
    noise = torch.Generator(device=dev).manual_seed(scfg.seed + 2)
    z = torch.randn((scfg.synth_batch, scfg.nz), device=dev, generator=noise)
    labels = torch.randint(0, scfg.num_classes, (scfg.synth_batch,),
                           device=dev, generator=noise)
    with torch.no_grad():
        images = gen(z)

    def teacher_step(fn):
        """The teacher's part of a generator step: the ensemble with
        stats, L_CE + L_BN, their gradient with respect to the images."""
        xg = images.clone().requires_grad_(True)
        avg, st = fn(xg, with_bn_stats=True)
        l_bn = bn_loss(st)
        (grad,) = torch.autograd.grad(ce_loss(avg, labels) + l_bn, [xg])
        return avg.detach(), l_bn.detach(), grad

    (ga, gb, gg), (la, lb, lg) = teacher_step(teacher), teacher_step(looped)
    with torch.no_grad():
        folded_err = _rel_max(teacher(images), looped(images))
    errs = {"params": params_err, "bn_stats": stats_err,
            "logits_rel_to_max": _rel_max(ga, la),
            "folded_logits_rel_to_max": folded_err,
            "l_bn_rel": float((gb - lb).abs() / lb.abs()),
            "image_grad_rel_to_max": _rel_max(gg, lg)}
    worst = {"params": params_at, "bn_stats": stats_at}
    limits = {k: GROUPED_TRAIN_TOL if k in ("params", "bn_stats")
              else GROUPED_TOL for k in errs}
    bad = {k: v for k, v in errs.items() if v > limits[k]}
    if bad:
        fail(f"grouped_check: the grouped engine or teacher disagrees with "
             f"the per-client one: {bad} (all: {errs}, at {worst}, "
             f"limits: {limits}, one-ulp floor: {floor})")

    # each way in turns: grouped, per-client, per-client, grouped
    local_s = {"grouped": [], "per_client": []}
    local_peak = {}
    for way in ("grouped", "per_client", "per_client", "grouped"):
        _, secs, gib = peak(grouped if way == "grouped" else per_client)
        local_s[way].append(secs)
        local_peak[way] = gib

    def server(fn):
        stu_init = torch.Generator().manual_seed(scfg.seed + 3)
        student = cnn_init(CNNSpec(kind=scfg.global_kind,
                                   num_classes=scfg.num_classes,
                                   in_ch=scfg.in_ch, width=scfg.width,
                                   image_size=scfg.image_size),
                           generator=stu_init, device=dev)
        g = copy.deepcopy(gen)
        gen_step, student_step = make_dense_steps(clients, scfg, device=dev,
                                                  teacher=fn)
        g_opt = optim.adam(list(g.parameters()), scfg.g_lr)
        s_opt = optim.sgd(list(student.parameters()), scfg.s_lr,
                          momentum=scfg.s_momentum)

        def epoch():
            for _ in range(scfg.t_g):
                gen_step(g, g_opt, student, z, labels)
            return student_step(student, s_opt, g, z)

        return epoch

    epochs = {"grouped": server(teacher), "per_client": server(looped)}
    for way in ("grouped", "per_client"):      # warm-up
        clocked(epochs[way])
    server_s = {"grouped": [], "per_client": []}
    server_peak = {}
    for way in ("grouped", "per_client", "per_client", "grouped"):
        _, secs, gib = peak(epochs[way])
        server_s[way].append(secs)
        server_peak[way] = gib
    teacher_ms, student_teacher_ms = {}, {}
    if on_card:
        for way, fn in (("grouped", teacher), ("per_client", looped),
                        ("per_client", looped), ("grouped", teacher)):
            ms, records = device_ms_total(torch, lambda: teacher_step(fn),
                                          calls=5)
            teacher_ms.setdefault(way, []).append(
                {"device_ms": ms, "kernel_records": records,
                 **device_busy_ms(torch, lambda: teacher_step(fn)),
                 "ms": cuda_ms(torch, lambda: teacher_step(fn), samples=5)})
            with torch.no_grad():
                student_teacher_ms.setdefault(way, []).append(
                    {**device_busy_ms(torch, lambda: fn(images)),
                     "ms": cuda_ms(torch, lambda: fn(images), samples=5)})
    emit({"grouped_check": {
        "clients": scfg.n_clients, "kind": spec.kind, "width": spec.width,
        "batch": scfg.batch_size, "shard_images": [len(s[1]) for s in shards],
        "local_epochs": 1, "steps": plan.steps, "errors": errs,
        "worst": worst, "limits": limits, "floor_one_ulp": floor,
        "planted_faults": faults,
        "local_seconds": local_s, "local_peak_gib": local_peak,
        "server_epoch_seconds": server_s, "server_peak_gib": server_peak,
        "t_g": scfg.t_g, "synth_batch": scfg.synth_batch,
        "teacher_in_gen_step": teacher_ms,
        "teacher_in_student_step": student_teacher_ms}})


# --------------------------------------------------------- paper tables --

PAPER_ROUNDS = 2
# LDAM (s = 30 on raw logits) trains at an effective rate 30x CE's, and
# after one local epoch the clients' BN running statistics still lag
# their weights: on generator images their eval-mode activations grow
# layer by layer until DENSE's L_BN overflows float32 (inf at epoch 0 on
# the card at one local epoch; the reference computes the same). More
# local epochs let the statistics catch up.
LDAM_LOCAL_EPOCHS = 6


def finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def paper_tables(torch, scfg, clients, dev="cuda"):
    """The paper's comparison on the main path's trained clients and cuts:
    the one-shot baselines FedDF, Fed-DAFL and Fed-ADI (Table 1), DENSE
    on a federation trained with LDAM (Table 4) and two rounds of
    multi-round DENSE (Table 5), one JSON line each. Each run's launch
    counts are zeroed just before it and must read, just after:
    epochs·s_steps of each K1 kernel for a baseline (its student steps),
    epochs·(t_g + s_steps) for DENSE+LDAM and rounds times that for
    multi-round, nothing else. Every loss must be finite: the baselines
    and the DENSE driver raise ``FloatingPointError`` on one that is not.
    Returns each run's K1 launches."""
    from repro_torch.configs import CONFIG
    from repro_torch.core import evaluate, train_dense_server
    from repro_torch.fl import (CommLedger, build_federation,
                                dense_multi_round, fed_adi, fed_dafl, fed_df,
                                param_bytes)

    on_card = torch.device(dev).type == "cuda"
    data = cifar_data(scfg)
    xt, yt = data["test"]
    clocked = functools.partial(timed, torch, dev)
    dense_each = scfg.epochs * (scfg.t_g + scfg.s_steps)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches = {}

    def report(name, want, accs, **fields):
        got = read_counts()
        launches[name] = got
        # a CPU run (a rehearsal) takes the plain versions
        if on_card and got != expected(distill_kl_fwd=want,
                                       distill_kl_bwd=want):
            fail(f"paper_tables: {name} launched {got}, expected {want} of "
                 "each K1 kernel and nothing else")
        if not all(0.0 <= a <= 1.0 for a in accs):
            fail(f"paper_tables: {name}: accuracy out of [0, 1]: {accs}")
        emit({"paper_tables": {"run": name, **fields, "launches": got,
                               "expected_launches_each": want}})

    try:
        for name, fn in (("fed_df", fed_df), ("fed_dafl", fed_dafl),
                         ("fed_adi", fed_adi)):
            zero_counts()
            (student, _), secs = clocked(lambda: fn(clients, scfg,
                                                    device=dev))
            acc = evaluate(student, xt, yt)
            report(name, scfg.epochs * scfg.s_steps, [acc], seconds=secs,
                   seconds_per_epoch=secs / scfg.epochs, acc=acc)
            del student

        ldam = dataclasses.replace(scfg, use_ldam=True,
                                   local_epochs=LDAM_LOCAL_EPOCHS)
        zero_counts()
        (ldam_clients, _), t_fed = clocked(lambda: build_federation(
            ldam, data, device=dev, seed=scfg.seed))
        (student, _, hist), t_dense = clocked(lambda: train_dense_server(
            ldam_clients, ldam, device=dev))
        if not finite(hist.gen_loss + hist.dis_loss):
            fail(f"paper_tables: DENSE+LDAM losses are not finite: {hist}")
        accs = [evaluate(c.model, xt, yt) for c in ldam_clients]
        acc = evaluate(student, xt, yt)
        report("dense_ldam", dense_each, accs + [acc],
               seconds={"build_federation": t_fed,
                        "train_dense_server": t_dense},
               seconds_per_epoch=t_dense / scfg.epochs,
               acc={"clients": accs, "dense": acc},
               gen_loss=hist.gen_loss, dis_loss=hist.dis_loss,
               gen_parts=hist.gen_parts)
        del ldam_clients, student, hist

        ledger = CommLedger()
        zero_counts()
        (model, _, accs), secs = clocked(lambda: dense_multi_round(
            scfg, data, rounds=PAPER_ROUNDS, ledger=ledger, seed=scfg.seed,
            device=dev, eval_fn=lambda m, spec: evaluate(m, xt, yt)))
    except FloatingPointError as e:
        fail(f"paper_tables: {e}")
    down = scfg.n_clients * param_bytes(model)
    if ledger.rounds != PAPER_ROUNDS or ledger.downlink_bytes != down:
        fail(f"paper_tables: multi-round ledger has {ledger.rounds} rounds "
             f"and {ledger.downlink_bytes} B down, expected {PAPER_ROUNDS} "
             f"and {down}")
    report("multi_round", PAPER_ROUNDS * dense_each, accs,
           rounds=ledger.rounds, seconds=secs,
           seconds_per_round=secs / PAPER_ROUNDS, acc_after_round=accs,
           uplink_bytes=ledger.uplink_bytes,
           downlink_bytes=ledger.downlink_bytes)
    emit({"paper_tables": {
        "seconds_total": time.perf_counter() - t0,
        "peak_mem_gib": _peak_gib(torch) if on_card else None,
        "cuts": {"local_epochs": [CONFIG.local_epochs, scfg.local_epochs],
                 "ldam_local_epochs": [CONFIG.local_epochs,
                                       LDAM_LOCAL_EPOCHS],
                 "epochs": [CONFIG.epochs, scfg.epochs],
                 "rounds": PAPER_ROUNDS,
                 "kept": "main_path's clients, widths, batch, synth_batch, "
                         "nz and t_g"}}})
    return {name: {k: r[k] for k in ("distill_kl_fwd", "distill_kl_bwd")}
            for name, r in launches.items()}


# ---------------------------------------------------------- fault round --

FAULT_EPOCHS = 3
FAULT_POISON = (1,)
# the server runs' generator steps an epoch, cut from the main path's 30
# to 10 (the five runs took 48–73 s at 30 on an H100; what they hold,
# skip, rollback and resume, does not depend on it)
FAULT_T_G_CUT = (30, 10)
# the masked teacher against one stacked from the survivors alone: the
# same rows in the same layout, so the same convolutions (1e-6 of the
# largest logit)
FAULT_TEACHER_TOL = 1e-6
# the skip guard's cost: this many steps a turn, in this many turns with
# the guard and as many without, alternating
FAULT_GUARD_STEPS = 20
FAULT_GUARD_TURNS = 4


@contextlib.contextmanager
def deterministic(torch):
    """cuDNN's deterministic algorithms and PyTorch's, warning (not
    raising) where an operation has none, for the runs that are held to
    each other; the flags as they were afterwards. Yields the list the
    warnings' messages go to."""
    import warnings

    flags = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    seen: list = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
        seen.extend(sorted({str(w.message)[:200] for w in caught}))
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.use_deterministic_algorithms(flags[1], warn_only=flags[2])


def _max_diff(torch, a: list, b: list) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b, strict=True))


def _server_tensors(student, gen) -> list:
    return [v.detach().clone() for m in (student, gen)
            for v in m.state_dict().values()]


def fault_round(torch, scfg, clients, dev="cuda"):
    """The fault-tolerant one-shot round on the main path's five trained
    clients (no second local phase), through the entry points: upload
    faults (``fl.faults.apply_upload_faults``), admission
    (``fl.protocol.admit_uploads``), the masked teacher and FedAvg, and
    ``train_dense_server`` under ``nan_policy`` skip and rollback with a
    poisoned epoch and server checkpoints (module docstring, phase 9).
    Fails unless (a)-(d) hold. Returns each DENSE run's K1 launches."""
    import tempfile

    from repro_torch.core import (grouped_teacher, img_generator_init,
                                  make_dense_steps, train_dense_server)
    from repro_torch.fl import (CommLedger, QuorumError, UploadError,
                                admit_uploads, apply_upload_faults,
                                build_fault_plan, fedavg, param_bytes)
    from repro_torch.fl.faults import fault_seed
    from repro_torch.models import CNNSpec, cnn_init
    from repro_torch import optim

    on_card = torch.device(dev).type == "cuda"
    tag = "round0-model-upload"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    out = {}

    def boundary(fscfg, ledger=None):
        plan = build_fault_plan(fscfg)
        return apply_upload_faults(clients, plan,
                                   seed=fault_seed(fscfg, 0), ledger=ledger,
                                   upload_tag=tag)

    # (a) a NaN upload and a dropped one, quarantined
    qscfg = dataclasses.replace(scfg, fault_plan=((1, "nan"), (3, "drop")))
    ledger = CommLedger()
    (faulted, arrived, _), t_faults = timed(
        torch, dev, lambda: boundary(qscfg, ledger))
    admitted, t_admit = timed(torch, dev, lambda: admit_uploads(
        faulted, arrived=arrived, scfg=qscfg, ledger=ledger,
        upload_tag=tag))
    kinds = {k: len(ledger.kinds(k)) for k in ("delivered", "dropped",
                                               "delayed", "rejected")}
    one = param_bytes(clients[0].model)
    if admitted.survivor_mask.tolist() != [True, False, True, False, True] \
            or set(admitted.quarantined) != {1, 3}:
        fail(f"fault_round (a): quarantined {admitted.quarantined}, "
             "expected clients 1 (nan) and 3 (drop)")
    if kinds != {"delivered": 4, "dropped": 1, "delayed": 0,
                 "rejected": 1} or ledger.uplink_bytes != 4 * one:
        fail(f"fault_round (a): ledger {kinds}, {ledger.uplink_bytes} B up, "
             f"expected 4 delivered, 1 dropped, 1 rejected and {4 * one} B")
    out["quarantine"] = {
        "quarantined": {str(k): v for k, v in admitted.quarantined.items()},
        "ledger_kinds": kinds, "uplink_bytes": ledger.uplink_bytes,
        "client_bytes": one, "seconds": {"faults": t_faults,
                                         "admission": t_admit}}

    # (b) a sign flip: the direction screen, strict and the quorum
    bscfg = dataclasses.replace(scfg, fault_plan=((2, "signflip"),),
                                cos_screen=0.0)
    flipped, arrived_b, _ = boundary(bscfg)
    screened, t_screen = timed(torch, dev, lambda: admit_uploads(
        flipped, arrived=arrived_b, scfg=bscfg))
    if set(screened.quarantined) != {2} or \
            "direction outlier" not in screened.quarantined[2]:
        fail(f"fault_round (b): the cosine screen quarantined "
             f"{screened.quarantined}, expected client 2's sign flip")
    raised = {}
    for name, kw, err in (("strict", {"upload_policy": "strict"},
                           UploadError),
                          ("quorum_0.9", {"quorum": 0.9}, QuorumError)):
        try:
            admit_uploads(flipped, arrived=arrived_b, scfg=bscfg, **kw)
        except err as e:
            raised[name] = f"{type(e).__name__}: {e}"[:160]
        else:
            fail(f"fault_round (b): {name} admitted the sign flip")
    out["direction_screen"] = {"quarantined": screened.quarantined[2],
                               "raised": raised, "seconds": t_screen}
    del flipped, screened

    # (c) the masked teacher and FedAvg over the survivors
    init = torch.Generator().manual_seed(11)
    gen = img_generator_init(nz=scfg.nz, img_size=scfg.image_size,
                             out_ch=scfg.in_ch, generator=init, device=dev)
    z = torch.randn((scfg.synth_batch, scfg.nz), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(12))
    with torch.no_grad():
        x = gen(z)
        masked = grouped_teacher(admitted)(x)
        alone = grouped_teacher([clients[i] for i in (0, 2, 4)])(x)
    err = float((masked - alone).abs().max() / alone.abs().max())
    if not err <= FAULT_TEACHER_TOL:
        fail(f"fault_round (c): the masked teacher is {err} of its largest "
             f"logit off the survivors' own, limit {FAULT_TEACHER_TOL}")
    avg, t_avg = timed(torch, dev, lambda: fedavg(admitted))
    if not all(bool(torch.isfinite(v).all())
               for v in avg.state_dict().values()):
        fail("fault_round (c): fedavg over the survivors is not finite")
    out["masked_consumers"] = {"teacher_rel_err": err,
                               "teacher_tol": FAULT_TEACHER_TOL,
                               "fedavg_seconds": t_avg}
    del avg, masked, alone, x, gen

    # (d) skip, rollback, checkpoints and resume, on the admitted clients
    each = FAULT_T_G_CUT[1] + scfg.s_steps
    # epoch-granular rollback and resume: the python driver (fused_check
    # holds the fused driver's chunk-granular ones)
    base = dataclasses.replace(scfg, epochs=FAULT_EPOCHS,
                               loop_mode="python", t_g=FAULT_T_G_CUT[1])
    runs, launches, losses = {}, {}, {}
    work = os.path.join(ROOT, "build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        def run(name, policy, ckpt=None, stop=0):
            fscfg = dataclasses.replace(
                base, nan_policy=policy, checkpoint_every=1 if ckpt else 0,
                checkpoint_path=os.path.join(tmp, ckpt) if ckpt else "")
            zero_counts()
            (student, gen, hist), secs = timed(
                torch, dev, lambda: train_dense_server(
                    admitted, fscfg, device=dev,
                    _poison_epochs=FAULT_POISON, _stop_after_epoch=stop))
            got = read_counts()
            n = len(hist.gen_loss)
            launches[name] = {k: got[k] for k in ("distill_kl_fwd",
                                                  "distill_kl_bwd")}
            if on_card and got != expected(distill_kl_fwd=n * each,
                                           distill_kl_bwd=n * each):
                fail(f"fault_round (d): {name} launched {got} over {n} "
                     f"epochs, expected {n * each} of each K1 kernel")
            losses[name] = {"gen_loss": hist.gen_loss,
                            "dis_loss": hist.dis_loss,
                            "seconds": secs, "seconds_per_epoch": secs / n}
            runs[name] = _server_tensors(student, gen)

        with deterministic(torch) as nondeterministic:
            run("skip", "skip", ckpt="uninterrupted")
            run("rollback", "rollback")
            run("stopped", "skip", ckpt="killed", stop=2)
            run("resumed", "skip", ckpt="killed")
            run("skip_again", "skip")
    # epochs 0 and 2 finite and the poisoned epoch 1 not; the resumed run
    # goes on from epoch 1
    for name, first in (("skip", 0), ("rollback", 0), ("skip_again", 0),
                        ("resumed", 1)):
        gl, dl = losses[name]["gen_loss"], losses[name]["dis_loss"]
        good = [e - first for e in (0, 2) if e >= first]
        if len(gl) != FAULT_EPOCHS - first \
                or not finite([gl[i] for i in good] + [dl[i] for i in good]) \
                or finite([gl[1 - first]]) or finite([dl[1 - first]]):
            fail(f"fault_round (d): {name}'s losses {gl}, {dl} over epochs "
                 f"{first}-{FAULT_EPOCHS - 1}: epochs 0 and 2 must be "
                 "finite, the poisoned epoch 1 not")
    for name, tensors in runs.items():
        if not all(bool(torch.isfinite(t).all()) for t in tensors):
            fail(f"fault_round (d): {name}'s student or generator is not "
                 "finite")
    spread = _max_diff(torch, runs["skip"], runs["skip_again"])
    resume = _max_diff(torch, runs["skip"], runs["resumed"])
    rollback = _max_diff(torch, runs["skip"], runs["rollback"])
    if not (resume <= spread and rollback <= spread):
        fail(f"fault_round (d): resumed run {resume} and rollback {rollback}"
             f" from the uninterrupted skip run, beyond the spread of two "
             f"uninterrupted runs, {spread}")
    out["server"] = {"epochs": FAULT_EPOCHS, "poisoned": list(FAULT_POISON),
                     "cuts": {"t_g": [scfg.t_g, base.t_g]},
                     "runs": losses, "spread_two_uninterrupted": spread,
                     "resumed_vs_uninterrupted": resume,
                     "rollback_vs_skip": rollback,
                     "deterministic": {"cudnn": True, "algorithms": True,
                                       "warned": nondeterministic},
                     "main_path_seconds_per_epoch":
                         MAIN_PATH_SECONDS.get("dense_per_epoch")}
    del runs

    # the guard's cost: the same steps with the guard on and off, in turns
    spec = CNNSpec(kind=scfg.global_kind, num_classes=scfg.num_classes,
                   in_ch=scfg.in_ch, width=scfg.width,
                   image_size=scfg.image_size)
    teacher = grouped_teacher(admitted)
    y = torch.randint(0, scfg.num_classes, (scfg.synth_batch,), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(13))
    per_step = {}
    for guard in (False, True) * FAULT_GUARD_TURNS:
        gen = img_generator_init(nz=scfg.nz, img_size=scfg.image_size,
                                 out_ch=scfg.in_ch,
                                 generator=torch.Generator().manual_seed(14),
                                 device=dev)
        student = cnn_init(spec, generator=torch.Generator().manual_seed(15),
                           device=dev)
        gen_step, student_step = make_dense_steps(
            admitted, scfg, device=dev, teacher=teacher, nan_guard=guard)
        g_opt = optim.adam(list(gen.parameters()), scfg.g_lr)
        s_opt = optim.sgd(list(student.parameters()), scfg.s_lr,
                          momentum=scfg.s_momentum)
        gen_step(gen, g_opt, student, z, y)            # warm-up
        student_step(student, s_opt, gen, z)
        _, t_g = timed(torch, dev, lambda: [
            gen_step(gen, g_opt, student, z, y)
            for _ in range(FAULT_GUARD_STEPS)])
        _, t_s = timed(torch, dev, lambda: [
            student_step(student, s_opt, gen, z)
            for _ in range(FAULT_GUARD_STEPS)])
        key = "guarded" if guard else "unguarded"
        per_step.setdefault(key, []).append(
            {"gen_step_ms": t_g / FAULT_GUARD_STEPS * 1e3,
             "student_step_ms": t_s / FAULT_GUARD_STEPS * 1e3})
    cost = {"per_step": per_step, "steps_each": FAULT_GUARD_STEPS,
            "turns_each": FAULT_GUARD_TURNS}
    for step in ("gen_step_ms", "student_step_ms"):
        turns = {k: [t[step] for t in v] for k, v in per_step.items()}
        diff = statistics.median(turns["guarded"]) \
            - statistics.median(turns["unguarded"])
        # the cost is resolved only where it exceeds how far the turns of
        # one kind spread
        spread = max(max(v) - min(v) for v in turns.values())
        cost[step] = {"guarded_minus_unguarded": diff,
                      "spread_between_turns": spread,
                      "resolved": abs(diff) > spread}
    out["guard_cost"] = cost
    out["seconds_total"] = time.perf_counter() - t_phase
    out["peak_mem_gib"] = _peak_gib(torch) if on_card else None
    emit({"fault_round": out})
    return launches


# ----------------------------------------------------------- fused check --

FUSED_EPOCHS = 3
FUSED_CHUNK = 2
# the generator steps an epoch, cut from the main path's 30 to 10: the
# phase's eight runs of 1–3 epochs took 78–82 s at 30 on an H100, which
# the whole script's 1200 s cannot spare; capture and replay are the same
FUSED_T_G_CUT = (30, 10)
FUSED_POISON = (1,)
FUSED_CKPT_EVERY = 2
# what fused_check holds where a pair of runs is not bit for bit: each
# tensor's and each loss's largest difference over its largest entry
FUSED_TOL = 1e-5


def _rel_diff(torch, a: list, b: list) -> float:
    """The largest, over tensor pairs, of max |a − b| / max |b|."""
    return max(float((x.float() - y.float()).abs().max()
                     / y.float().abs().max().clamp(min=1e-30))
               for x, y in zip(a, b, strict=True))


def _hist_values(hist) -> list:
    return [*hist.gen_loss, *hist.dis_loss,
            *(v for p in hist.gen_parts for v in p.values())]


def _epochs_of(hist, epochs):
    """The losses of some epochs of a history, as a history."""
    import types

    return types.SimpleNamespace(
        gen_loss=[hist.gen_loss[e] for e in epochs],
        dis_loss=[hist.dis_loss[e] for e in epochs],
        gen_parts=[hist.gen_parts[e] for e in epochs])


def fused_check(torch, scfg, clients, dev="cuda"):
    """The fused epoch driver against the python driver on the main
    path's five trained resnet18 clients, float32 without TF32, under
    cuDNN's and PyTorch's deterministic algorithms, from the same
    generator and student inits (each run from a copy) and latents, at
    t_g 10 (``FUSED_T_G_CUT``):

      (a) 3 epochs in chunks of 2 (bounds [0, 2), [2, 3): an eager
          warm-up epoch, then two replays of the captured epoch) with a
          checkpoint every 2 epochs, against the python driver: the
          student, the generator and every loss;
      (b) a restart of that run from its epoch-2 checkpoint (as a run
          killed after epoch 3, before any later save, restarts) ends
          where it ended;
      (c) ``rollback`` with epoch 1's latents NaN: the chunk [0, 2) is
          undone whole (a run stopped after it holds the initial state)
          and epoch 2 goes on from it (a python run over epoch 2's
          latents alone ends there);
      (d) ``skip`` with epoch 1 poisoned ends where a python skip run
          over epochs 0 and 2's latents ends;
      (e) each run launches K1f and K1b epochs·(t_g + s_steps) times
          (capture launches nothing, each replay counts what it ran) and
          the fused runs read their losses once a chunk.

    Each pair is held bit for bit; where one is not, its largest
    difference over each tensor's largest entry is reported and held to
    1e-5 instead (``FUSED_TOL``). Returns each run's K1 launches."""
    import copy
    import tempfile

    from repro_torch.core import img_generator_init, train_dense_server
    from repro_torch.core.dense import _chunk_bounds
    from repro_torch.models import CNNSpec, cnn_init

    on_card = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    each = FUSED_T_G_CUT[1] + scfg.s_steps
    base = dataclasses.replace(scfg, epochs=FUSED_EPOCHS,
                               loop_chunk=FUSED_CHUNK, t_g=FUSED_T_G_CUT[1])
    spec = CNNSpec(kind=scfg.global_kind, num_classes=scfg.num_classes,
                   in_ch=scfg.in_ch, width=scfg.width,
                   image_size=scfg.image_size)
    gen0 = img_generator_init(nz=scfg.nz, img_size=scfg.image_size,
                              out_ch=scfg.in_ch,
                              generator=torch.Generator().manual_seed(21),
                              device=dev)
    stu0 = cnn_init(spec, generator=torch.Generator().manual_seed(22),
                    device=dev)
    draws_src = torch.Generator(device=dev).manual_seed(23)
    b, nz = scfg.synth_batch, scfg.nz
    draws = [(torch.randn((b, nz), generator=draws_src, device=dev),
              torch.randint(0, scfg.num_classes, (b,), generator=draws_src,
                            device=dev),
              torch.zeros((0, b, nz), device=dev))
             for _ in range(FUSED_EPOCHS)]
    runs, launches = {}, {}

    def run(name, loop, epochs=FUSED_EPOCHS, **kw):
        fscfg = dataclasses.replace(
            base, loop_mode=loop, epochs=epochs,
            **{k: kw.pop(k) for k in ("nan_policy", "checkpoint_every",
                                      "checkpoint_path") if k in kw})
        zero_counts()
        (student, gen, hist), secs = timed(
            torch, dev, lambda: train_dense_server(
                clients, fscfg, device=dev, gen=copy.deepcopy(gen0),
                student=copy.deepcopy(stu0), **kw))
        got = read_counts()
        n = len(hist.gen_loss)
        launches[name] = {k: got[k] for k in ("distill_kl_fwd",
                                              "distill_kl_bwd")}
        if on_card and got != expected(distill_kl_fwd=n * each,
                                       distill_kl_bwd=n * each):
            fail(f"fused_check: {name} launched {got} over {n} epochs, "
                 f"expected {n * each} of each K1 kernel")
        if loop == "fused":
            stop = kw.get("_stop_after_epoch", 0)
            chunks = [c for c in _chunk_bounds(
                epochs, FUSED_CHUNK, 0, fscfg.checkpoint_every
                if fscfg.checkpoint_path else 0, 0 if stop else epochs - n)
                if not stop or c[0] < stop]
            if hist.host_reads != len(chunks) or (
                    on_card and hist.graph_replays != max(n - 1, 0)):
                fail(f"fused_check: {name} read its losses "
                     f"{hist.host_reads} times over chunks {chunks} and "
                     f"replayed {hist.graph_replays} times over {n} "
                     "epochs")
        runs[name] = {"tensors": _server_tensors(student, gen),
                      "hist": hist, "seconds": secs}
        return runs[name]

    def same(a, b) -> dict:
        exact = all(torch.equal(x, y) for x, y in
                    zip(a["tensors"], b["tensors"], strict=True))
        ha, hb = _hist_values(a["hist"]), _hist_values(b["hist"])
        losses_exact = ha == hb
        diff = {"bit_for_bit": exact and losses_exact,
                "max_rel_diff": 0.0 if exact else _rel_diff(
                    torch, a["tensors"], b["tensors"]),
                "loss_max_rel_diff": 0.0 if losses_exact else max(
                    abs(x - y) / max(abs(y), 1e-30) for x, y in zip(
                        ha, hb, strict=True) if finite([x, y]))}
        if not (diff["bit_for_bit"] or (diff["max_rel_diff"] <= FUSED_TOL
                                        and diff["loss_max_rel_diff"]
                                        <= FUSED_TOL)):
            diff["failed"] = True
        return diff

    out = {}
    work = os.path.join(ROOT, "build")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp, \
            deterministic(torch) as nondeterministic:
        ckpt = os.path.join(tmp, "fused")
        run("fused", "fused", checkpoint_every=FUSED_CKPT_EVERY,
            checkpoint_path=ckpt)
        run("python", "python")
        out["fused_vs_python"] = same(runs["fused"], runs["python"])
        run("resumed", "fused", checkpoint_every=FUSED_CKPT_EVERY,
            checkpoint_path=ckpt)
        out["resumed_vs_uninterrupted"] = same(
            runs["resumed"], {**runs["fused"], "hist": _epochs_of(
                runs["fused"]["hist"], range(FUSED_CKPT_EVERY,
                                             FUSED_EPOCHS))})
        out["resumed_epochs"] = len(runs["resumed"]["hist"].gen_loss)

        run("rollback_chunk", "fused", nan_policy="rollback",
            noise=draws.__getitem__, _poison_epochs=FUSED_POISON,
            _stop_after_epoch=FUSED_CHUNK)
        init = {"tensors": _server_tensors(stu0, gen0),
                "hist": runs["rollback_chunk"]["hist"]}
        out["rolled_back_vs_initial"] = same(runs["rollback_chunk"], init)
        run("rollback", "fused", nan_policy="rollback",
            noise=draws.__getitem__, _poison_epochs=FUSED_POISON)
        run("epoch2_alone", "python", epochs=1, nan_policy="rollback",
            noise=lambda e: draws[FUSED_CHUNK])
        out["rollback_vs_epoch2_alone"] = same(
            {**runs["rollback"],
             "hist": _epochs_of(runs["rollback"]["hist"], (2,))},
            runs["epoch2_alone"])
        run("skip", "fused", nan_policy="skip", noise=draws.__getitem__,
            _poison_epochs=FUSED_POISON)
        run("skip_unpoisoned", "python", epochs=2, nan_policy="skip",
            noise=lambda e: draws[2 * e])
        out["skip_vs_unpoisoned"] = same(
            {**runs["skip"], "hist": _epochs_of(runs["skip"]["hist"],
                                                (0, 2))},
            runs["skip_unpoisoned"])
    rb = runs["rollback"]["hist"]
    if len(rb.gen_loss) != FUSED_EPOCHS or finite([rb.gen_loss[1]]) or \
            not finite([rb.gen_loss[0], rb.gen_loss[2]]):
        fail(f"fused_check: rollback's history {rb.gen_loss} must keep "
             "all 3 epochs, the poisoned epoch 1 not finite")
    bad = {k: v for k, v in out.items()
           if isinstance(v, dict) and v.get("failed")}
    if bad or out["resumed_epochs"] != FUSED_EPOCHS - FUSED_CKPT_EVERY:
        fail(f"fused_check: {bad or out}")
    out.update(
        epochs=FUSED_EPOCHS, loop_chunk=FUSED_CHUNK,
        cuts={"t_g": [scfg.t_g, base.t_g]},
        poisoned=list(FUSED_POISON), tol_if_not_bit_for_bit=FUSED_TOL,
        launches=launches,
        runs={k: {"seconds": v["seconds"],
                  "seconds_per_epoch": v["seconds"]
                  / max(len(v["hist"].gen_loss), 1),
                  "host_reads": v["hist"].host_reads,
                  "graph_replays": v["hist"].graph_replays,
                  "capture_seconds": v["hist"].capture_seconds,
                  "gen_loss": v["hist"].gen_loss}
              for k, v in runs.items()},
        deterministic={"cudnn": True, "algorithms": True,
                       "warned": nondeterministic},
        seconds_total=time.perf_counter() - t_phase)
    emit({"fused_check": out})
    return launches


# ------------------------------------------------------------ mesh round --

def mesh_round(torch, scfg, dev="cuda"):
    """The one-shot round on the client mesh (``ensemble_shard_mode=
    "clients"``, a one-rank NCCL world over the card) against the same
    round unsharded, at paper_cifar's five resnet18 clients, with
    fused_check's cuts (3 server epochs in chunks of 2, t_g 10), float32
    without TF32 and under cuDNN's and PyTorch's deterministic
    algorithms: the federation (the grouped engine, sharded), FedAvg
    (the config's flat sum, and the tree sharded over the mesh) and both
    DENSE stages on the fused driver, whose captured epoch holds the
    teacher's all-reduces. On one rank every collective is a copy, so the
    uploads, both averages, the generator, the student and every loss
    must be equal bit for bit. Each run launches K1f and K1b
    epochs·(t_g + s_steps) times and replays its graph epochs − 1 times.
    Returns each run's K1 launches."""
    from repro_torch.configs import CONFIG, resolve_exec_policy
    from repro_torch.core import train_dense_server
    from repro_torch.fl import CommLedger, build_federation, fedavg
    from repro_torch.fl.sharding import resolve_mesh
    from repro_torch.launch.mesh import axis_sizes

    on_card = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    data = cifar_data(scfg)
    base = dataclasses.replace(scfg, epochs=FUSED_EPOCHS,
                               loop_chunk=FUSED_CHUNK, t_g=FUSED_T_G_CUT[1])
    each = base.t_g + base.s_steps
    runs, launches = {}, {}

    def params(models) -> list:
        return [v.detach().clone() for m in models
                for v in m.state_dict().values()]

    with deterministic(torch) as nondeterministic:
        for mode in ("none", "clients"):
            mcfg = dataclasses.replace(base, ensemble_shard_mode=mode)
            pol = resolve_exec_policy(mcfg, device=dev)
            mesh = resolve_mesh(pol, device=dev)
            if (mesh is None) != (mode == "none"):
                fail(f"mesh_round: mode {mode!r} resolved the mesh {mesh}")
            ledger = CommLedger()
            zero_counts()
            (clients, _), t_fed = timed(torch, dev, lambda: build_federation(
                mcfg, data, device=dev, ledger=ledger, seed=mcfg.seed))
            avg, t_avg = timed(torch, dev, lambda: fedavg(
                clients, policy=pol, mesh=mesh))
            tree = fedavg(clients, policy=dataclasses.replace(
                pol, fedavg="tree"), mesh=mesh)
            (student, gen, hist), t_dense = timed(
                torch, dev, lambda: train_dense_server(clients, mcfg,
                                                       device=dev))
            got = read_counts()
            n = len(hist.gen_loss)
            launches[mode] = {k: got[k] for k in ("distill_kl_fwd",
                                                  "distill_kl_bwd")}
            if on_card and got != expected(distill_kl_fwd=n * each,
                                           distill_kl_bwd=n * each):
                fail(f"mesh_round: {mode} launched {got} over {n} epochs, "
                     f"expected {n * each} of each K1 kernel")
            if on_card and (hist.loop != "fused"
                            or hist.graph_replays != n - 1):
                fail(f"mesh_round: {mode} ran the {hist.loop!r} driver "
                     f"with {hist.graph_replays} replays over {n} epochs")
            runs[mode] = {
                "uploads": params(c.model for c in clients),
                "fedavg": params([avg]), "fedavg_tree": params([tree]),
                "server": _server_tensors(student, gen),
                "losses": _hist_values(hist), "gen_loss": hist.gen_loss,
                "uplink_bytes": ledger.uplink_bytes,
                "mesh": None if mesh is None else axis_sizes(mesh),
                "seconds": {"build_federation": t_fed, "fedavg": t_avg,
                            "train_dense_server": t_dense,
                            "per_epoch": t_dense / max(n, 1)},
                "graph_replays": hist.graph_replays,
                "capture_seconds": hist.capture_seconds,
                "host_reads": hist.host_reads}
            del clients, avg, tree, student, gen
    a, b = runs["clients"], runs["none"]
    same = {k: all(torch.equal(x, y) for x, y in zip(a[k], b[k],
                                                    strict=True))
            for k in ("uploads", "fedavg", "fedavg_tree", "server")}
    same["losses"] = a["losses"] == b["losses"]
    diff = {k: 0.0 if v else _rel_diff(torch, a[k], b[k])
            for k, v in same.items() if k != "losses"}
    for r in runs.values():
        for k in ("uploads", "fedavg", "fedavg_tree", "server"):
            del r[k]
        del r["losses"]
    emit({"mesh_round": {
        "card": card(), "bit_for_bit": same, "max_rel_diff": diff,
        "epochs": FUSED_EPOCHS, "loop_chunk": FUSED_CHUNK,
        "cuts": {"t_g": [scfg.t_g, base.t_g],
                 "epochs": [CONFIG.epochs, FUSED_EPOCHS]},
        "launches": launches, "runs": runs,
        "deterministic": {"cudnn": True, "algorithms": True,
                          "warned": nondeterministic},
        "seconds_total": time.perf_counter() - t_phase}})
    if not all(same.values()) or a["uplink_bytes"] != b["uplink_bytes"]:
        fail(f"mesh_round: the sharded round is not the unsharded one bit "
             f"for bit: {same}, {diff}")
    return launches


# ----------------------------------------------------------- scale round --

# the server's t_g, 30 in paper_cifar, cut to 5: at 30 an m = 1000
# epoch takes ~59 s on an H100 (2 s a generator step) and the phase
# 170 s, which the whole script's 1200 s cannot spare (PERF.md, section 6)
SCALE_T_G_CUT = (30, 5)
# the federation DESIGN.md §13's scaling layers are for: m = 1000 cnn1
# clients at paper_cifar's widths on CIFAR-10's count of training images,
# Dirichlet α 0.1, with the knobs the reference's scaling table sets
SCALE = dict(n_clients=1000, client_kinds=("cnn1",), global_kind="cnn1",
             width=1.0, image_size=32, in_ch=3, num_classes=10,
             train_per_class=5000, test_per_class=100, alpha=0.1,
             local_epochs=1, batch_size=64, synth_batch=128, nz=100,
             t_g=SCALE_T_G_CUT[1], epochs=2, plan_bucketing="quantile",
             stack_chunk=64, fedavg_mode="tree", fedavg_branch=8,
             teacher_chunk=64)
SCALE_TEACHER_M = 200          # the unchunked teacher still fits there
# the chunked teacher against the unchunked one: logits, each BN
# statistic and the image gradient to 1e-5 of each one's largest entry,
# without cuDNN (PyTorch's own float32 convolutions: the two differ by
# summation order alone). With cuDNN, the path that runs, logits and
# statistics to 1e-5 too; but cuDNN's float32 image gradient at these
# shapes lies ~1e-3–1e-2 of its largest entry from the one without
# cuDNN, chunked or not (an H100 at 700 W: PERF.md, section 6, and
# scripts/teacher_grad_cudnn.py), so there the chunked
# gradient is held to no more than twice the unchunked one's distance
# from it, plus 1e-5
SCALE_TEACHER_TOL = 1e-5
SCALE_TEACHER_READINGS = ("logits", "l0.mean", "l0.var", "l1.mean",
                          "l1.var", "l2.mean", "l2.var", "image_grad")
SCALE_FEDAVG_TOL = 1e-6
SCALE_WASTE_CUT = 3.0          # the reference's pinned claim


@contextlib.contextmanager
def without_cudnn(torch):
    """PyTorch's own convolutions in place of cuDNN's, the flag as it was
    afterwards (``torch.backends.cudnn.flags`` refuses the TF32 flags
    ``full_float32`` sets)."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


def _teacher_readings(torch, gspecs, gparams, x, y, chunk):
    """One generator step's teacher work: logits with BN statistics,
    L_CE + L_BN and its gradient with respect to the images; each BN
    statistic concatenated over the clients, and the peak memory."""
    from repro_torch.core import bn_loss, ce_loss, grouped_ensemble_logits

    on_card = x.is_cuda
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    xg = x.clone().requires_grad_(True)
    avg, st = grouped_ensemble_logits(gspecs, gparams, xg,
                                      with_bn_stats=True, chunk=chunk)
    (grad,) = torch.autograd.grad(ce_loss(avg, y) + bn_loss(st), [xg])
    stats = [torch.cat([p[1][layer][key] for p in st.parts])
             for layer in range(len(st.parts[0][1]))
             for key in ("mean", "var")]
    peak = None
    if on_card:
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    return [avg.detach(), *(t.detach() for t in stats), grad], peak


def scale_round(torch, dev="cuda"):
    """The one-shot round at m = 1000 (``SCALE``) with the scaling layers
    on, through the entry points: ``build_federation`` (quantile buckets,
    64-client slices), ``fedavg`` (the tree, fan-in 8) and
    ``train_dense_server`` (the teacher streamed in 64-client chunks, the
    fused driver). Fails unless the bucketed, chunked local phase equals
    the single-plan engine per client (``GROUPED_TRAIN_TOL``); the
    padded-step waste falls at least 3x from ``off`` to ``quantile``;
    tree FedAvg equals flat within 1e-6 of each tensor's largest entry;
    the chunked teacher's logits and BN statistics equal the unchunked
    ones within 1e-5 of each one's largest entry at m = 200
    (``SCALE_TEACHER_M``), where the unchunked teacher fits, the image
    gradient too without cuDNN, and with cuDNN lies no further from the
    one without than twice the unchunked one's (``SCALE_TEACHER_TOL``'s
    comment says why); the
    uplink is m uploads in one round; K1 launches epochs·(t_g + s_steps)
    times each; and every loss is finite. A cnn1 + cnn2 federation (two
    groups of 500) runs the local phase too."""
    import numpy as np

    from repro_torch.configs import CONFIG, resolve_exec_policy
    from repro_torch.core import (evaluate, img_generator_init,
                                  stack_grouped, train_dense_server)
    from repro_torch.data import dirichlet_partition, plan_step_waste
    from repro_torch.fl import CommLedger, build_federation, fedavg

    on_card = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    scfg = dataclasses.replace(CONFIG, **SCALE)
    pol = resolve_exec_policy(scfg, device=dev)
    m = scfg.n_clients
    clocked = functools.partial(timed, torch, dev)
    out = {"cuts": {"depth": f"{scfg.local_epochs} local epoch, "
                             f"{scfg.epochs} server epochs of t_g "
                             f"{scfg.t_g}",
                    "t_g": list(SCALE_T_G_CUT),
                    "kept": {k: v if not isinstance(v, tuple) else list(v)
                             for k, v in SCALE.items()}}}
    data, t_data = clocked(lambda: cifar_data(scfg))
    _, y_train = data["train"]
    sizes = [len(p) for p in dirichlet_partition(
        y_train, m, scfg.alpha, seed=scfg.seed)]
    waste = {mode: plan_step_waste(sizes, scfg.batch_size, mode)
             for mode in ("off", "pow2", "quantile")}
    if not waste["quantile"] * SCALE_WASTE_CUT <= waste["off"]:
        fail(f"scale_round: padded-step waste {waste}: quantile buckets "
             f"must cut it {SCALE_WASTE_CUT}x")
    out["plan_step_waste"] = {**waste,
                              "off_over_quantile": waste["off"]
                              / max(waste["quantile"], 1e-30)}
    out["shards"] = {"min": min(sizes), "max": max(sizes),
                     "median": float(np.median(sizes))}

    def peak():
        return _peak_gib(torch) if on_card else None

    # the local phase: bucketed and chunked, then the single-plan engine
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ledger = CommLedger()
    (clients, _), t_fed = clocked(lambda: build_federation(
        scfg, data, device=dev, ledger=ledger, seed=scfg.seed))
    fed_peak = peak()
    ups = ledger.kinds("delivered")
    if len(ups) != m or ledger.rounds != 1 or ledger.downlink_bytes:
        fail(f"scale_round: {len(ups)} uploads in {ledger.rounds} rounds, "
             f"{ledger.downlink_bytes} B down: expected {m} in one round")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    single = dataclasses.replace(scfg, plan_bucketing="off", stack_chunk=0)
    if on_card:
        torch.cuda.empty_cache()        # one plan of m clients: ~76 GiB
    (flat_clients, _), t_single = clocked(lambda: build_federation(
        single, data, device=dev, seed=scfg.seed))
    single_peak = peak()
    stack = {k: v.detach() for k, v in clients.grouped[1][0].items()}
    want = {k: v.detach() for k, v in flat_clients.grouped[1][0].items()}
    train_err = max(float(((stack[k] - v).abs() / (1 + v.abs())).max())
                    for k, v in want.items())
    del flat_clients, want
    if not train_err <= GROUPED_TRAIN_TOL:
        fail(f"scale_round: bucketed local training is {train_err} off the "
             f"single-plan engine, limit {GROUPED_TRAIN_TOL}")
    if not all(bool(torch.isfinite(v).all()) for v in stack.values()):
        fail("scale_round: a trained client is not finite")
    out["local_phase"] = {
        "seconds_bucketed": t_fed, "seconds_single_plan": t_single,
        "peak_mem_gib_bucketed": fed_peak,
        "peak_mem_gib_single_plan": single_peak,
        "max_err_vs_single_plan": train_err, "tol": GROUPED_TRAIN_TOL,
        "uploads": len(ups), "rounds": ledger.rounds,
        "uplink_bytes": ledger.uplink_bytes}

    two = dataclasses.replace(scfg, client_kinds=("cnn1", "cnn2"))
    (two_clients, _), t_two = clocked(lambda: build_federation(
        two, data, device=dev, seed=scfg.seed))
    groups = [[spec.kind, n] for spec, n in two_clients.grouped[0]]
    if groups != [["cnn1", m // 2], ["cnn2", m // 2]] or not all(
            bool(torch.isfinite(v).all()) for g in two_clients.grouped[1]
            for v in g.values()):
        fail(f"scale_round: the cnn1 + cnn2 federation has groups {groups}"
             " or a client that is not finite")
    out["two_groups"] = {"groups": groups, "seconds": t_two}
    del two_clients

    # FedAvg: the tree against the flat sum
    (tree, t_tree), (flat, t_flat) = (
        clocked(lambda: fedavg(clients, policy=pol)),
        clocked(lambda: fedavg(clients)))
    favg_err = _rel_diff(torch, list(tree.state_dict().values()),
                         list(flat.state_dict().values()))
    if not favg_err <= SCALE_FEDAVG_TOL:
        fail(f"scale_round: tree FedAvg is {favg_err} off flat, limit "
             f"{SCALE_FEDAVG_TOL}")
    out["fedavg"] = {"tree_vs_flat_rel": favg_err, "tol": SCALE_FEDAVG_TOL,
                     "branch": pol.fedavg_branch, "seconds_tree": t_tree,
                     "seconds_flat": t_flat}
    del tree, flat

    # the teacher: chunked against unchunked where the latter fits, then
    # chunked at the full m
    gen = img_generator_init(nz=scfg.nz, img_size=scfg.image_size,
                             out_ch=scfg.in_ch,
                             generator=torch.Generator().manual_seed(31),
                             device=dev)
    src = torch.Generator(device=dev).manual_seed(32)
    with torch.no_grad():
        x = gen(torch.randn((scfg.synth_batch, scfg.nz), device=dev,
                            generator=src))
    y = torch.randint(0, scfg.num_classes, (scfg.synth_batch,), device=dev,
                      generator=src)
    part = stack_grouped(list(clients)[:SCALE_TEACHER_M])
    chunked, p_chunked = _teacher_readings(torch, *part, x, y,
                                           pol.teacher_chunk)
    whole, p_whole = _teacher_readings(torch, *part, x, y, 0)
    with without_cudnn(torch):
        native = [_teacher_readings(torch, *part, x, y, chunk)[0]
                  for chunk in (pol.teacher_chunk, 0)]
    _, p_full = _teacher_readings(torch, *stack_grouped(clients), x, y,
                                  pol.teacher_chunk)
    errs = {name: _rel_diff(torch, [a], [b]) for name, a, b in zip(
        SCALE_TEACHER_READINGS, chunked, whole, strict=True)}
    errs_native = {name: _rel_diff(torch, [a], [b]) for name, a, b in zip(
        SCALE_TEACHER_READINGS, *native, strict=True)}
    grad_vs_native = {"chunked": _rel_diff(torch, chunked[-1:],
                                           native[1][-1:]),
                      "unchunked": _rel_diff(torch, whole[-1:],
                                             native[1][-1:])}
    del chunked, whole, native
    held = [v for k, v in errs.items() if k != "image_grad"]
    if not (max(held + list(errs_native.values())) <= SCALE_TEACHER_TOL
            and grad_vs_native["chunked"] <= 2 * grad_vs_native["unchunked"]
            + SCALE_TEACHER_TOL):
        fail(f"scale_round: the chunked teacher against the unchunked one "
             f"{errs}, without cuDNN {errs_native}, limit "
             f"{SCALE_TEACHER_TOL}; image gradients against the one "
             f"without cuDNN {grad_vs_native}")
    out["teacher"] = {"m": SCALE_TEACHER_M, "chunk": pol.teacher_chunk,
                      "rel_err": errs, "tol": SCALE_TEACHER_TOL,
                      "rel_err_without_cudnn": errs_native,
                      "image_grad_rel_err_vs_no_cudnn": grad_vs_native,
                      "peak_gib_chunked": p_chunked,
                      "peak_gib_unchunked": p_whole,
                      "peak_gib_chunked_full_m": p_full}
    del part, gen, x

    # the server, on the fused driver
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    (student, _, hist), t_dense = clocked(lambda: train_dense_server(
        clients, scfg, device=dev))
    got = read_counts()
    want = scfg.epochs * (scfg.t_g + scfg.s_steps)
    if on_card and got != expected(distill_kl_fwd=want,
                                   distill_kl_bwd=want):
        fail(f"scale_round: the server launched {got}, expected {want} of "
             "each K1 kernel")
    if not finite(_hist_values(hist)) or len(hist.gen_loss) != scfg.epochs:
        fail(f"scale_round: server losses are not finite: {hist}")
    xt, yt = data["test"]
    acc = evaluate(student, xt, yt)
    out["server"] = {
        "driver": hist.loop, "graph_replays": hist.graph_replays,
        "capture_seconds": hist.capture_seconds,
        "host_reads": hist.host_reads, "seconds": t_dense,
        "seconds_per_epoch": t_dense / scfg.epochs, "launches": got,
        "expected_launches_each": want, "gen_loss": hist.gen_loss,
        "dis_loss": hist.dis_loss, "gen_parts": hist.gen_parts,
        "acc": acc, "peak_mem_gib": peak()}
    out["seconds"] = {"data": t_data,
                      "total": time.perf_counter() - t_phase}
    emit({"scale_round": out})
    return {k: got[k] for k in ("distill_kl_fwd", "distill_kl_bwd")}


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
    on_card = torch.device(dev).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        epoch()
    profiled_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_ms(prof)
    busy_ms, summed_ms, records = profiled_device_ms(torch, prof)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    k1_ms = sum(v for k, v in per_kernel.items() if "_kl_" in k)
    # the same epoch captured once and replayed, as the fused driver
    # runs every epoch after its first
    fused = None
    if on_card:
        from repro_torch.core.graph import CapturedEpoch

        g_opt.count_on_device()

        def steps():
            for _ in range(scfg.t_g):
                gl, _ = gen_step(gen, g_opt, student, z, y)
            return torch.stack([gl, student_step(student, s_opt, gen, z)])

        graph = CapturedEpoch(steps)
        graph.replay()                        # warm-up
        sync(torch, dev)
        t0 = time.perf_counter()
        graph.replay()
        sync(torch, dev)
        replay_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=activities) as prof:
            graph.replay()
            sync(torch, dev)
        g_busy, g_summed, g_records = profiled_device_ms(torch, prof)
        fused = {"capture_seconds": graph.capture_seconds,
                 "replay_epoch_ms": replay_ms,
                 "device_busy_ms": g_busy, "device_summed_ms": g_summed,
                 "device_idle_share": 1 - g_busy / replay_ms,
                 "device_records_a_replay": g_records,
                 "k1_ms": sum(v for k, v in device_ms(prof).items()
                              if "_kl_" in k)}
        del graph
    # the profiler slows the host several times over: the idle share is
    # taken against the same epoch's time without it
    emit({"profile_epoch": {
        "epoch_ms": epoch_ms, "profiled_epoch_ms": profiled_ms,
        "device_busy_ms": busy_ms, "device_summed_ms": summed_ms,
        "device_idle_share": 1 - busy_ms / epoch_ms,
        "device_records_an_epoch": records,
        "k1_ms": k1_ms, "n_kernel_names": len(per_kernel),
        "top_kernels_ms": top, "fused_replay": fused}})


# ----------------------------------------------------- card against CPU --

class _Capture:
    """An optimizer stand-in that keeps the gradients it is given (on the
    host, or with ``on_device`` where they are), or with ``keep`` False
    drops them."""

    def __init__(self, params, keep: bool = True, on_device: bool = False):
        self.params = list(params)
        self.keep = keep
        self.on_device = on_device

    def step(self, grads):
        if self.keep:
            self.grads = [g.detach() if self.on_device else g.detach().cpu()
                          for g in grads]


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
            prof = {}
            device = device_ms_per_call(
                torch, sm90, lambda n: "sm90_paged_attention" in n,
                info=prof,
                name=f"paged_attention sm90 R{R} D{d} M{m} {dname}")
            rows.append({
                "shape": {"R": R, "Hq": hq, "Hkv": hkv, "D": d, "page": page,
                          "M": m}, "seq_lens": seq.tolist(), "dtype": dname,
                "route": "sm90", "splits": n_split, "pages_a_split": pps,
                "ok": ok and zero_rows, "zero_rows_exact": zero_rows,
                "max_abs_err": err, "tol": TOL_K4[dname],
                "ms": cuda_ms(torch, sm90), "device_ms": device, **prof,
                "first_version_ms": cuda_ms(torch, simt),
                "first_version_device_ms": device_ms_per_call(
                    torch, simt, lambda n: "paged_attention_kernel<" in n
                    and "sm90_" not in n,
                    name=f"paged_attention simt R{R} D{d} M{m} "
                    f"{dname}"),
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
    """(attention blocks that take K2 without a cache, mamba blocks) one
    pass of the trunk runs: a hybrid applies its shared block once per
    super-block; a vlm's self layers take K2, its cross layers attend on
    the plain path; MLA and a sliding-window pattern (gemma3) attend on
    the plain path in every layer, as in the reference."""
    from repro_torch.models.transformer import hybrid_shape, vlm_shape

    if cfg.family == "ssm":
        return 0, cfg.n_layers
    if cfg.family == "hybrid":
        return hybrid_shape(cfg)[0], cfg.n_layers
    if cfg.kv_lora_rank or cfg.sliding_window:
        return 0, 0
    if cfg.family == "vlm":
        n_super, per = vlm_shape(cfg)
        return n_super * per, 0
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
        "k3f_routes": {r: routes[f"k3f_{r}"] for r in ("sm90", "simt")},
        "k3b_routes": {r: routes[f"k3b_{r}"] for r in ("sm90", "simt")},
        "launches_dense_mode": dense_launches,
        "tokens_first_request": paged[0].tolist()}})
    if not same:
        fail(f"{label}: paged and dense engines disagree: {paged} vs {dense}")
    if launches != want or dense_launches != want_dense:
        fail(f"{label}: launches {launches} (paged), {dense_launches} "
             f"(dense), expected {want} and {want_dense}")
    check_k4_routes(label, launches, routes)
    check_k3_routes(label, launches, routes, k3f_route(torch, cfg))
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
        "k3f_routes": {r: routes[f"k3f_{r}"] for r in ("sm90", "simt")},
        "k3b_routes": {r: routes[f"k3b_{r}"] for r in ("sm90", "simt")},
        "blocks_attention_mamba": trunk_blocks(cfg),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}})
    if not ok_tokens:
        fail(f"the {label} phase's token streams are malformed")
    if launches != want or steps == 0:
        fail(f"launches on the {label} path {launches}, expected {want}: "
             f"{steps} decode steps x {trunk_blocks(cfg)[0]} of K4, "
             f"{len(reqs)} prefills x {trunk_blocks(cfg)[1]} of K3f")
    check_k4_routes(label, launches, routes)
    check_k3_routes(label, launches, routes, k3f_route(torch, cfg))
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
    busy_ms, summed_ms, _ = profiled_device_ms(torch, prof)
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
        "device_summed_ms": summed_ms,
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

def device_ms_by_name(torch, fn, calls: int = 20, counts=None) -> dict:
    """Device time of one launch by kernel name: the mean over the
    records ``torch.profiler`` kept of ``calls`` calls after a warm-up,
    the kernels alone, without the wrapper's host time. For a kernel a
    call launches once it is the time a call, and a record the profiler
    drops does not lower it (late in a long run it kept fewer than
    ``calls``). ``counts``, a dict, receives the records kept of each
    name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_kernel = device_ms(prof)
    kept = {e.key: e.count for e in prof.key_averages()
            if e.key in per_kernel}
    if counts is not None:
        counts.update(kept)
    return {k: v / max(kept.get(k, calls), 1) for k, v in per_kernel.items()}


# kernels the profiler kept no record of in any of a call's tries, timed
# from CUDA events instead (one entry each, in the "profiler" line)
PROFILER_FALLBACKS = []


def device_profile(torch, fn, kernels: dict, calls: int = 20,
                   tries: int = 3, label: str = "") -> dict:
    """Device time a call of ``fn`` of each of ``kernels`` (a name → a
    match on device names; each kernel launched once a call), from
    ``device_ms_by_name``: ``device_ms`` (their sum), ``device_ms_by_kernel``,
    the records the profiler kept of them and the profiled runs it took.
    The profiler at times keeps no record of a kernel of a run, so a run
    that misses one is profiled again, up to ``tries``. If every run missed
    one, ``device_ms`` is the call's time from CUDA events (``cuda_ms``:
    the kernels plus any host time between them, so no less than their
    device time), ``device_ms_source`` says so, the missed kernels' entries
    are None and the miss is listed, under ``label``, in
    ``PROFILER_FALLBACKS``."""
    for run in range(1, tries + 1):
        counts = {}
        by_name = device_ms_by_name(torch, fn, calls, counts)
        names = {k: [n for n in by_name if match(n) and counts.get(n)]
                 for k, match in kernels.items()}
        if all(names.values()):
            break
    by_kernel = {k: sum(by_name[n] for n in ns) if ns else None
                 for k, ns in names.items()}
    out = {"profiled_records": sum(counts[n] for ns in names.values()
                                   for n in ns),
           "profile_runs": run, "device_ms_by_kernel": by_kernel}
    if all(names.values()):
        return {**out, "device_ms": sum(by_kernel.values()),
                "device_ms_source": "profiler"}
    missed = [k for k, ns in names.items() if not ns]
    PROFILER_FALLBACKS.append({"label": label, "kernels": missed,
                               "tries": tries})
    return {**out, "device_ms": cuda_ms(torch, fn),
            "device_ms_source": "cuda_events"}


def device_ms_per_call(torch, fn, match, calls: int = 20, info=None,
                       name: str = "kernel") -> float:
    """``device_profile``'s ``device_ms`` for the kernels whose names
    satisfy ``match``, launched once a call, called ``name`` where the
    profiler missed them. ``info``, a dict, receives the rest of its result
    but ``device_ms_by_kernel``."""
    prof = device_profile(torch, fn, {"kernel": match}, calls, label=name)
    if info is not None:
        info.update({k: v for k, v in prof.items()
                     if k not in ("device_ms", "device_ms_by_kernel")})
    return prof["device_ms"]


def k2_kernel(which, route):
    """Matches the device name of K2's ``which`` kernel (``fwd``, ``dq``,
    ``dkv``) on ``route``: ``sm90_dq_kernel<...>`` on sm90 (float32 K2f:
    ``sm90_fwd_f32_kernel<...>``), ``dq_kernel<...>`` on simt (K3's
    ``ssd_fwd_kernel`` is neither)."""
    if route == "sm90":
        return lambda name: f"sm90_{which}_" in name
    return lambda name: (f"{which}_kernel<" in name and "sm90_" not in name
                         and "ssd_" not in name)


def k3_kernel(which, route):
    """Matches the device names of K3's ``which`` kernels (``fwd``,
    ``bwd``) on ``route``: K3f's sm90 route is three kernels named
    ``ssd_sm90_...``, K3b's five named ``ssd_sm90_bwd_...`` (float32's
    with ``_f32`` after the phase's name, ``ssd_sm90_chunk_scan_kernel_f32``
    and the like); the first versions are ``ssd_fwd_kernel<...>`` and
    ``ssd_bwd_kernel<...>``."""
    if route == "sm90" and which == "bwd":
        return lambda name: "ssd_sm90_bwd_" in name
    if route == "sm90":
        return lambda name: "ssd_sm90_" in name and "ssd_sm90_bwd_" not in name
    return lambda name: f"ssd_{which}_kernel<" in name


def ms_by_route(per_kernel: dict) -> tuple[dict, dict]:
    """K2's (fwd, dq, dkv) and K3's (fwd, bwd) device time by route
    (sm90, simt) from ``device_ms``'s kernel times."""
    def by(match, kinds):
        return {w: {r: sum(v for k, v in per_kernel.items()
                           if match(w, r)(k)) for r in ("sm90", "simt")}
                for w in kinds}

    return by(k2_kernel, ("fwd", "dq", "dkv")), by(k3_kernel, ("fwd", "bwd"))


def device_ms_total(torch, fn, calls: int = 20) -> tuple[float, float]:
    """Device time a call of ``fn``, every kernel it launches summed, from
    ``torch.profiler`` over ``calls`` calls after a warm-up, and the kernel
    records the profiler kept a call (a drop shows as fewer than the
    call launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_kernel = device_ms(prof)
    records = sum(e.count for e in prof.key_averages() if e.key in per_kernel)
    return sum(per_kernel.values()) / calls, records / calls


def span_union(spans) -> float:
    """The length of the union of (start, end) spans: the time at least
    one span covers."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profiled_device_ms(torch, prof) -> tuple[float, float, int]:
    """(busy, summed, records) of a ``torch.profiler`` run's device
    records (kernels, copies, sets): busy is the time at least one of them
    ran, the union of their spans, where records that overlap count once;
    summed adds their durations, which overcounts by the overlap. Both in
    ms."""
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return (span_union(spans) / 1e3, sum(e - s for s, e in spans) / 1e3,
            len(spans))


def device_busy_ms(torch, fn, calls: int = 5) -> dict:
    """Device time a call of ``fn`` (``profiled_device_ms``: busy and
    summed) and its device records, from ``torch.profiler`` over
    ``calls`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy, summed, records = profiled_device_ms(torch, prof)
    return {"busy_ms": busy / calls, "summed_ms": summed / calls,
            "records": records / calls}


# F.scaled_dot_product_attention's backends, in the order the yardstick
# tries them: the first that takes a shape's inputs (and their backward)
# is pinned with torch.nn.attention.sdpa_kernel and named in the row
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def sdpa_yardstick(torch, q, k, v, do, sdpa_kw) -> dict:
    """The library call beside K2 (never on the port's path):
    F.scaled_dot_product_attention with enable_gqa on q, k, v, pinned to
    one backend, forward and its autograd backward (dq, dk, dv under
    ``do``): each one's time from CUDA events (``cuda_ms``: the host's
    work between the kernels included) and its device time
    (``device_ms_total``)."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)

        def fwd():
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    *leaves, enable_gqa=True, **sdpa_kw)

        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out = fwd()
                torch.autograd.grad(out, leaves, do, retain_graph=True)
                torch.cuda.synchronize()
            break
        except RuntimeError:
            continue
    else:
        fail(f"no SDPA backend of {SDPA_BACKENDS} takes {tuple(q.shape)}")

    def fwd_only():
        with torch.no_grad():
            return fwd()

    def bwd():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)

    f_dev, f_rec = device_ms_total(torch, fwd_only)
    b_dev, b_rec = device_ms_total(torch, bwd)
    res = {"backend": name.lower(),
           "fwd_ms": cuda_ms(torch, fwd_only), "fwd_device_ms": f_dev,
           "fwd_records_a_call": f_rec,
           "bwd_ms": cuda_ms(torch, bwd), "bwd_device_ms": b_dev,
           "bwd_records_a_call": b_rec}
    del out, leaves
    return res


def k2_phase(torch):
    """K2f, K2q and K2kv against their plain versions, timed beside their
    bound and beside F.scaled_dot_product_attention pinned to a named
    backend (forward, and its autograd backward as the yardstick of the
    backward pair; wall and device time). Every row names its route and
    gives its kernel's device time without the wrapper's host time; an
    sm90 row also times the simt kernel (the first version) on the same
    inputs."""
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
            route = FA.route("fwd", dtype, d)
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
            if route == "sm90" and dtype != torch.float32:
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
            # both backward versions from the kernel's residuals; the
            # kernels on the sm90 route read dO in the input dtype, where
            # do is made, on simt in float32
            dof = do.float().reshape(B * hq, sq, d)
            delta, do_k = FA.bwd_operands(q, o, do)
            dq = FA.flash_attention_bwd_dq(q, k, v, do_k, lse, delta, **kw)
            dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do_k, lse, delta,
                                                **kw)
            torch.cuda.synchronize()
            want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
            errs = [_grad_err(a, b) for a, b in zip((dq, dk, dv), want)]
            abs_errs = [float((a.float() - b.float()).abs().max())
                        for a, b in zip((dq, dk, dv), want)]
            dq_dead = bool((dq.reshape(B * hq, sq, d)[dead] == 0).all())

            lib = sdpa_yardstick(torch, q, k, v, do, sdpa_kw)
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
            prof = {}
            row = {
                **common, "route": route, "ok": ok_o and ok_l and dead_exact,
                "max_abs_err": max(err_o, err_l), "o_max_abs_err": err_o,
                "lse_max_abs_err": err_l, "o_tol": list(o_tol),
                "lse_tol": list(lse_tol), "dead_rows_exact": dead_exact,
                "ms": cuda_ms(torch, fwd),
                "device_ms": device_ms_per_call(
                    torch, fwd, k2_kernel("fwd", route), info=prof,
                    name=f"flash_attention_fwd {route} {name} {dname}"),
                "plain_ms": cuda_ms(torch, lambda: FA.flash_attention_fwd_plain(
                    q, k, v, **kw)),
                "library_ms": lib["fwd_ms"],
                "library_device_ms": lib["fwd_device_ms"],
                "library_backend": lib["backend"],
                "library_records_a_call": lib["fwd_records_a_call"],
                "bound_ms": b_ms, "bound_by": b_by}
            row.update(prof)
            row["bound_share_of_device_ms"] = b_ms / row["device_ms"]
            if route == "sm90":
                row["first_version_ms"] = cuda_ms(torch, simt)
                row["first_version_device_ms"] = device_ms_per_call(
                    torch, simt, k2_kernel("fwd", "simt"),
                    name=f"flash_attention_fwd simt {name} {dname}")
            if name == "long" or name == "d112":
                row["device_tflops_live"] = 4 * d * n_live / (
                    row["device_ms"] * 1e-3) / 1e12
            rows["fwd"].append(row)
            # a backward kernel reads q, k, v, dO (in its route's dtype),
            # lse and delta once and writes dq, or dk and dv
            for which, ok, abs_err, rel_err, out_bytes, ops, extra in (
                    ("dq", errs[0] <= tol and dq_dead, abs_errs[0], errs[0],
                     B * hq * sq * d * isz, 6 * d * n_live,
                     {"dead_rows_exact": dq_dead}),
                    ("dkv", max(errs[1:]) <= tol, max(abs_errs[1:]),
                     max(errs[1:]), 2 * B * hkv * sk * d * isz,
                     8 * d * n_live, {})):
                broute = FA.route(which, dtype, d)
                launch = getattr(FA, f"flash_attention_bwd_{which}")
                call = lambda r: lambda: launch(
                    q, k, v, do_k if r == broute else dof, lse, delta,
                    route=r, **kw)
                in_bytes = qkv_bytes + 2 * row_bytes \
                    + B * hq * sq * d * do_k.element_size()
                b_ms, b_by = bound(in_bytes + out_bytes, ops, peak)
                prof = {}
                row = {**common, "route": broute, "ok": ok,
                       "max_abs_err": abs_err, "max_rel_err": rel_err,
                       **extra, "ms": cuda_ms(torch, call(broute)),
                       "device_ms": device_ms_per_call(
                           torch, call(broute), k2_kernel(which, broute),
                           info=prof, name=f"flash_attention_bwd_{which} "
                           f"{broute} {name} {dname}"),
                       "plain_ms": plain_bwd, "library_ms": lib["bwd_ms"],
                       "library_device_ms": lib["bwd_device_ms"],
                       "library_backend": lib["backend"],
                       "library_records_a_call": lib["bwd_records_a_call"],
                       "bound_ms": b_ms, "bound_by": b_by}
                row.update(prof)
                row["bound_share_of_device_ms"] = b_ms / row["device_ms"]
                if broute == "sm90":
                    row["first_version_ms"] = cuda_ms(torch, call("simt"))
                    row["first_version_device_ms"] = device_ms_per_call(
                        torch, call("simt"), k2_kernel(which, "simt"),
                        name=f"flash_attention_bwd_{which} simt {name} "
                        f"{dname}")
                if name == "long" or name == "d112":
                    row["device_tflops_live"] = ops / (
                        row["device_ms"] * 1e-3) / 1e12
                rows[which].append(row)
            del q, k, v, do, o, lse, po, plse, dof, do_k, delta, dq, dk, \
                dv, want
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
    # sm90 exactly in 16 bits at the shapes K2_FP16 names (every D but 32)
    # and for every float32 row of every kernel
    routes = {(which, r["shape"]["name"], r["dtype"]): r["route"]
              for which, rs in rows.items() for r in rs}
    if any((r == "sm90") != (n in K2_FP16 or dt == "float32")
           for (which, n, dt), r in routes.items()):
        fail(f"K2 took an unexpected route: {routes}")
    return rows


# ------------------------------------------------------------------- K3 --

def k3_inputs(torch, B, S, H, P, G, N, dtype, init, seed, dev="cuda"):
    """x, dt (float32, as the model passes it), a, b, c, an initial state
    (None unless ``init``, as a training step passes none), dy (in x's
    dtype, as the model's autograd hands it to K3b) and d(final state),
    on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    x = r(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(r(B, S, H) - 1.0)
    a = -torch.exp(r(H) * 0.3)
    b, c = ((r(B, S, G, N) * 0.3).to(dtype) for _ in range(2))
    s0 = r(B, H, P, N) * 0.5 if init else None
    return x, dt, a, b, c, s0, r(B, S, H, P).to(dtype), r(B, H, P, N)


def k3_work(B, S, H, P, G, N, cl, isz, init, dy_isz=4):
    """(forward bytes, forward operations, backward bytes, backward
    operations) that these inputs need: the live (l >= s) pairs within
    each chunk's valid positions, 2(N + P) flops a pair forward and
    2(3N + 2P) backward, 4PN a position forward (y_off, the state
    deposit) and 10PN backward; each input read and each output written
    once (the forward writes the chunk states, as in training, and reads
    an initial state only when ``init``; the backward reads dy at
    ``dy_isz`` bytes an element and writes db and dc per group)."""
    nc = -(-S // cl)
    lens = [min(cl, S - i * cl) for i in range(nc)]
    pairs = sum(n * (n + 1) // 2 for n in lens)
    bh = B * H
    fwd_ops = bh * (pairs * 2 * (N + P) + 4 * S * P * N)
    bwd_ops = bh * (pairs * 2 * (3 * N + 2 * P) + 10 * S * P * N)
    xs, bcs, st = B * S * H * P, B * S * G * N, bh * P * N
    fwd_bytes = (2 * xs + 2 * bcs) * isz + 4 * (
        B * S * H + H + (2 if init else 1) * st + bh * nc * P * N)
    bwd_bytes = (xs + 2 * bcs) * isz + xs * dy_isz \
        + 4 * (B * S * H + H + bh * nc * P * N + st) \
        + 4 * (xs + B * S * H + H + 2 * bcs + st)
    return fwd_bytes, fwd_ops, bwd_bytes, bwd_ops


# each K3 route's kernels by phase: a substring of each device name (a
# float32 kernel's name adds _f32 after it)
K3_KERNELS = {
    ("fwd", "sm90"): {ph: f"ssd_sm90_{ph}_kernel" for ph in (
        "chunk_state", "state_pass", "chunk_scan")},
    ("fwd", "simt"): {"ssd_fwd": "ssd_fwd_kernel<"},
    ("bwd", "sm90"): {ph: f"ssd_sm90_bwd_{ph}_kernel" for ph in (
        "deposit", "dstate_pass", "column", "row", "finish")},
    ("bwd", "simt"): {"ssd_bwd": "ssd_bwd_kernel<"}}


def k3_profile(torch, fn, which, route, label: str) -> dict:
    """``device_profile`` of K3's ``which`` kernels on ``route``, each
    kernel's time as ``device_ms_by_phase`` on sm90."""
    out = device_profile(torch, fn, {
        ph: lambda n, sub=sub: sub in n
        for ph, sub in K3_KERNELS[which, route].items()},
        label=f"ssd_scan_{which} {route} {label}")
    by_phase = out.pop("device_ms_by_kernel")
    if route == "sm90":
        out["device_ms_by_phase"] = by_phase
    return out


def k3_phase(torch, shapes=K3_SHAPES, dev="cuda"):
    """K3f and K3b against their plain versions (the chunked formula in
    PyTorch and autograd through it), at the small shape also against the
    sequential recurrence, timed beside their bound, each row with its
    kernels' device time. A K3f row names its route; an sm90 row also
    times the first version (the simt route) on the same inputs and checks
    two calls bit for bit, and in 16 bits gives y's error over its
    rounding bound. K3b reads the states the forward wrote. No single
    PyTorch call computes the SSD scan: library_ms is None."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import ssd_scan as K3

    rows = {"fwd": [], "bwd": []}
    for name, B, S, H, P, G, N, cl, dname, init in shapes:
        dtype = getattr(torch, dname)
        tol = TOL_K3[dname]
        route = K3.fwd_route(dtype, P, N)
        x, dt, a, b, c, s0, dy, dfin = k3_inputs(
            torch, B, S, H, P, G, N, dtype, init, S + H + N, dev)
        fwd = lambda r=None: K3.ssd_scan_fwd(
            x, dt, a, b, c, s0, chunk=cl, return_chunk_states=True, route=r)
        y, fin, st = fwd()
        torch.cuda.synchronize()
        py, pfin, pst = K3.ssd_scan_fwd_plain(x, dt, a, b, c, s0, chunk=cl)
        errs_f = [_grad_err(y, py), _grad_err(fin, pfin),
                  _grad_err(st, pst)]
        ok_f = errs_f[0] <= tol and max(errs_f[1:]) <= 1e-4
        extra = {}
        if route == "sm90":
            extra["bit_for_bit"] = all(torch.equal(u, v) for u, v in
                                       zip(fwd(), (y, fin, st)))
            ok_f = ok_f and extra["bit_for_bit"]
        if route == "sm90" and dname in UNIT_ROUNDOFF:
            # 2u (sum|terms| + |y|): the plain forward on |x|, |b|, |c|
            # and |initial state| bounds sum|terms| elementwise
            terms = K3.ssd_scan_fwd_plain(
                x.float().abs(), dt, a, b.float().abs(), c.float().abs(),
                None if s0 is None else s0.abs(), chunk=cl)[0]
            bound_y = 2 * UNIT_ROUNDOFF[dname] * (terms + py.float().abs())
            extra["y_err_over_bound"] = float(
                ((y.float() - py.float()).abs() / bound_y.clamp(min=1e-30))
                .max())
            del terms, bound_y
        broute = K3.bwd_route(dtype, P, N)
        bwd = lambda r=None: K3.ssd_scan_bwd(x, dt, a, b, c, st, dy, dfin,
                                             chunk=cl, route=r)
        grads = bwd()
        torch.cuda.synchronize()
        want = K3.ssd_scan_bwd_plain(x, dt, a, b, c, pst, dy, dfin, chunk=cl)
        errs_b = [_grad_err(g, w) for g, w in zip(grads, want)]
        # float32 (either route) is float32 throughout; the 16-bit sm90
        # route rounds to 16 bits before its products (d(initial_state)
        # from the float32 dS pass over hi + lo deposits)
        rounds = broute == "sm90" and dname in TOL_K3B_EMULATED
        tol_b = [1e-2] * 5 + [1e-4] if rounds else [1e-4] * 6
        ok_b = all(e <= t for e, t in zip(errs_b, tol_b))
        bextra = {}
        if broute == "sm90":
            bextra = {
                "err_over_tol": {
                    "vs_float32": max(e / t for e, t in zip(errs_b, tol_b))},
                "bit_for_bit": all(torch.equal(u, v)
                                   for u, v in zip(bwd(), grads))}
            ok_b = ok_b and bextra["bit_for_bit"]
        if rounds:          # in float32 the chunked plain is the oracle
            emul = K3.ssd_scan_bwd_chunked_plain(
                x, dt, a, b, c, st, dy, dfin, chunk=cl, emulate=dtype)
            errs_e = [_grad_err(g, w) for g, w in zip(grads, emul)]
            tol_e = TOL_K3B_EMULATED[dname]
            bextra["max_rel_err_vs_emulated"] = dict(zip(K3B_GRADS, errs_e))
            bextra["tol_vs_emulated"] = tol_e
            bextra["err_over_tol"]["vs_emulated"] = max(errs_e) / tol_e
            ok_b = ok_b and max(errs_e) <= tol_e
            del emul
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
        fb, fo, bb, bo = k3_work(B, S, H, P, G, N, cl, isz, init,
                                 dy.element_size())
        shape = {"name": name, "B": B, "S": S, "H": H, "P": P, "G": G,
                 "N": N, "chunk": cl, "nc": -(-S // cl),
                 "initial_state": init}
        b_ms, b_by = bound(fb, fo, peak)
        row = {
            "shape": shape, "dtype": dname, "route": route, "ok": ok_f,
            "max_abs_err": max(float((y.float() - py.float()).abs().max()),
                               float((fin - pfin).abs().max())),
            "max_rel_err": {"y": errs_f[0], "final": errs_f[1],
                            "chunk_states": errs_f[2]},
            "vs_sequential": oracle.get("y"), "tol": tol, **extra,
            "ms": cuda_ms(torch, fwd),
            "plain_ms": cuda_ms(torch, lambda: K3.ssd_scan_fwd_plain(
                x, dt, a, b, c, s0, chunk=cl)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "ops": fo, "bytes": fb}
        row.update(k3_profile(torch, fwd, "fwd", route, f"{name} {dname}"))
        row["bound_share_of_device_ms"] = b_ms / row["device_ms"]
        if route == "sm90":
            row["first_version_ms"] = cuda_ms(torch, lambda: fwd("simt"))
            row["first_version_device_ms"] = k3_profile(
                torch, lambda: fwd("simt"), "fwd", "simt",
                f"{name} {dname}")["device_ms"]
        rows["fwd"].append(row)
        b_ms, b_by = bound(bb, bo, peak)
        nc = -(-S // cl)
        blocks = B * H * sum(-(-min(cl, S - i * cl) // 64) for i in range(nc))
        brow = {
            "shape": shape, "dtype": dname, "route": broute, "ok": ok_b,
            "max_abs_err": max(float((g - w).abs().max())
                               for g, w in zip(grads, want)),
            "max_rel_err": dict(zip(K3B_GRADS, errs_b)),
            "vs_sequential": oracle.get("grads"),
            "tol": dict(zip(K3B_GRADS, tol_b)), **bextra,
            "forward_route": route, "ms": cuda_ms(torch, bwd),
            "plain_ms": cuda_ms(torch, lambda: K3.ssd_scan_bwd_plain(
                x, dt, a, b, c, pst, dy, dfin, chunk=cl)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "ops": bo, "bytes": bb,
            "ctas": {"deposit": B * H * nc, "column": blocks, "row": blocks,
                     "finish": B * H * nc} if broute == "sm90" else B * H}
        brow.update(k3_profile(torch, bwd, "bwd", broute, f"{name} {dname}"))
        brow["bound_share_of_device_ms"] = b_ms / brow["device_ms"]
        if broute == "sm90":
            brow["first_version_ms"] = cuda_ms(torch, lambda: bwd("simt"))
            brow["first_version_device_ms"] = k3_profile(
                torch, lambda: bwd("simt"), "bwd", "simt",
                f"{name} {dname}")["device_ms"]
        rows["bwd"].append(brow)
        del x, dt, a, b, c, s0, dy, dfin, y, fin, st, py, pfin, pst, grads, \
            want
        torch.cuda.empty_cache()
    for which, rs in rows.items():
        for r in rs:
            emit({"kernel_check": {"name": f"ssd_scan_{which}", **r}})
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        fail(f"{len(bad)} K3 checks disagree with the plain versions: {bad}")
    for which, rs in rows.items():
        routes = {(r["shape"]["name"], r["dtype"]): r["route"] for r in rs}
        want = {(r["shape"]["name"], r["dtype"]):
                "sm90" if r["shape"]["P"] == 64 and r["shape"]["N"] in (64, 128)
                else "simt" for r in rs}
        if routes != want:
            fail(f"K3{which[0]} took an unexpected route: {routes}")
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
                     state["opt"].grads, read_counts(), _peak_gib(torch),
                     read_routes())
        del state, m
    (la, na, ga, ca, _, ra), (lb, nb, gb, _, _, _) = out["fused"], out["ref"]
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
        "k2_routes": {kind: {r: ra[f"{kind}_{r}"]
                             for r in ("sm90", "simt")}
                      for kind in ("fwd", "dq", "dkv")},
        "k3f_routes": {r: ra[f"k3f_{r}"] for r in ("sm90", "simt")},
        "k3b_routes": {r: ra[f"k3b_{r}"] for r in ("sm90", "simt")},
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
    check_k2_routes(label, ca, ra, getattr(torch, cfg.dtype), cfg.head_dim)
    check_k3_routes(label, ca, ra, k3f_route(torch, cfg))
    del params, out, ga, gb
    torch.cuda.empty_cache()


HYBRID_LAYERS = 13       # two super-blocks of 6 and the shared block, 1 tail
HYBRID_STEPS = 3
# The first kernel-route step against the plain route's, from the same
# weights and batch, both in bfloat16, relative: limits set from
# scripts/hybrid_step_limits.py's readings on an H100 (PERF.md, PR 22).
# Sound steps read at most 8.9e-5 (loss) and 1.1e-4 (grad_norm); a K2f
# fault (o's last 16 columns or last q-tile lost) moves the loss by
# 3.3e-4 or more, a K2f, K2kv or K3b fault grad_norm by 4.3e-4 or more.
HYBRID_LOSS_TOL = 2e-4
HYBRID_NORM_TOL = 2e-4


def hybrid_inputs(torch, dev="cuda", arch="zamba2-7b",
                  n_layers=HYBRID_LAYERS, batch=(2, 512), steps=HYBRID_STEPS,
                  seed=5):
    """ssm_hybrid_train's model and data: ``arch`` at full width in its
    own dtype (bfloat16 for zamba2-7b), ``n_layers`` deep, on the kernel
    route, random weights from ``seed``, and ``steps`` batches of
    ``batch`` tokens: (full config, config, params, batches)."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches, make_lm_data
    from repro_torch.models import transformer as T

    full = get_config(arch)
    cfg = full.replace(n_layers=n_layers, kernel_vjp_mode="fused")
    params = T.init_model(cfg, seed=seed, device=dev)
    toks = make_lm_data(seed, vocab=cfg.vocab_size, n_tokens=200_000)
    data = [{"tokens": torch.from_numpy(x).to(dev),
             "labels": torch.from_numpy(y).to(dev)}
            for x, y in lm_batches(toks, batch[0], batch[1], seed=seed,
                                   steps=steps)]
    return full, cfg, params, data


def first_step(torch, cfg, params, batch, keep=False):
    """One train step of ``cfg``'s route from ``params`` with no update:
    (loss, grad_norm, the clipped gradients where they were computed, or
    None unless ``keep``)."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T

    leaves = T.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = _Capture(leaves, keep=keep, on_device=True)
    _, m = ST.make_train_step(cfg)(
        {"params": params, "opt": opt, "step": 0}, batch)
    return float(m["loss"]), float(m["grad_norm"]), getattr(opt, "grads",
                                                            None)


def hybrid_train(torch, dev="cuda", arch="zamba2-7b",
                 label="ssm_hybrid_train", **shape):
    """zamba2-7b's train step in bfloat16 at full width, HYBRID_LAYERS
    deep (two applications of the shared block a pass; ``shape`` passes
    other ``hybrid_inputs`` arguments, as a CPU rehearsal cuts them),
    through the kernel route: HYBRID_STEPS timed steps, each counted (a
    step with remat: K2f 4, K2q 2, K2kv 2, K3f 26, K3b 13), all on sm90;
    then one step under
    ``torch.profiler``. The first step's loss and grad_norm are held to
    the plain route's (``ref``, same weights and batch, no update) to
    HYBRID_LOSS_TOL and HYBRID_NORM_TOL."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T

    full, cfg, params, data = hybrid_inputs(torch, dev, arch, **shape)
    n_params = sum(t.numel() for t in T.leaves(params))
    zero_counts()
    ref = first_step(torch, cfg.replace(kernel_vjp_mode="ref"), params,
                     data[0])[:2]
    sync(torch, dev)
    ref_counts = read_counts()

    state = ST.make_train_state(cfg, params=params, device=dev)
    step = ST.make_train_step(cfg)
    want = train_launches(cfg)
    routes = {k: 0 for k in read_routes()}
    secs, losses, norms = [], [], []
    steps = len(data)
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        zero_counts()
        sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step(state, data[i])
        sync(torch, dev)
        secs.append(time.perf_counter() - t0)
        got = read_counts()
        if got != want:
            fail(f"{label}: step {i} launched {got}, expected {want}")
        for k, c in read_routes().items():
            routes[k] += c
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = _peak_gib(torch)
    activities = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(state, data[-1])
        sync(torch, dev)
        profiled_s = time.perf_counter() - t0
    per_kernel = device_ms(prof)
    busy_ms, summed_ms, _ = profiled_device_ms(torch, prof)
    k2_by_route, k3_by_route = ms_by_route(per_kernel)
    totals = {k: c * steps for k, c in want.items()}
    loss_err = abs(losses[0] - ref[0]) / abs(ref[0])
    norm_err = abs(norms[0] - ref[1]) / abs(ref[1])
    emit({label: {
        "arch": arch,
        "cfg": {"d_model": cfg.d_model,
                "n_layers": [full.n_layers, cfg.n_layers],
                "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim":
                cfg.head_dim, "ssm": [cfg.ssm_head_dim, cfg.ssm_state],
                "vocab": cfg.vocab_size, "dtype": cfg.dtype,
                "remat": cfg.remat, "batch": list(data[0]["tokens"].shape),
                "shared_block_applications": trunk_blocks(cfg)[0]},
        "params": n_params, "steps": steps, "seconds": secs,
        "seconds_per_step": statistics.median(secs[1:] or secs),
        "profiled_step_seconds": profiled_s, "peak_mem_gib": peak,
        "loss": losses, "grad_norm": norms,
        "loss_ref": ref[0], "grad_norm_ref": ref[1],
        "first_loss_rel_err": loss_err, "first_grad_norm_rel_err": norm_err,
        "tol": {"loss": HYBRID_LOSS_TOL, "grad_norm": HYBRID_NORM_TOL},
        "launches_per_step": want, "launches_ref": ref_counts,
        "fwd_routes": {r: routes[f"fwd_{r}"] for r in ("sm90", "simt")},
        "bwd_routes": {r: routes[f"bwd_{r}"] for r in ("sm90", "simt")},
        "k3f_routes": {r: routes[f"k3f_{r}"] for r in ("sm90", "simt")},
        "k3b_routes": {r: routes[f"k3b_{r}"] for r in ("sm90", "simt")},
        "device_busy_ms": busy_ms, "device_summed_ms": summed_ms,
        "device_idle_share": 1 - busy_ms / (profiled_s * 1e3),
        "k2_ms_by_route": k2_by_route, "k2_ms": sum(
            v for by in k2_by_route.values() for v in by.values()),
        "k3_ms_by_route": k3_by_route,
        "top_kernels_ms": sorted(per_kernel.items(),
                                 key=lambda kv: -kv[1])[:15]}})
    finite = all(v == v and abs(v) != float("inf")
                 for v in (*losses, *norms, *ref))
    if not finite or loss_err > HYBRID_LOSS_TOL \
            or norm_err > HYBRID_NORM_TOL:
        fail(f"{label}: losses {losses}, grad norms {norms}, the plain "
             f"route's {ref}: not finite, or the first loss off by "
             f"{loss_err} (tol {HYBRID_LOSS_TOL}) or grad_norm by "
             f"{norm_err} (tol {HYBRID_NORM_TOL})")
    if ref_counts != expected():
        fail(f"{label}: the plain route launched {ref_counts}")
    # the slice's path: K2f, K2q and K2kv on the tensor cores at D 112,
    # both K3 kernels on sm90
    k2_want = {"fwd_sm90": totals["flash_attention_fwd"], "fwd_simt": 0,
               "bwd_sm90": totals["flash_attention_bwd_dq"]
               + totals["flash_attention_bwd_dkv"], "bwd_simt": 0}
    if {k: routes[k] for k in k2_want} != k2_want:
        fail(f"{label}: K2's launches by route {routes}, expected {k2_want}")
    check_k3_routes(label, totals, routes, "sm90")
    if torch.device(dev).type == "cuda" and not (
            k2_by_route["fwd"]["sm90"] and k2_by_route["dkv"]["sm90"]
            and k2_by_route["dq"]["sm90"]):
        fail(f"{label}: the profiler saw no device time of a K2 kernel the "
             f"step runs: {k2_by_route}")
    del state, step, params, data
    torch.cuda.empty_cache()
    return totals


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
    full_layers = family_cfg(oc.student_arch).n_layers
    depth = "no width, depth or batch cut" if L == full_layers else \
        f"depth {full_layers} -> {L} per model; no width or batch cut"
    emit({f"{label}_cuts": {
        "clients": list(oc.client_archs), "student": oc.student_arch,
        "n_layers": [full_layers, L], "d_model": cfgs[0].d_model,
        "vocab": cfgs[0].vocab_size, "dtype": cfgs[0].dtype,
        "client_steps": oc.client_steps,
        "client_batch": [ONE.CLIENT_BATCH, oc.client_seq],
        "server_batch": [oc.batch, oc.gen_seq], "nz": oc.nz, "d_g": oc.d_g,
        "epochs": oc.epochs, "t_g": ONE.T_G, "cut": "depth of training: "
        f"3 local steps a client, 2 server epochs; {depth}"}})

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
    check_k2_routes(label, totals, routes, getattr(torch, cfgs[0].dtype),
                    cfgs[0].head_dim)
    # and every K3f launch its route (sm90 for the bfloat16 mamba2 path)
    check_k3_routes(label, totals, routes, k3f_route(torch, cfgs[0]))
    if ledger.rounds != 1 or ledger.downlink_bytes != 0 or \
            ledger.uplink_bytes != sum(param_bytes(p) for p in client_params):
        fail(f"not one-shot: {ledger.rounds} rounds, "
             f"{ledger.downlink_bytes} B down")
    emit({f"{label}_main_path": {
        "arch": oc.student_arch, "card": card(),
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
        "k1_shape": [oc.batch * oc.gen_seq, stu_cfg.vocab_size],
        "fwd_routes": {r: routes[f"fwd_{r}"] for r in ("sm90", "simt")},
        "bwd_routes": {r: routes[f"bwd_{r}"] for r in ("sm90", "simt")},
        "k3f_routes": {r: routes[f"k3f_{r}"] for r in ("sm90", "simt")},
        "k3b_routes": {r: routes[f"k3b_{r}"] for r in ("sm90", "simt")},
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
    busy_ms, summed_ms, _ = profiled_device_ms(torch, prof)
    k2 = {w: sum(v for k, v in per_kernel.items()
                 if f"{w}_kernel<" in k and "ssd_" not in k)
          for w in ("fwd", "dq", "dkv")}
    k2_by_route, k3_by_route = ms_by_route(per_kernel)
    k3 = {w: sum(by.values()) for w, by in k3_by_route.items()}
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
        "card": card(), "epoch_ms": epoch_ms, "device_busy_ms": busy_ms,
        "device_summed_ms": summed_ms,
        "device_idle_share": 1 - busy_ms / epoch_ms,
        "k2_ms": k2, "k2_ms_by_route": k2_by_route,
        "k2_share_of_busy": sum(k2.values()) / busy_ms
        if busy_ms else None, "k3_ms": k3,
        "k3f_ms_by_route": k3_by_route["fwd"],
        "k3b_ms_by_route": k3_by_route["bwd"],
        "k3_share_of_busy": sum(k3.values()) / busy_ms if busy_ms else None,
        "k1_ms": k1_ms,
        "n_kernel_names": len(per_kernel), "kernels_launched": n_kernels,
        "top_kernels_ms": top, "top_host_ops_self_ms_count": host}})
    n_attn, n_mamba = trunk_blocks(stu_cfg)
    if busy_ms == 0 or (n_attn and not all(k2.values())) or (
            n_mamba and not all(k3.values())):
        fail(f"{label}: the profiler saw no device time of a kernel the "
             f"epoch runs: K2 {k2}, K3 {k3}")
    want = k3f_route(torch, stu_cfg) if n_mamba else None
    if n_mamba and any(not by[want] or any(v for r, v in by.items()
                                           if r != want)
                       for by in k3_by_route.values()):
        fail(f"{label}: K3's device time by route {k3_by_route}, "
             f"expected all of it on {want}")


# ---------------------------- the dense-mode families, the audio family --

# ------------------------------------------------- the pod distillation --

# the pod cell at the LLM main path's server batch and llama's vocabulary
POD_BATCH = (4, 256)
POD_KL_CHUNK = 64
POD_STEPS = 3
# chunked against materialized, the first step's loss from the same
# student: the routes round the teacher's logits differently (bf16
# logits widened against a float32 readout of bf16 hidden states); the
# first call on an H100 read 1.74e-6, and this holds it with ~50x room
POD_ROUTE_TOL = 1e-4
# pod_distill_check: llama3.2-3b at full width, depth cut to 1, float32
POD_CHECK = {"n_layers": 1, "batch": (2, 64), "kl_chunk": 32}


def stack_clients(torch, trees: list) -> dict:
    """The clients' parameter trees stacked leaf by leaf on a leading
    client dim; each client's leaf is then replaced by a view of its row,
    so the originals are freed as the stack is built."""
    out = {}
    for k, v in trees[0].items():
        if isinstance(v, dict):
            out[k] = stack_clients(torch, [t[k] for t in trees])
            continue
        out[k] = torch.stack([t[k] for t in trees])
        for i, t in enumerate(trees):
            t[k] = out[k][i]
    return out


def pod_launches(cfg, n: int, materialized: bool) -> dict:
    """One pod distillation step: every client trunk forward, the
    student's forward and its remat recompute (K2f), the student's
    backward (K2q, K2kv), and K1f + K1b in the materialized route."""
    n_attn, _ = trunk_blocks(cfg)
    k1 = 1 if materialized else 0
    return expected(flash_attention_fwd=(n + 2) * n_attn,
                    flash_attention_bwd_dq=n_attn,
                    flash_attention_bwd_dkv=n_attn,
                    distill_kl_fwd=k1, distill_kl_bwd=k1)


class _PeakAtStep:
    """Wraps an optimizer: reads the device's peak allocation when the
    step is called (the loss and its gradient, before the update's own
    temporaries), then steps."""

    def __init__(self, opt):
        self.opt, self.params, self.peak = opt, opt.params, None

    def step(self, grads):
        import torch

        self.peak = torch.cuda.max_memory_allocated()
        self.opt.step(grads)


def pod_distill(torch, ctx, dev="cuda"):
    """``make_pod_distill_step`` (``launch.steps.make_distill_step``) on
    the LLM main path's two trained llama3.2-3b clients and its student,
    bfloat16, at the server batch 4 x 256 of the generator's soft
    embeddings on a one-pod ("data", "model") mesh: the clients' tensors
    stacked (the client list then views the stack), POD_STEPS Adam steps
    of each route from the same student (its weights restored between
    the routes), each step's launches counted (``pod_launches``: K1 in
    the materialized route only, K2f/K2q/K2kv on sm90 in both) and its
    seconds and peak device memory read. The routes' first losses agree
    to POD_ROUTE_TOL. The peak above the resident tensors is read twice:
    at the Adam step (the loss route's own: logits or chunks, and the
    gradients) and over the whole step (the update's float32
    temporaries included). Returns each route's launches over its
    steps."""
    from repro_torch.core.generator import tok_generator
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import axis_sizes, make_host_mesh
    from repro_torch.models import transformer as T

    (_, _, _, s_opt, gen, student, client_params, oc, stu_cfg,
     draws) = ctx
    on_card = torch.device(dev).type == "cuda"
    n, B, S = len(client_params), *POD_BATCH
    t_phase = time.perf_counter()
    stacked, t_stack = timed(torch, dev,
                             lambda: stack_clients(torch, client_params))
    stack_gib = sum(t.numel() * t.element_size()
                    for t in T.leaves(stacked)) / 2 ** 30
    mesh = make_host_mesh(device=dev)
    z = torch.randn((B, oc.nz), generator=draws, device=dev)
    y = torch.randint(0, stu_cfg.vocab_size, (B, S), generator=draws,
                      device=dev)
    with torch.no_grad():
        embeds = tok_generator(gen, z, y[:, 0])
    if tuple(embeds.shape) != (B, S, stu_cfg.d_model):
        fail(f"pod_distill: embeds {tuple(embeds.shape)}, expected "
             f"{(B, S, stu_cfg.d_model)}")
    start = [t.detach().clone() for t in T.leaves(student)]
    at_step = _PeakAtStep(s_opt)
    state = {"params": student, "opt": at_step, "step": 0}
    out, launches = {}, {}
    for route in ("materialized", "chunked"):
        chunked = route == "chunked"
        step = ST.make_distill_step(stu_cfg, mesh, n_clients=n,
                                    s_lr=oc.s_lr, chunked_kl=chunked,
                                    kl_chunk=POD_KL_CHUNK, device=dev)
        with torch.no_grad():
            for t, t0 in zip(T.leaves(student), start):
                t.copy_(t0)
        want = pod_launches(stu_cfg, n, not chunked)
        totals = {k: 0 for k in read_counts()}
        routes = {k: 0 for k in read_routes()}
        secs, losses, peak, above, loss_grad = [], [], [], [], []
        for _ in range(POD_STEPS):
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            zero_counts()
            (_, m), dt = timed(torch, dev,
                               lambda: step(state, stacked, embeds))
            got = read_counts()
            if on_card and got != want:
                fail(f"pod_distill {route}: launches {got}, expected {want}")
            for k, c in got.items():
                totals[k] += c
            for k, c in read_routes().items():
                routes[k] += c
            secs.append(dt)
            losses.append(float(m["dis_loss"]))
            peak.append(_peak_gib(torch))
            above.append((torch.cuda.max_memory_allocated() - resident)
                         / 2 ** 30)
            if on_card:
                loss_grad.append((at_step.peak - resident) / 2 ** 30)
        if on_card:
            check_k2_routes(f"pod_distill {route}", totals, routes,
                            getattr(torch, stu_cfg.dtype), stu_cfg.head_dim)
        if not finite(losses):
            fail(f"pod_distill {route}: losses {losses}")
        launches[route] = totals
        out[route] = {"dis_loss": losses, "seconds": secs,
                      "seconds_median": statistics.median(secs),
                      "peak_mem_gib": peak,
                      "peak_above_resident_gib": above,
                      "peak_at_adam_step_above_resident_gib": loss_grad,
                      "launches_per_step": want,
                      "k2_routes": {k: routes[k] for k in (
                          "fwd_sm90", "fwd_simt", "dq_sm90", "dq_simt",
                          "dkv_sm90", "dkv_simt")}}
    a, b = out["chunked"]["dis_loss"][0], out["materialized"]["dis_loss"][0]
    rel = abs(a - b) / max(abs(b), 1e-30)
    emit({"pod_distill": {
        "card": card(), "arch": stu_cfg.name, "n_clients": n,
        "n_layers": stu_cfg.n_layers, "dtype": stu_cfg.dtype,
        "batch": [B, S], "kl_chunk": POD_KL_CHUNK, "steps": POD_STEPS,
        "mesh": axis_sizes(mesh),
        "params_per_model": sum(t.numel() for t in T.leaves(student)),
        "stack_gib": stack_gib, "stack_seconds": t_stack,
        "materialized_logits_gib": B * S * stu_cfg.vocab_size * 4 / 2 ** 30,
        "routes": out, "first_loss_rel_diff": rel, "tol": POD_ROUTE_TOL,
        "seconds_total": time.perf_counter() - t_phase}})
    if rel > POD_ROUTE_TOL:
        fail(f"pod_distill: the chunked route's loss {a} against the "
             f"materialized route's {b} ({rel} > {POD_ROUTE_TOL})")
    return launches


def pod_distill_check(torch, devices=("cuda", "cpu")):
    """One pod distillation step of each route on the card and on the
    CPU, float32 without TF32, llama3.2-3b at full width cut to
    POD_CHECK's depth and batch, two clients, from the same weights and
    embeddings: the losses and the student's gradients agree to
    STEP_TOL (relative, and of each tensor's largest entry), as
    dense_llm_check holds LLM DENSE; the card's launches are counted."""
    from repro_torch.core import dense_llm as DL
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = family_cfg("llama3.2-3b", n_layers=POD_CHECK["n_layers"],
                     dtype="float32")
    init = torch.Generator().manual_seed(31)
    clients = [T.init_model(cfg, generator=init, device="cpu")
               for _ in range(2)]
    stacked0 = stack_clients(torch, clients)
    stu0 = T.init_model(cfg, generator=init, device="cpu")
    B, S = POD_CHECK["batch"]
    embeds0 = torch.randn((B, S, cfg.d_model), generator=init)
    res = {}
    for dev in devices:
        stacked = _tree_to(stacked0, device=dev)
        embeds = embeds0.to(dev)
        for chunked in (False, True):
            step = DL.make_pod_distill_step(
                cfg, None, n_clients=2, chunked_kl=chunked,
                kl_chunk=POD_CHECK["kl_chunk"], device=dev)
            state = step.make_state(_tree_to(stu0, device=dev))
            state["opt"] = _Capture(state["opt"].params)
            zero_counts()
            _, m = step(state, stacked, embeds)
            sync(torch, dev)
            res[dev, chunked] = (float(m["dis_loss"]), state["opt"].grads,
                                 read_counts(), read_routes())
            del state, step
        del stacked
    out = {}
    for chunked in (False, True):
        (la, ga, ca, ra), (lb, gb, _, _) = (res[d, chunked] for d in devices)
        route = "chunked" if chunked else "materialized"
        out[route] = {"loss_cuda": la, "loss_cpu": lb,
                      "loss_rel_err": abs(la - lb) / max(abs(lb), 1e-30),
                      "grad_max_err_rel_to_max": max(
                          _grad_err(a, b) for a, b in zip(ga, gb)),
                      "launches_cuda": {k: v for k, v in ca.items() if v},
                      "k2_routes_cuda": {k: v for k, v in ra.items()
                                         if v and k.split("_")[0] in (
                                             "fwd", "dq", "dkv")}}
        want = pod_launches(cfg, 2, not chunked)
        if torch.device(devices[0]).type != "cuda":
            continue                # a CPU rehearsal launches nothing
        if ca != want:
            fail(f"pod_distill_check {route}: launches {ca}, expected "
                 f"{want}")
        check_k2_routes(f"pod_distill_check {route}", ca, ra,
                        torch.float32, cfg.head_dim)
    emit({"pod_distill_check": {
        "arch": cfg.name, "n_layers": cfg.n_layers, "batch": [B, S],
        "kl_chunk": POD_CHECK["kl_chunk"], "dtype": "float32",
        "routes": out, "tol": STEP_TOL,
        "seconds_total": time.perf_counter() - t_phase}})
    bad = {r: v for r, v in out.items()
           if max(v["loss_rel_err"], v["grad_max_err_rel_to_max"])
           > STEP_TOL}
    if bad:
        fail(f"pod_distill_check: the card disagrees with the CPU: {bad}")


# the paged attention families at full width, depth 2 (serve_check): the
# audio family's K4 at D 64 beside qwen1.5-4b's and phi3-medium-14b's D 128
PAGED_CHECK_ARCHS = ("musicgen-large", "qwen1.5-4b", "phi3-medium-14b")
# (arch, depth or None for the full one): the dense-mode engine in
# bfloat16; deepseek-v2-236b's 60 layers (471 GB in bfloat16) cut to 4:
# its dense-MLP layer 0 and three MoE layers, 12.8 B parameters
FAMILY_SERVE = (("gemma3-4b", None), ("llama3.2-vision-11b", None),
                ("deepseek-v2-lite-16b", None), ("deepseek-v2-236b", 4))
FAMILY_SERVE_NEW = 16
GEMMA3_LONG_PROMPT = 1536     # past gemma3's 1024-token window
# (arch, depth, prefill tokens): card against CPU in float32, each with 4
# teacher-forced decode steps after the prefill. gemma3 at depth 6 has
# five local layers and one global, and 1040 tokens pass its window; a
# vlm super-block is four self layers and a cross layer
FAMILY_CHECKS = (("gemma3-4b", 6, 1040), ("deepseek-v2-lite-16b", 2, 96),
                 ("llama3.2-vision-11b", 5, 96))
FAMILY_DECODE_STEPS = 4
# float32 logits, of the largest |logit|: the card against the CPU, and
# the blockwise prefill against the materialized one (summation order
# only); family_check also shows the float32 floor (float32 against a
# float64 run on the card) to lie below it
FAMILY_TOL = 1e-4
BLOCKWISE_TOL = 1e-4
LONG_PREFILL = (("gemma3-4b", 6), ("deepseek-v2-lite-16b", 2))
LONG_PREFILL_TOKENS = 4096
# llama-3.2-vision-11b at full width, one super-block, bfloat16, no cache
VLM_KERNEL_BATCH = (2, 256)


def family_cfg(arch, n_layers=None, dtype=None):
    """``arch``'s full-width config, its depth cut to ``n_layers`` and
    its compute and parameter dtype set where given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    return cfg


def _tree_to(tree, **kw):
    return {k: _tree_to(v, **kw) if isinstance(v, dict) else v.to(**kw)
            for k, v in tree.items()}


def vlm_inputs(torch, cfg, params, batch: int, dev, seed: int = 0):
    """Random patch embeddings (batch, n_patches, vision_dim) in
    ``cfg.dtype``, and the vlm's two gates (zero at init, so the cross
    blocks would add nothing) set non-zero, in place."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_super = params["cross"]["mlp_gate"].shape[0]
    for name, tree, lo in (("mlp_gate", params["cross"], 0.6),
                           ("gate", params["cross"]["xattn"], -0.7)):
        tree[name].copy_(torch.linspace(lo, -lo, n_super, device=dev))
    return torch.randn(batch, cfg.n_patches, cfg.vision_dim, generator=gen,
                       device=dev).to(getattr(torch, cfg.dtype))


def _logits_of(torch, params, cfg, toks, vision, steps, dev):
    """Prefill ``toks[:, :-steps]`` into a cache, then ``steps``
    teacher-forced decode steps: the logits of every position, float32
    on the CPU."""
    from repro_torch.models import transformer as T

    S = toks.shape[1] - steps
    t = toks.to(dev)
    v = None if vision is None else vision.to(dev)
    with torch.inference_mode():
        cache = T.init_cache(cfg, 1, S + steps, device=dev)
        lg, cache = T.forward(params, cfg, tokens=t[:, :S], cache=cache,
                              cache_pos=0, vision=v)
        out = [lg.float().cpu()]
        for i in range(S, S + steps):
            lg, cache = T.forward(
                params, cfg, tokens=t[:, i:i + 1],
                positions=torch.tensor([i], dtype=torch.int32, device=dev),
                cache=cache, cache_pos=i, vision=v, decode=True)
            out.append(lg.float().cpu())
    return torch.cat(out, dim=1)


def family_check(torch, dev="cuda", checks=FAMILY_CHECKS,
                 steps=FAMILY_DECODE_STEPS):
    """The dense-mode families at full width, their depth cut, float32
    without TF32: the card's logits (a prefill past gemma3's window, then
    teacher-forced decode steps) against the CPU's on the same weights
    and inputs, within ``FAMILY_TOL`` of the largest |logit|; the float32
    floor (the card's float32 against its float64 run) must lie below
    that tolerance. The CPU path is held to the JAX package by
    tests/test_torch_families.py."""
    import numpy as np

    from repro_torch.models import transformer as T

    rows = []
    for arch, n_layers, S in checks:
        t0 = time.perf_counter()
        cfg = family_cfg(arch, n_layers, "float32")
        params = T.init_model(cfg, seed=2, device=dev)
        vision = vlm_inputs(torch, cfg, params, 1, dev, seed=2) \
            if cfg.family == "vlm" else None
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (1, S + steps)))
        zero_counts()
        card = _logits_of(torch, params, cfg, toks, vision, steps, dev)
        launches = read_counts()
        cfg64 = cfg.replace(dtype="float64", param_dtype="float64")
        exact = _logits_of(torch, _tree_to(params, dtype=torch.float64),
                           cfg64, toks, vision, steps, dev)
        cpu_params = _tree_to(params, device="cpu")
        del params
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cpu = _logits_of(torch, cpu_params, cfg, toks,
                         None if vision is None else vision.cpu(), steps,
                         "cpu")
        cpu_s = time.perf_counter() - t1
        err, floor = _rel_max(card, cpu), _rel_max(card, exact.float())
        row = {"arch": arch, "family": cfg.family, "d_model": cfg.d_model,
               "vocab": cfg.vocab_size,
               "n_layers": [get_full_layers(arch), n_layers],
               "windows": T.layer_windows(cfg) if cfg.sliding_window
               else None, "prefill_tokens": S, "decode_steps": steps,
               "max_err_rel_to_max": err,
               "float32_floor_rel_to_max": floor,
               "cpu_float32_vs_float64": _rel_max(cpu, exact.float()),
               "tol": FAMILY_TOL, "launches": launches,
               "finite": bool(torch.isfinite(card).all()),
               "seconds": time.perf_counter() - t0, "cpu_seconds": cpu_s}
        row["ok"] = bool(row["finite"] and err <= FAMILY_TOL
                         and floor < FAMILY_TOL
                         and launches == expected())
        rows.append(row)
        emit({"family_check": row})
        del cpu_params, card, cpu, exact
    bad = [r["arch"] for r in rows if not r["ok"]]
    if bad:
        fail(f"family_check: the card disagrees with the CPU (or the "
             f"float32 floor reaches {FAMILY_TOL}, or a kernel launched) "
             f"for {bad}")


def get_full_layers(arch) -> int:
    return family_cfg(arch).n_layers


def long_prefill(torch, dev="cuda", checks=LONG_PREFILL,
                 S=LONG_PREFILL_TOKENS):
    """A 4096-token prefill through the blockwise path (1024 x 1024
    blocks: gemma3's window inside them, MLA's concatenated keys) against
    the materialized one (``use_blockwise_attn=False``), float32, without
    a cache and into one of 4096 tokens; each timed."""
    import numpy as np

    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T

    rows = []
    for arch, n_layers in checks:
        cfg = family_cfg(arch, n_layers, "float32")
        if not A._blockwise(cfg, S, S):
            fail(f"long_prefill: {arch} would not take the blockwise path "
                 f"at S = {S}")
        params = T.init_model(cfg, seed=3, device=dev)
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (1, S))).to(dev)
        row = {"arch": arch, "n_layers": [get_full_layers(arch), n_layers],
               "tokens": S, "blocks": [cfg.attn_block_q, cfg.attn_block_kv],
               "tol": BLOCKWISE_TOL}
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        for cache in (False, True):
            out = {}
            for name, c in (("blockwise", cfg), ("materialized", cfg.replace(
                    use_blockwise_attn=False))):
                with torch.inference_mode():
                    kw = {"cache": T.init_cache(c, 1, S, device=dev),
                          "cache_pos": 0} if cache else {}
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out[name], _ = T.forward(params, c, tokens=toks, **kw)
                    torch.cuda.synchronize()
                    row[f"{name}{'_cache' if cache else ''}_s"] = \
                        time.perf_counter() - t0
            key = "max_err_rel_to_max" + ("_cache" if cache else "")
            row[key] = _rel_max(out["blockwise"].float(),
                                out["materialized"].float())
            del out
        row["launches"] = read_counts()
        row["peak_mem_gib"] = _peak_gib(torch)
        row["ok"] = bool(row["max_err_rel_to_max"] <= BLOCKWISE_TOL
                         and row["max_err_rel_to_max_cache"] <= BLOCKWISE_TOL
                         and row["launches"] == expected())
        rows.append(row)
        emit({"long_prefill": row})
        del params
        torch.cuda.empty_cache()
    bad = [r["arch"] for r in rows if not r["ok"]]
    if bad:
        fail(f"long_prefill: the blockwise prefill disagrees with the "
             f"materialized one for {bad}")


def family_serve(torch, dev="cuda", models=FAMILY_SERVE,
                 new=FAMILY_SERVE_NEW, long_prompt=GEMMA3_LONG_PROMPT):
    """The dense-mode engine (the default for these families) at full
    width, bfloat16, random weights: four requests each (prompts of
    64–448 tokens, gemma3's first one ``long_prompt``), ``new`` tokens
    each. Every logit row sampled must be finite and no K2, K3 or K4
    launch (prefill with a cache and decode attend on the plain path, as
    in the reference)."""
    import numpy as np

    from repro_torch.launch.engine import ServeEngine
    from repro_torch.models import transformer as T

    class Checked(ServeEngine):
        finite = True

        def _sample(self, req, logits_row):
            self.finite &= bool(torch.isfinite(logits_row).all())
            return super()._sample(req, logits_row)

    out = {}
    for arch, n_layers in models:
        cfg = family_cfg(arch, n_layers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = T.init_model(cfg, seed=0, device=dev)
        sync(torch, dev)
        t_init = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(params))
        reqs = serve_requests(np.random.default_rng(4), 4, cfg.vocab_size,
                              (64, 449), (new, new + 1))
        if cfg.sliding_window:
            reqs[0] = (np.random.default_rng(5).integers(
                0, cfg.vocab_size, long_prompt, dtype="int32"), new)
        eng = Checked(cfg, params, max_reqs=4,
                      max_len=max(len(p) for p, _ in reqs) + new, device=dev)
        zero_counts()
        sync(torch, dev)
        t0 = time.perf_counter()
        streams = run_engine(eng, reqs)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        st = eng.stats
        row = {"arch": arch, "family": cfg.family, "mode": eng.mode,
               "n_layers": [get_full_layers(arch), cfg.n_layers],
               "d_model": cfg.d_model, "vocab": cfg.vocab_size,
               "attention": cfg.attention_kind, "params": n_params,
               "param_count": cfg.param_count(),
               "prompt_lens": [len(p) for p, _ in reqs], "max_new": new,
               "init_s": t_init, "wall_s": wall,
               "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
               "decode_steps": st["decode_steps"],
               "ms_per_decode_step": st["decode_s"]
               / max(st["decode_steps"], 1) * 1e3,
               "decode_tok_per_s": st["decode_steps"] / st["decode_s"],
               "logits_finite": eng.finite, "launches": read_counts(),
               "peak_mem_gib": _peak_gib(torch),
               "tokens_first_request": streams[0].tolist()}
        row["ok"] = bool(eng.mode == "dense" and eng.finite
                         and row["launches"] == expected()
                         and all(len(s) == new for s in streams))
        emit({"family_serve": row})
        out[arch] = row
        del eng, params
        torch.cuda.empty_cache()
    bad = [a for a, r in out.items() if not r["ok"]]
    if bad:
        fail(f"family_serve: non-finite logits, a kernel launch or short "
             f"streams for {bad}")
    return out


def vlm_kernel_check(torch, dev="cuda", batch=VLM_KERNEL_BATCH):
    """llama-3.2-vision-11b at full width, one super-block (four self
    layers, one cross layer), bfloat16, no cache, random patch embeddings
    and both gates non-zero: the kernel profile runs K2f on ``sm90`` at
    D 128 once a self layer; its logits are no further from a float32
    run's than twice the plain bfloat16 route's are."""
    import numpy as np

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T

    cfg = family_cfg("llama3.2-vision-11b", 5)
    n_self = T.vlm_shape(cfg)[0] * cfg.cross_every
    params = T.init_model(cfg, seed=5, device=dev)
    B, S = batch
    vision = vlm_inputs(torch, cfg, params, B, dev, seed=5)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    out, ms = {}, {}
    for route in ("fused", "ref"):
        c = cfg.replace(kernel_vjp_mode=route)
        with torch.inference_mode():
            zero_counts()
            out[route], _ = T.forward(params, c, tokens=toks, vision=vision)
            if route == "fused":
                launches, routes = read_counts(), read_routes()
            ms[route] = cuda_ms(torch, lambda: T.forward(
                params, c, tokens=toks, vision=vision), samples=5)
    c32 = cfg.replace(dtype="float32", param_dtype="float32",
                      kernel_vjp_mode="ref")
    with torch.inference_mode():
        exact, _ = T.forward(_tree_to(params, dtype=torch.float32), c32,
                             tokens=toks, vision=vision.float())
    err_kernel = _rel_max(out["fused"].float(), exact)
    err_plain = _rel_max(out["ref"].float(), exact)
    want = expected(flash_attention_fwd=n_self)
    ok_routes = routes["fwd_sm90"] == n_self and routes["fwd_simt"] == 0
    row = {"arch": cfg.name, "n_layers": [get_full_layers(cfg.name), 5],
           "batch": [B, S], "dtype": cfg.dtype, "head_dim": cfg.head_dim,
           "k2f_route": FA.route("fwd", torch.bfloat16, cfg.head_dim),
           "launches": launches, "expected_launches": want,
           "fwd_routes": {r: routes[f"fwd_{r}"] for r in ("sm90", "simt")},
           "kernel_vs_float32_rel_to_max": err_kernel,
           "plain_vs_float32_rel_to_max": err_plain,
           "kernel_vs_plain_rel_to_max": _rel_max(out["fused"].float(),
                                                  out["ref"].float()),
           "limit": "kernel <= 2 x plain", "forward_ms": ms,
           "finite": bool(torch.isfinite(out["fused"]).all())}
    emit({"vlm_kernel_check": row})
    if launches != want or not ok_routes:
        fail(f"vlm_kernel_check: K2f launches {launches} by route "
             f"{row['fwd_routes']}, expected {n_self} on sm90")
    if not row["finite"] or err_kernel > 2 * err_plain:
        fail(f"vlm_kernel_check: the K2 route is {err_kernel} from float32, "
             f"the plain route {err_plain}")
    del params, exact, out
    torch.cuda.empty_cache()
    return launches


def family_phases(torch, dev="cuda"):
    """serve_check on the paged attention families, audio_serve (and its
    profiled decode step), family_serve, family_check, long_prefill and
    vlm_kernel_check. Returns (audio_serve's launches,
    vlm_kernel_check's)."""
    for arch in PAGED_CHECK_ARCHS:
        serve_check(torch, dev, arch=arch)
    audio = serve_main_path(torch, dev, arch="musicgen-large",
                            label="audio_serve")
    family_serve(torch, dev)
    family_check(torch, dev)
    long_prefill(torch, dev)
    return audio, vlm_kernel_check(torch, dev)


# ------------------- training the dense-mode families; LLM DENSE with moe --

# (arch, depth or None for the full one): launch.train.train in bfloat16 at
# full width, FAMILY_TRAIN_STEPS steps of FAMILY_TRAIN_BATCH each. gemma3-4b
# at full depth (34 layers, 3.88 B parameters: ~47 GB of bfloat16 weights
# and gradients and float32 Adam moments); deepseek-v2-lite-16b 27 -> 6
# (3.22 B); llama3.2-vision-11b 40 -> 10, two super-blocks (2.71 B)
FAMILY_TRAIN = (("gemma3-4b", None), ("deepseek-v2-lite-16b", 6),
                ("llama3.2-vision-11b", 10))
FAMILY_TRAIN_STEPS = 3
FAMILY_TRAIN_BATCH = (4, 256)
# deepseek-v2-236b 60 -> 2 (4.8 B parameters): its float32 Adam moments
# alone are 38.6 GB beside 19.4 GB of bfloat16 weights and gradients and
# Adam's per-expert temporaries, more than an 80 GB card holds with a
# margin; so one bfloat16 loss and gradient, no optimizer step
FAMILY_GRAD_ONLY = ("deepseek-v2-236b", 2, (2, 128))
# (arch, depth, (batch, seq)): the train step's loss and gradients on the
# card against the CPU, float32 without TF32. gemma3-4b at depth 6 (five
# local layers, one global) over 1040 tokens, past its 1024 window;
# deepseek-v2-lite-16b at depth 2 with the capacity factor cut to
# FAMILY_TRAIN_CAPACITY, so that its 64 experts' slots (64 x 8) are fewer
# than the 128 x 6 assignments and tokens drop; llama3.2-vision-11b one
# super-block, random patch embeddings, both gates non-zero
FAMILY_TRAIN_CHECKS = (("gemma3-4b", 6, (1, 1040)),
                       ("deepseek-v2-lite-16b", 2, (1, 128)),
                       ("llama3.2-vision-11b", 5, (1, 128)))
FAMILY_TRAIN_CAPACITY = 0.5
# every gradient tensor, of its largest entry, and the loss, relative
FAMILY_TRAIN_TOL = 1e-4
# full_moe() at depth 27 -> 3 per model (1.47 B parameters each: layer 0
# and two MoE layers). Cuts to keep the script inside its time: depth 4 ->
# 3 here, and 256 -> 128 tokens in family_train_check's lite and vision
# runs (a whole-script call on a slow host read 1058 s at 4 and 256)
MOE_LLM_LAYERS = 3


def _lm_batch(torch, cfg, batch, dev, seed):
    """One (batch, seq) window of the LM stream at ``cfg``'s vocabulary."""
    from repro_torch.data import lm_batches, make_lm_data

    toks = make_lm_data(seed, vocab=cfg.vocab_size, n_tokens=200_000)
    x, y = next(lm_batches(toks, batch[0], batch[1], seed=seed, steps=1))
    return {"tokens": torch.from_numpy(x).to(dev),
            "labels": torch.from_numpy(y).to(dev)}


def _loss_and_grads(torch, params, cfg, batch):
    """loss_fn over ``batch`` and its gradient with respect to every
    parameter, no update: (loss, moe_aux, gradients in ``leaves``
    order)."""
    from repro_torch.models import transformer as T

    leaves = T.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, parts = T.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return (float(loss.detach()), float(parts["moe_aux"].detach()),
            [g.detach() for g in grads])


def _k2_on_sm90(torch, cfg) -> bool:
    from repro_torch.kernels import flash_attention as FA

    return all(FA.route(w, getattr(torch, cfg.dtype), cfg.head_dim)
               == "sm90" for w in ("fwd", "dq", "dkv"))


def family_train(torch, dev="cuda", models=FAMILY_TRAIN,
                 steps=FAMILY_TRAIN_STEPS, batch=FAMILY_TRAIN_BATCH,
                 grad_only=FAMILY_GRAD_ONLY):
    """``launch.train.train`` on the families the reference trains and the
    engine serves in dense mode, bfloat16 at full width, ``steps`` steps
    of ``batch`` from random weights: every step's loss and grad_norm
    finite and > 0, moe_aux > 0 for the moe arch, seconds a step and peak
    memory. Counted over the steps: the vlm's self layers run K2f twice a
    step (the forward and its recomputation under remat), K2q and K2kv
    once, all on ``sm90`` at D 128 (8 self layers: 16, 8 and 8 a step);
    gemma3 (its window pattern) and MLA launch no K2. Then deepseek-v2-236b
    (``grad_only``): one bfloat16 loss and gradient. Returns the vlm's
    launches."""
    import math

    from repro_torch import optim
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as T

    vlm = None
    for arch, n_layers in models:
        cfg = family_cfg(arch, n_layers)
        per_step = train_launches(cfg)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        state, hist = train(arch, steps=steps, batch=batch[0], seq=batch[1],
                            smoke=False, n_layers=n_layers,
                            log_every=10 ** 9, device=dev)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        launches, routes = read_counts(), read_routes()
        n_params = sum(t.numel() for t in T.leaves(state["params"]))
        del state
        torch.cuda.empty_cache()
        totals = {k: c * steps for k, c in per_step.items()}
        row = {"arch": arch, "family": cfg.family, "card": card(),
               "n_layers": [get_full_layers(arch), cfg.n_layers],
               "d_model": cfg.d_model, "vocab": cfg.vocab_size,
               "dtype": cfg.dtype, "remat": cfg.remat,
               "window_pattern": T.layer_windows(cfg)
               if cfg.sliding_window else None,
               "attention": cfg.attention_kind, "params": n_params,
               "batch": list(batch), "steps": steps,
               "loss": [h["loss"] for h in hist],
               "grad_norm": [h["grad_norm"] for h in hist],
               "moe_aux": [h["moe_aux"] for h in hist],
               "seconds": [h["seconds"] for h in hist],
               "seconds_per_step_median": statistics.median(
                   h["seconds"] for h in hist[1:] or hist),
               "wall_s": wall, "peak_mem_gib": _peak_gib(torch),
               "launches_per_step": per_step, "launches": launches,
               "k2_routes": {kind: {r: routes[f"{kind}_{r}"]
                                    for r in ("sm90", "simt")}
                             for kind in ("fwd", "dq", "dkv")}}
        emit({"family_train": row})
        vals = row["loss"] + row["grad_norm"]
        if len(hist) != steps or not all(
                math.isfinite(v) and v > 0 for v in vals):
            fail(f"family_train: {arch}'s losses {row['loss']} or grad norms "
                 f"{row['grad_norm']} are not all finite and > 0")
        if cfg.n_experts and not all(v > 0 for v in row["moe_aux"]):
            fail(f"family_train: {arch}'s moe_aux {row['moe_aux']}")
        if launches != totals:
            fail(f"family_train: {arch} launched {launches}, expected "
                 f"{totals}")
        check_k2_routes(f"family_train {arch}", launches, routes,
                        getattr(torch, cfg.dtype), cfg.head_dim)
        if cfg.family == "vlm":
            if not (totals["flash_attention_fwd"] and _k2_on_sm90(torch,
                                                                  cfg)):
                fail(f"family_train: {arch}'s self layers do not take K2 on "
                     f"sm90: {totals}")
            vlm = launches

    arch, n_layers, gb = grad_only
    cfg = family_cfg(arch, n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_model(cfg, seed=0, device=dev)
    data = _lm_batch(torch, cfg, gb, dev, seed=0)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in T.leaves(params))
    zero_counts()
    t0 = time.perf_counter()
    loss, aux, grads = _loss_and_grads(torch, params, cfg, data)
    gnorm = float(optim.global_norm(grads))
    sync(torch, dev)
    row = {"arch": arch, "family": cfg.family, "card": card(),
           "n_layers": [get_full_layers(arch), cfg.n_layers],
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "dtype": cfg.dtype, "params": n_params, "batch": list(gb),
           "loss": loss, "grad_norm": gnorm, "moe_aux": aux,
           "seconds": time.perf_counter() - t0, "init_s": init_s,
           "peak_mem_gib": _peak_gib(torch), "launches": read_counts(),
           "cuts": "depth 60 -> 2 (layer 0 and one MoE layer); one loss "
           "and gradient, no optimizer step: float32 Adam moments of 4.8 B "
           "parameters (38.6 GB) beside bfloat16 weights and gradients "
           "(19.4 GB) and Adam's per-expert temporaries leave no margin "
           "on an 80 GB card"}
    emit({"family_train": row})
    del params, grads
    torch.cuda.empty_cache()
    if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0
            and aux > 0) or row["launches"] != expected():
        fail(f"family_train: {arch}'s loss {loss}, grad_norm {gnorm}, "
             f"moe_aux {aux}, launches {row['launches']}")
    return vlm


def family_train_check(torch, dev="cuda", checks=FAMILY_TRAIN_CHECKS,
                       tol=FAMILY_TRAIN_TOL):
    """The train step's loss and every gradient at full width, depth cut,
    float32 without TF32, on the card against the CPU, from the same
    weights and batch, within ``tol`` of each tensor's largest entry; the
    float32 floor (the card's float32 against its float64 run, on the
    plain route) must lie below ``tol``. The vlm's gradients on the kernel
    route (float32 K2f, K2q and K2kv on ``sm90``, counted) are also held
    to the plain route's on the card. The CPU path is held to the JAX
    package by tests/test_torch_family_train.py. Reports the host's peak
    resident memory, which the CPU runs set."""
    import resource

    from repro_torch.models import transformer as T

    def errs(a, b):
        return sorted(((_rel_max(x.float(), y.float()), name)
                       for x, y, name in zip(a, b, names)), reverse=True)

    rows = []
    for arch, n_layers, batch in checks:
        t0 = time.perf_counter()
        cfg = family_cfg(arch, n_layers, "float32")
        if cfg.n_experts:
            cfg = cfg.replace(capacity_factor=FAMILY_TRAIN_CAPACITY)
        params = T.init_model(cfg, seed=4, device=dev)
        names = _leaf_paths(params)
        data = _lm_batch(torch, cfg, batch, dev, seed=4)
        if cfg.family == "vlm":
            data["vision"] = vlm_inputs(torch, cfg, params, batch[0], dev,
                                        seed=4)
        row = {"arch": arch, "family": cfg.family, "card": card(),
               "d_model": cfg.d_model, "vocab": cfg.vocab_size,
               "n_layers": [get_full_layers(arch), n_layers],
               "batch": list(batch), "tol": tol}
        if cfg.sliding_window:
            row["windows"] = T.layer_windows(cfg)
        if cfg.n_experts:
            from repro_torch.models.moe import _capacity
            n_tok = batch[0] * batch[1]
            row["capacity"] = {"factor": cfg.capacity_factor,
                               "slots": cfg.n_experts * _capacity(n_tok,
                                                                  cfg),
                               "assignments": n_tok * cfg.top_k}
        zero_counts()
        got = _loss_and_grads(torch, params, cfg, data)
        sync(torch, dev)
        launches, routes = read_counts(), read_routes()
        want = train_launches(cfg)
        row["launches"] = launches
        ok = launches == want
        if cfg.family == "vlm":
            plain = _loss_and_grads(torch, params, cfg.replace(
                kernel_vjp_mode="ref"), data)
            e = errs(got[2], plain[2])
            row["kernel_vs_plain"] = {
                "loss_rel_err": abs(got[0] - plain[0]) / abs(plain[0]),
                "grads_max_err_rel_to_max": e[0][0], "worst": e[:4]}
            row["k2_routes"] = {kind: {r: routes[f"{kind}_{r}"]
                                       for r in ("sm90", "simt")}
                                for kind in ("fwd", "dq", "dkv")}
            ok &= bool(launches["flash_attention_fwd"]
                       and _k2_on_sm90(torch, cfg)
                       and routes["fwd_sm90"] == want["flash_attention_fwd"]
                       and routes["dq_sm90"] == want["flash_attention_bwd_dq"]
                       and routes["dkv_sm90"]
                       == want["flash_attention_bwd_dkv"]
                       and max(row["kernel_vs_plain"]["loss_rel_err"],
                               e[0][0]) <= tol)
            del plain
        p64 = _tree_to(params, dtype=torch.float64)
        d64 = {k: v.double() if v.is_floating_point() else v
               for k, v in data.items()}
        exact = _loss_and_grads(torch, p64, cfg.replace(
            dtype="float64", param_dtype="float64", kernel_vjp_mode="ref"),
            d64)
        floor = errs(got[2], exact[2])
        row["float32_floor_rel_to_max"] = floor[0][0]
        row["float32_floor_loss"] = abs(got[0] - exact[0]) / abs(exact[0])
        del p64, d64, exact
        card_loss, card_aux = got[0], got[1]
        card_grads = [g.cpu() for g in got[2]]
        cpu_params = _tree_to(params, device="cpu")
        cpu_data = {k: v.cpu() for k, v in data.items()}
        del params, data, got
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        # the CPU recomputes nothing: remat changes no number, only time
        cpu = _loss_and_grads(torch, cpu_params, cfg.replace(remat=False),
                              cpu_data)
        row["cpu_seconds"] = time.perf_counter() - t1
        e = errs(card_grads, cpu[2])
        loss_err = abs(card_loss - cpu[0]) / abs(cpu[0])
        row.update({
            "loss": [card_loss, cpu[0]], "loss_rel_err": loss_err,
            "moe_aux": [card_aux, cpu[1]],
            "grads_max_err_rel_to_max": e[0][0], "worst_grads": e[:6],
            "host_peak_rss_gib": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
            "seconds": time.perf_counter() - t0})
        row["ok"] = bool(ok and max(loss_err, e[0][0]) <= tol
                         and max(floor[0][0], row["float32_floor_loss"])
                         < tol and (not cfg.n_experts or card_aux > 0))
        rows.append(row)
        emit({"family_train_check": row})
        del cpu_params, cpu, card_grads
    bad = [r["arch"] for r in rows if not r["ok"]]
    if bad:
        fail(f"family_train_check: the card's train step disagrees with the "
             f"CPU's or the plain route's, the float32 floor reaches {tol}, "
             f"or K2 launched off its count or route, for {bad}")


def moe_llm_main_path(torch, dev="cuda", n_layers=MOE_LLM_LAYERS):
    """LLM DENSE with the moe family: ``dense_llm_oneshot.full_moe()``
    (two deepseek-v2-lite-16b clients and a lite student, bfloat16, full
    width) at depth 27 -> ``n_layers`` a model, counted step by step as
    llm_main_path counts: no K2 (MLA attends on the plain path), and K1f
    and K1b once a server step at (batch·gen_seq, 102400), one pair for
    each L_div of the t_g generator steps and each L_dis of the student
    step: 4 pairs an epoch, 8 in the 2 epochs. Then one epoch under
    ``torch.profiler``: K1's device time and the idle share. Returns the
    path's launches."""
    from repro_torch.launch import dense_llm_oneshot as ONE

    oc = dataclasses.replace(ONE.full_moe(), n_layers=n_layers)
    totals, ctx = llm_main_path(torch, dev, oc=oc, label="moe_llm")
    stu_cfg = ctx[8]
    pairs = oc.epochs * (ONE.T_G + 1)
    shape = (oc.batch * oc.gen_seq, stu_cfg.vocab_size)
    want = expected(distill_kl_fwd=pairs, distill_kl_bwd=pairs)
    if totals != want or shape != (1024, 102400):
        fail(f"moe_llm_main_path: launches {totals} at K1 shape {shape}, "
             f"expected {want} at (1024, 102400)")
    profile_llm_epoch(torch, ctx, dev, label="profile_moe_llm_epoch")
    del ctx
    torch.cuda.empty_cache()
    return totals


# ----------------------------------------------------------- model axis --

MODEL_AXIS_ARCH = "deepseek-v2-lite-16b"
MODEL_AXIS_WORLD = 2
# layer 0 (a dense MLP) and two MoE layers, 32 of the 64 experts a rank
MODEL_AXIS_LAYERS = 3
MODEL_AXIS_STEPS = 3
MODEL_AXIS_BATCH = (2, 128)
# requests, prompt tokens, new tokens (greedy)
MODEL_AXIS_REQUESTS = (4, 32, 16)
MODEL_AXIS_TOL = FAMILY_TRAIN_TOL
# the updated parameters lie within the larger of MODEL_AXIS_TOL and this
# many times the float32 floor: how far two one-rank runs of the same
# program lie from each other (3.2e-4 of the embedding's largest entry
# after 3 Adam steps on an H100, scripts/model_axis_floor.py: Adam's
# update turns the float32 noise of near-zero gradients into a change of
# a whole step on a few entries); the Adam moments within MODEL_AXIS_TOL
MODEL_AXIS_FLOOR_FACTOR = 2
# the spawned world's seconds before it is killed and the phase fails
MODEL_AXIS_DEADLINE = 300


def _axis_cfg():
    from repro_torch.configs import get_config

    return get_config(MODEL_AXIS_ARCH).replace(
        n_layers=MODEL_AXIS_LAYERS, dtype="float32", param_dtype="float32")


def _axis_part(torch, dev, fn):
    """(fn(), its record: seconds and this rank's peak GiB)."""
    on_card = torch.device(dev).type == "cuda"
    sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    sync(torch, dev)
    return out, {"seconds": time.perf_counter() - t0,
                 "peak_gib": _peak_gib(torch) if on_card else None}


def _axis_train(torch, model_parallel, dev):
    """``launch.train.train`` at ``model_parallel``: (history, this rank's
    parameters and Adam's first moments, each a tree)."""
    from repro_torch.launch.train import train

    state, hist = train(MODEL_AXIS_ARCH, steps=MODEL_AXIS_STEPS,
                        batch=MODEL_AXIS_BATCH[0], seq=MODEL_AXIS_BATCH[1],
                        smoke=False, model_parallel=model_parallel,
                        n_layers=MODEL_AXIS_LAYERS, dtype="float32",
                        log_every=10 ** 6, device=dev)
    return ([{k: v for k, v in h.items() if k != "seconds"} for h in hist],
            state["params"], _tree_from(state["params"], state["opt"].m))


def _tree_from(like: dict, flat: list) -> dict:
    """``flat`` (in ``transformer.leaves`` order) in ``like``'s tree."""
    it = iter(flat)

    def build(tree):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in tree.items()}

    return build(like)


def _to_host(tree: dict) -> dict:
    return {k: _to_host(v) if isinstance(v, dict) else v.detach().cpu()
            for k, v in tree.items()}


def _axis_engine(torch, mesh, dev):
    """The dense engine on ``mesh``: the greedy streams of
    MODEL_AXIS_REQUESTS and the first decode step's logits (float32)."""
    from repro_torch.launch.engine import ServeEngine

    cfg = _axis_cfg()
    n, prompt, new = MODEL_AXIS_REQUESTS
    prompts = torch.randint(0, cfg.vocab_size, (n, prompt),
                            generator=torch.Generator().manual_seed(5))
    eng = ServeEngine(cfg, None, mesh=mesh, max_reqs=n, max_len=prompt + new,
                      seed=1, device=dev)
    first, step = [], eng._dec

    def recording(*args, **kw):
        logits, cache = step(*args, **kw)
        if not first:
            first.append(logits[0, -1].float().clone())
        return logits, cache

    eng._dec = recording
    rids = [eng.submit(p.numpy(), max_new=new) for p in prompts]
    res = eng.drain()
    return [res[r].tolist() for r in rids], first[0], eng.mode


def _axis_llm(torch, mesh, dev):
    """One gen_step and one student_step of ``make_llm_dense_steps`` with
    ``full_moe()``'s federation (two lite clients, a lite student) cut
    to MODEL_AXIS_LAYERS, float32, on ``mesh``: the losses, each step's
    launches and K1's shape."""
    from repro_torch.core import dense_llm as DL
    from repro_torch.core.generator import tok_generator_init
    from repro_torch.launch import dense_llm_oneshot as ONE
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import dp_axes_of
    from repro_torch.models import transformer as T

    oc, cfg = ONE.full_moe(), _axis_cfg()
    clients = [SH.local_params(T.init_model(cfg, seed=11 + i, device=dev),
                               cfg, mesh)
               for i in range(len(oc.client_archs))]
    stu = SH.local_params(T.init_model(cfg, seed=13, device=dev), cfg, mesh)
    for t in T.leaves(stu):
        t.requires_grad_(True)
    gen = tok_generator_init(
        nz=oc.nz, seq=oc.gen_seq, d_model=cfg.d_model, d_g=oc.d_g,
        n_classes=cfg.vocab_size, generator=torch.Generator().manual_seed(8),
        device=dev)
    gen_step, student_step, make_g, make_s = DL.make_llm_dense_steps(
        cfg, [cfg] * len(clients), g_lr=oc.g_lr, s_lr=oc.s_lr, mesh=mesh,
        dp_axes=dp_axes_of(mesh), device=dev)
    draws = torch.Generator(device=dev).manual_seed(9)
    z = torch.randn((oc.batch, oc.nz), generator=draws, device=dev)
    y = torch.randint(0, cfg.vocab_size, (oc.batch, oc.gen_seq),
                      generator=draws, device=dev)
    g_opt, s_opt = make_g(gen), make_s(stu)
    zero_counts()
    gl, parts = gen_step(gen, g_opt, stu, clients, z, y)
    sync(torch, dev)
    gen_launches = read_counts()
    zero_counts()
    dl = student_step(stu, s_opt, gen, clients, z, y)
    sync(torch, dev)
    return {"gen_loss": float(gl),
            "parts": {k: float(v) for k, v in parts.items()},
            "dis_loss": float(dl),
            "launches": {"gen_step": gen_launches,
                         "student_step": read_counts()},
            "k1_shape": [oc.batch * oc.gen_seq, cfg.vocab_size]}


def _axis_compare(torch, got: dict, want: dict, held=None) -> dict:
    """Per tensor of two trees with the same layout (``want`` on the
    host): max |got − want| over max |want|, the worst tensors and the
    entries past MODEL_AXIS_TOL of their tensor's largest entry; with
    ``held`` (a tree of bool masks) over the held entries alone, and
    the share held."""
    from repro_torch.launch.shardings import leaf_paths

    rows, past, kept, n = [], 0, 0, 0
    masks = leaf_paths(held) if held is not None else None
    for (keys, a), (_, b) in zip(leaf_paths(got), leaf_paths(want),
                                 strict=True):
        b = b.to(a.device)
        scale = float(b.abs().max())
        diff = (a.detach().float() - b.float()).abs()
        if masks is not None:
            mask = next(masks)[1].to(a.device)
            diff = torch.where(mask, diff, 0.0)
            kept += int(mask.sum())
        n += diff.numel()
        past += int((diff > MODEL_AXIS_TOL * scale).sum())
        rows.append((float(diff.max()) / max(scale, 1e-30), "/".join(keys)))
    rows.sort(reverse=True)
    out = {"max_rel": rows[0][0], "worst": rows[:4],
           "entries_past_tol": past}
    if held is not None:
        out["held_share"] = kept / n
    return out


# the partitioned trunk (the steps given the dry run's specs) at model 2:
# llama3-2-3b at full width (24 / 8 heads: 12 / 4 a rank), float32
MODEL_AXIS_LLAMA = "llama3-2-3b"
MODEL_AXIS_LLAMA_LAYERS = 2
MODEL_AXIS_LLAMA_BATCH = (2, 256)
# prompts, prompt tokens, greedy decode steps against a dense cache
MODEL_AXIS_DECODE = (2, 64, 8)
# the pod step's clients, batch and sequence: K1 at (batch·seq, 128256)
MODEL_AXIS_POD = (2, 2, 128)
# decode logits within this much of their largest entry
MODEL_AXIS_LOGITS_TOL = 1e-5
# the partitioned steps' parameters are held to MODEL_AXIS_TOL wherever
# the one-rank run's gradient was above this share of its tensor's
# largest at every step: below it Adam's update lr·g/(|g| + 1e-8) turns
# float32 noise, here the sums over ``model`` taken in another order,
# into a change of the update (on an H100 llama's one-rank floor reads 0,
# yet model 2 lies 5.3e-4–1.7e-3 from model 1 over every entry; ROADMAP.md
# Queue 3). At least MODEL_AXIS_HELD_SHARE of the entries are held; an
# absolute floor of 1e-5 (tests/test_torch_partitioned.py's, at smoke
# widths) held 5% of lite's and 16% of llama's at full width there
MODEL_AXIS_GRAD_FLOOR = 1e-3
MODEL_AXIS_HELD_SHARE = 0.25


class _GradFloor:
    """Stands in for a train state's Adam, which it calls: keeps, per
    parameter, where every step's gradient was above
    MODEL_AXIS_GRAD_FLOOR of the tensor's largest."""

    def __init__(self, opt):
        self.opt, self.params, self.m = opt, opt.params, opt.m
        self.held = None

    def step(self, grads):
        big = [g.abs() > MODEL_AXIS_GRAD_FLOOR * g.abs().max()
               for g in grads]
        self.held = big if self.held is None else [
            a & b for a, b in zip(self.held, big, strict=True)]
        self.opt.step(grads)


def _llama_axis_cfg():
    from repro_torch.configs import get_config

    return get_config(MODEL_AXIS_LLAMA).replace(
        n_layers=MODEL_AXIS_LLAMA_LAYERS, dtype="float32",
        param_dtype="float32")


def _axis_steps(torch, cfg, mesh, dev, batch, held: bool = False):
    """MODEL_AXIS_STEPS train steps of ``make_train_step`` from
    ``init_model`` (seed 0) on ``launch.train``'s token stream (seed 0),
    the weights and batches ``launch.train.train`` takes: with the specs
    on ``mesh`` (the partitioned trunk), without them where ``mesh`` is
    None. Returns (history, this rank's parameters and Adam's first
    moments (each rank compares its own shards: gathering them would
    move them through gloo's host copies), its ``wq``/``wk`` shapes
    where there are any, launches, routes, and with ``held`` the entries
    whose gradient was above MODEL_AXIS_GRAD_FLOOR at every step, else
    None)."""
    from repro_torch.data import lm_batches, make_lm_data
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import P
    from repro_torch.models import transformer as T

    B, S = batch
    params = T.init_model(cfg, seed=0, device=dev)
    if mesh is None:
        state = ST.make_train_state(cfg, params=params, device=dev)
        step = ST.make_train_step(cfg)
    else:
        pspecs, sspecs = SH.train_state_specs(cfg, mesh)
        bspec = P(SH.batch_specs(mesh, B), None)
        state = ST.make_train_state(cfg, params=params, device=dev,
                                    mesh=mesh, specs=sspecs)
        step = ST.make_train_step(cfg, mesh, specs=(
            sspecs, {"tokens": bspec, "labels": bspec}))
    del params
    if held:
        state["opt"] = _GradFloor(state["opt"])
    toks = make_lm_data(0, vocab=cfg.vocab_size,
                        n_tokens=max(200_000, B * (S + 1) * 4))
    hist = []
    zero_counts()
    for x, y in lm_batches(toks, B, S, seed=0, steps=MODEL_AXIS_STEPS):
        b = {"tokens": torch.from_numpy(x).to(dev),
             "labels": torch.from_numpy(y).to(dev)}
        if mesh is not None:
            b = {k: SH.cut(v, bspec, mesh) for k, v in b.items()}
        state, m = step(state, b)
        hist.append({k: float(v) for k, v in m.items()})
    sync(torch, dev)
    launches, routes = read_counts(), read_routes()
    attn = state["params"]["blocks"].get("attn", {})
    local = {k: list(attn[k]["w"].shape[-2:]) for k in ("wq", "wk")
             if k in attn}
    moments = _tree_from(state["params"], state["opt"].m)
    mask = _tree_from(state["params"], state["opt"].held) if held else None
    return hist, state["params"], moments, local, launches, routes, mask


def _axis_cut(cfg, mesh, params, moments, held):
    """A one-rank run's parameters, first moments and held entries (host
    trees) cut to this rank's shards by the specs (``zero1_specs`` for
    the moments)."""
    from repro_torch.launch import shardings as SH

    pspecs, sspecs = SH.train_state_specs(cfg, mesh)
    return (SH.local_params(params, cfg, mesh, pspecs),
            SH.local_tree(moments, sspecs["opt"]["m"], mesh),
            SH.local_params(held, cfg, mesh, pspecs))


def _axis_serve(torch, cfg, mesh, dev):
    """A prefill of MODEL_AXIS_DECODE's prompts into a dense cache and
    its greedy decode steps, with the specs on ``mesh`` (the cache cut
    by ``cache_specs``), without where ``mesh`` is None: (the greedy
    tokens, each decode step's logits on the host)."""
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import P
    from repro_torch.models import transformer as T

    n, plen, steps = MODEL_AXIS_DECODE
    params = T.init_model(cfg, seed=3, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (n, plen),
                            generator=torch.Generator().manual_seed(5)
                            ).to(dev)
    cache = T.init_cache(cfg, n, plen + steps, device=dev)
    if mesh is None:
        pre, dec = ST.make_prefill_step(cfg), ST.make_serve_step(cfg)
    else:
        pspecs, _ = SH.train_state_specs(cfg, mesh)
        cspecs = SH.cache_specs(cfg, cache, mesh, batch=n)
        tspec = P(SH.batch_specs(mesh, n), None)
        params = SH.local_params(params, cfg, mesh, pspecs)
        cache = SH.local_tree(cache, cspecs, mesh)
        prompts = SH.cut(prompts, tspec, mesh)
        pre = ST.make_prefill_step(cfg, mesh, specs=(pspecs, cspecs, tspec))
        dec = ST.make_serve_step(cfg, mesh,
                                 specs=(pspecs, cspecs, tspec, P()))
    toks, logits_all = [], []
    with torch.no_grad():
        logits, cache = pre(params, cache, prompts)
        for i in range(steps + 1):
            if i:
                logits, cache = dec(params, cache, tok, plen + i - 1)
                logits_all.append(logits[:, -1].float().cpu())
            tok = logits[:, -1].argmax(-1, keepdim=True)
            toks.append(tok[:, 0].tolist())
    return toks, logits_all


def _axis_pod(torch, cfg, mesh, dev):
    """One materialized ``make_pod_distill_step`` (K1 on the card) of a
    stack of MODEL_AXIS_POD's clients, with the specs on ``mesh`` (the
    logits all-gathered over ``model`` for K1), without where ``mesh``
    is None: (the loss, launches, routes)."""
    from repro_torch.core import dense_llm as DL
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import P
    from repro_torch.models import transformer as T

    def stack(trees):
        return {k: stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees])
                for k, v in trees[0].items()}

    n, B, S = MODEL_AXIS_POD
    stacked = stack([T.init_model(cfg, seed=21 + i, device=dev)
                     for i in range(n)])
    student = T.init_model(cfg, seed=23, device=dev)
    embeds = torch.randn((B, S, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
    if mesh is None:
        step = DL.make_pod_distill_step(cfg, None, n_clients=n, device=dev)
    else:
        pspecs, sspecs = SH.train_state_specs(cfg, mesh)
        cspecs = DL.pod_stack_specs(pspecs, mesh)
        espec = P("data", None, None)
        step = DL.make_pod_distill_step(cfg, mesh, n_clients=n, device=dev,
                                        specs=(sspecs, cspecs, espec))
        stacked = SH.local_tree(stacked, cspecs, mesh)
        embeds = SH.cut(embeds, espec, mesh)
    state = step.make_state(student)
    del student
    zero_counts()
    state, met = step(state, stacked, embeds)
    sync(torch, dev)
    return float(met["dis_loss"]), read_counts(), read_routes()


def model_axis_rank(rank: int, world: int, port: int, out: str,
                    dev: str = "cuda") -> None:
    """One rank of ``model_axis``'s world (``torch.multiprocessing``'s
    spawn), the card ``cuda:{rank % device_count}``. First each rank runs,
    in a one-rank world of its own, the one-rank reference train steps
    twice (the second run against the first: the float32 floor) and its
    share of the rest (rank 0 the engine, rank 1 the LLM DENSE steps);
    then both join the two-rank world from ``torchrun``'s environment
    variables, set here, and run every part at model 2, each rank holding
    its expert rows and replicated parameters to its own first
    reference's, then the partitioned parts (llama3-2-3b's model-1
    references first, side by side), each rank its shards to the
    reference cut to them. Writes its numbers to
    ``out/rank<rank>.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.backend import full_float32 as float32_only
    from repro_torch.launch import mesh as M
    from repro_torch.launch import shardings as SH
    from repro_torch.models import transformer as T

    float32_only()
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.set_device(rank % torch.cuda.device_count())

    def free():
        if on_card:
            torch.cuda.empty_cache()

    res: dict = {"rank": rank, "ref": {}, "mesh": {}}
    M.ensure_world(dev)                    # one rank, an in-process store
    one = M.make_host_mesh(1, device=dev)
    (hist, ref_params, ref_m), rec = _axis_part(
        torch, dev, lambda: _axis_train(torch, 1, dev))
    ref_params, ref_m = _to_host(ref_params), _to_host(ref_m)
    res["ref"]["train"] = {"history": hist, **rec}
    free()
    # the second run, the same program through the steps (no specs),
    # also keeps where its gradients stayed above the floor
    (_, params, moments, _, _, _, ref_held), rec = _axis_part(
        torch, dev, lambda: _axis_steps(torch, _axis_cfg(), None, dev,
                                        MODEL_AXIS_BATCH, held=True))
    ref_held = _to_host(ref_held)
    res["ref"]["train"]["floor"] = {
        "params": _axis_compare(torch, params, ref_params),
        "adam_m": _axis_compare(torch, moments, ref_m), **rec}
    del params, moments
    free()
    if rank == 0:
        (streams, ref_logits, mode), rec = _axis_part(
            torch, dev, lambda: _axis_engine(torch, one, dev))
        res["ref"]["engine"] = {"streams": streams, "mode": mode, **rec}
    else:
        llm, rec = _axis_part(torch, dev, lambda: _axis_llm(torch, one, dev))
        res["ref"]["llm"] = {**llm, **rec}
    res["ref"]["backend"] = dist.get_backend()
    dist.destroy_process_group()
    free()

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    mesh = M.make_host_mesh(world, device=dev)
    res["backend"] = dist.get_backend()
    res["mesh_shape"] = M.axis_sizes(mesh)
    res["mesh_device_type"] = mesh.device_type
    (hist, params, moments), rec = _axis_part(
        torch, dev, lambda: _axis_train(torch, world, dev))
    res["device"] = str(T.leaves(params)[0].device)
    res["expert_rows"] = list(params["blocks"]["moe"]["gate"].shape)
    cfg = _axis_cfg()
    train = {"history": hist, **rec,
             "params": _axis_compare(torch, params, SH.local_params(
                 ref_params, cfg, mesh)),
             "adam_m": _axis_compare(torch, moments, SH.local_params(
                 ref_m, cfg, mesh))}
    # the replicated parameters, bit for bit across the ranks
    unequal = []
    for (keys, t), expert in zip(SH.leaf_paths(params),
                                 SH.expert_mask(params)):
        if not expert:
            other = t.detach().clone()
            dist.broadcast(other, src=1)
            if not torch.equal(other, t.detach()):
                unequal.append("/".join(keys))
    train["replicated_unequal"] = unequal
    res["mesh"]["train"] = train
    del params, moments
    free()
    # the partitioned steps: lite's train against its run-time reference
    (hist, params, moments, local, launches, routes, _), rec = _axis_part(
        torch, dev, lambda: _axis_steps(torch, cfg, mesh, dev,
                                        MODEL_AXIS_BATCH))
    want_p, want_m, held = _axis_cut(cfg, mesh, ref_params, ref_m,
                                     ref_held)
    res["mesh"]["lite_partitioned"] = {
        "history": hist, **rec, "local_attn": local,
        "params": _axis_compare(torch, params, want_p),
        "params_held": _axis_compare(torch, params, want_p, held),
        "adam_m": _axis_compare(torch, moments, want_m)}
    del params, moments, ref_params, ref_m, ref_held, want_p, want_m, held
    free()
    # llama3-2-3b at model 1 without specs, on each rank side by side
    # (here rather than before the world forms: rank 1's one-rank LLM
    # steps peak at 38 GiB): train twice (the floor), the decode and the
    # pod step
    lcfg = _llama_axis_cfg()
    (l_hist, l_params, l_m, _, _, _, l_held), rec = _axis_part(
        torch, dev, lambda: _axis_steps(torch, lcfg, None, dev,
                                        MODEL_AXIS_LLAMA_BATCH, held=True))
    l_params, l_m, l_held = (_to_host(t) for t in (l_params, l_m, l_held))
    res["ref"]["llama_train"] = {"history": l_hist, **rec}
    free()
    (_, params, moments, _, _, _, _), rec = _axis_part(
        torch, dev, lambda: _axis_steps(torch, lcfg, None, dev,
                                        MODEL_AXIS_LLAMA_BATCH))
    res["ref"]["llama_train"]["floor"] = {
        "params": _axis_compare(torch, params, l_params),
        "adam_m": _axis_compare(torch, moments, l_m), **rec}
    del params, moments
    free()
    (l_toks, l_logits), rec = _axis_part(
        torch, dev, lambda: _axis_serve(torch, lcfg, None, dev))
    res["ref"]["llama_serve"] = {"tokens": l_toks, **rec}
    free()
    (l_pod, _, _), rec = _axis_part(
        torch, dev, lambda: _axis_pod(torch, lcfg, None, dev))
    res["ref"]["llama_pod"] = {"loss": l_pod, **rec}
    free()
    (hist, params, moments, local, launches, routes, _), rec = _axis_part(
        torch, dev, lambda: _axis_steps(torch, lcfg, mesh, dev,
                                        MODEL_AXIS_LLAMA_BATCH))
    want_p, want_m, held = _axis_cut(lcfg, mesh, l_params, l_m, l_held)
    res["mesh"]["llama_train"] = {
        "history": hist, **rec, "local_attn": local,
        "params": _axis_compare(torch, params, want_p),
        "params_held": _axis_compare(torch, params, want_p, held),
        "adam_m": _axis_compare(torch, moments, want_m),
        "launches": launches, "routes": routes}
    del params, moments, l_params, l_m, l_held, want_p, want_m, held
    free()
    (toks, logits), rec = _axis_part(
        torch, dev, lambda: _axis_serve(torch, lcfg, mesh, dev))
    res["mesh"]["llama_serve"] = {
        "tokens": toks, **rec,
        "logits_max_rel": max(float((a - b).abs().max())
                              / float(b.abs().max())
                              for a, b in zip(logits, l_logits,
                                              strict=True))}
    free()
    (loss, launches, routes), rec = _axis_part(
        torch, dev, lambda: _axis_pod(torch, lcfg, mesh, dev))
    res["mesh"]["llama_pod"] = {"loss": loss, **rec, "launches": launches,
                                "routes": routes}
    free()
    (streams, logits, mode), rec = _axis_part(
        torch, dev, lambda: _axis_engine(torch, mesh, dev))
    res["mesh"]["engine"] = {"streams": streams, "mode": mode, **rec}
    if rank == 0:
        scale = float(ref_logits.abs().max())
        res["mesh"]["engine"]["first_logits_max_rel"] = \
            float((logits - ref_logits).abs().max()) / scale
    del logits
    free()
    llm, rec = _axis_part(torch, dev, lambda: _axis_llm(torch, mesh, dev))
    res["mesh"]["llm"] = {**llm, **rec}
    dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def model_axis(torch, dev="cuda"):
    """The model axis at run time, then the partitioned trunk, on a
    two-rank world on the one card
    (gloo: two ranks share it, ``launch/mesh``'s backend rule):
    deepseek-v2-lite-16b at full width (d_model 2048, 64 routed experts
    top-6 and 2 shared, MLA, vocab 102400) cut to MODEL_AXIS_LAYERS,
    float32 without TF32, 32 experts a layer a rank:

      (a) MODEL_AXIS_STEPS train steps of ``launch.train.train`` at
          ``--model-parallel`` 2 and at 1 (a one-rank world), the same
          weights and batch (2 x 128): the losses, grad norms and Adam's
          first moments within MODEL_AXIS_TOL of each tensor's largest
          entry, the updated parameters within the larger of it and
          MODEL_AXIS_FLOOR_FACTOR times the floor that two one-rank runs
          read in this call (each rank its expert rows); the replicated
          parameters bit for bit across the ranks;
      (b) the dense engine on model 2, 4 greedy requests of 16 new
          tokens: the streams equal the one-rank engine's and each
          other's, the first decode step's logits within MODEL_AXIS_TOL;
      (c) one gen_step and one student_step of ``make_llm_dense_steps``
          with ``full_moe()``'s federation cut to MODEL_AXIS_LAYERS: K1f
          and K1b once a step each at (1024, 102400) on every rank, the
          losses within MODEL_AXIS_TOL of the one-rank run's;

    then the partitioned trunk, the steps given the dry run's specs
    (``launch/steps``, every layer on this rank's shards), each held to
    the same step at model 1 without specs: the losses, grad norms and
    Adam's first moments within MODEL_AXIS_TOL, the parameters within
    it wherever the one-rank run's gradient stayed above
    MODEL_AXIS_GRAD_FLOOR of its tensor's largest (the floor rule of (a)
    is reported beside):

      (d) lite's MODEL_AXIS_STEPS train steps (attention, the shared
          experts, the dense layer and the vocabulary over ``model``, 32
          experts a rank) against (a)'s one-rank run;
      (e) llama3-2-3b at full width cut to MODEL_AXIS_LLAMA_LAYERS (12
          query and 4 KV heads a rank), float32: MODEL_AXIS_STEPS train
          steps at MODEL_AXIS_LLAMA_BATCH, K2f, K2q and K2kv all on
          ``sm90`` at the head-sharded shape; a prefill and greedy
          decode steps against a
          dense cache (MODEL_AXIS_DECODE): the tokens equal and each
          step's logits within MODEL_AXIS_LOGITS_TOL of their largest
          entry;
      (f) one materialized ``make_pod_distill_step`` of llama3-2-3b
          (MODEL_AXIS_POD): K1f and K1b once each on the logits gathered
          over ``model`` (batch·seq, 128256), K2f on ``sm90``, the loss
          within MODEL_AXIS_TOL.

    Each part's seconds and peak GiB per rank, the backend, the phase's
    seconds. A failed spawn, a failed collective or a rank past
    MODEL_AXIS_DEADLINE fails the script. Returns K1's and K2's
    launches in the two-rank run by rank."""
    import tempfile

    import torch.multiprocessing as mp

    world = MODEL_AXIS_WORLD
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(model_axis_rank,
                                 args=(world, _free_port(), out, dev),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + MODEL_AXIS_DEADLINE
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    fail(f"model_axis: the {world}-rank world ran past "
                         f"{MODEL_AXIS_DEADLINE} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            fail(f"model_axis: a rank failed: {e}")
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    r0, r1 = ranks[0], ranks[1]
    ref_train, ref_engine = r0["ref"]["train"], r0["ref"]["engine"]
    ref_llm = r1["ref"]["llm"]

    def rel(a, b) -> float:
        return abs(a - b) / max(abs(b), 1e-30)

    train_err = max(rel(h[k], w[k]) for r in ranks
                    for h, w in zip(r["mesh"]["train"]["history"],
                                    ref_train["history"], strict=True)
                    for k in ("loss", "grad_norm"))
    llm_err = max(rel(r["mesh"]["llm"][k], ref_llm[k]) for r in ranks
                  for k in ("gen_loss", "dis_loss"))
    pair = expected(distill_kl_fwd=1, distill_kl_bwd=1)
    steps = [c for r in ranks for c in r["mesh"]["llm"]["launches"].values()]
    launches_ok = all(c == pair for c in
                      steps + list(ref_llm["launches"].values()))
    trains = [r["mesh"]["train"] for r in ranks]
    floor = max(r["ref"]["train"]["floor"]["params"]["max_rel"]
                for r in ranks)
    params_limit = max(MODEL_AXIS_TOL, MODEL_AXIS_FLOOR_FACTOR * floor)
    checks = {
        "backend_gloo": all(r["backend"] == "gloo" for r in ranks),
        "on_card": all(r["device"].startswith("cuda")
                       and r["mesh_device_type"] == "cuda" for r in ranks),
        "expert_rows": all(r["expert_rows"][1] == 32 for r in ranks),
        "train_history": train_err <= MODEL_AXIS_TOL
        and trains[1]["history"] == trains[0]["history"],
        "train_params": all(t["params"]["max_rel"] <= params_limit
                            for t in trains),
        "train_adam_m": all(t["adam_m"]["max_rel"] <= MODEL_AXIS_TOL
                            for t in trains),
        "replicated_bit_for_bit": not any(t["replicated_unequal"]
                                          for t in trains),
        "engine_dense": all(r["mesh"]["engine"]["mode"] == "dense"
                            for r in ranks),
        "engine_streams": all(r["mesh"]["engine"]["streams"]
                              == ref_engine["streams"] for r in ranks),
        "engine_logits": r0["mesh"]["engine"]["first_logits_max_rel"]
        <= MODEL_AXIS_TOL,
        "llm_losses": llm_err <= MODEL_AXIS_TOL,
        "llm_k1_launches": launches_ok
        and ref_llm["k1_shape"] == [1024, 102400]}

    # the partitioned steps against model 1 (the module doc's (d)-(f))
    def hist_err(got, want):
        return max(rel(h[k], w[k]) for h, w in zip(got, want, strict=True)
                   for k in ("loss", "grad_norm"))

    lite_p = [r["mesh"]["lite_partitioned"] for r in ranks]
    llama = [r["mesh"]["llama_train"] for r in ranks]
    l_ref = r0["ref"]["llama_train"]
    l_floor = max(r["ref"]["llama_train"]["floor"]["params"]["max_rel"]
                  for r in ranks)
    l_limit = max(MODEL_AXIS_TOL, MODEL_AXIS_FLOOR_FACTOR * l_floor)
    lite_err = max(hist_err(t["history"], ref_train["history"])
                   for t in lite_p)
    llama_err = max(hist_err(t["history"], l_ref["history"]) for t in llama)
    pod_err = max(rel(r["mesh"]["llama_pod"]["loss"],
                      r0["ref"]["llama_pod"]["loss"]) for r in ranks)
    logits_err = max(r["mesh"]["llama_serve"]["logits_max_rel"]
                     for r in ranks)
    pair = expected(distill_kl_fwd=1, distill_kl_bwd=1)

    def k2_sm90(launches, routes) -> bool:
        n = {k: launches[f"flash_attention_{k}"]
             for k in ("fwd", "bwd_dq", "bwd_dkv")}
        return all(n.values()) and routes["fwd_sm90"] == n["fwd"] \
            and routes["dq_sm90"] == n["bwd_dq"] \
            and routes["dkv_sm90"] == n["bwd_dkv"]

    checks.update({
        "lite_partitioned_history": lite_err <= MODEL_AXIS_TOL,
        "lite_partitioned_params": all(
            t["params_held"]["max_rel"] <= MODEL_AXIS_TOL
            and t["params_held"]["held_share"] >= MODEL_AXIS_HELD_SHARE
            for t in lite_p),
        "lite_partitioned_adam_m": all(t["adam_m"]["max_rel"]
                                       <= MODEL_AXIS_TOL for t in lite_p),
        "llama_heads_local": all(t["local_attn"] == {"wq": [3072, 1536],
                                                     "wk": [3072, 512]}
                                 for t in llama),
        "llama_train_history": llama_err <= MODEL_AXIS_TOL,
        "llama_train_params": all(
            t["params_held"]["max_rel"] <= MODEL_AXIS_TOL
            and t["params_held"]["held_share"] >= MODEL_AXIS_HELD_SHARE
            for t in llama),
        "llama_train_adam_m": all(t["adam_m"]["max_rel"] <= MODEL_AXIS_TOL
                                  for t in llama),
        "llama_train_k2_sm90": all(k2_sm90(t["launches"], t["routes"])
                                   for t in llama),
        "llama_decode_logits": logits_err <= MODEL_AXIS_LOGITS_TOL,
        "llama_greedy_tokens": all(r["mesh"]["llama_serve"]["tokens"]
                                   == r0["ref"]["llama_serve"]["tokens"]
                                   for r in ranks),
        "llama_pod_loss": pod_err <= MODEL_AXIS_TOL,
        "llama_pod_k1": all(
            {k: v for k, v in r["mesh"]["llama_pod"]["launches"].items()
             if k.startswith("distill_kl")} ==
            {k: v for k, v in pair.items() if k.startswith("distill_kl")}
            for r in ranks),
        "llama_pod_k2_sm90": all(
            r["mesh"]["llama_pod"]["launches"]["flash_attention_fwd"] > 0
            and r["mesh"]["llama_pod"]["routes"]["fwd_sm90"]
            == r["mesh"]["llama_pod"]["launches"]["flash_attention_fwd"]
            for r in ranks)})
    names = ("distill_kl_fwd", "distill_kl_bwd", "flash_attention_fwd",
             "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    by_rank = {f"rank{r['rank']}": {
        k: sum(c[k] for c in r["mesh"]["llm"]["launches"].values())
        + r["mesh"]["llama_train"]["launches"][k]
        + r["mesh"]["llama_pod"]["launches"][k] for k in names}
        for r in ranks}
    emit({"model_axis": {
        "card": card(), "arch": MODEL_AXIS_ARCH, "dtype": "float32",
        "n_layers": [get_full_layers(MODEL_AXIS_ARCH), MODEL_AXIS_LAYERS],
        "partitioned_arch": MODEL_AXIS_LLAMA,
        "partitioned_n_layers": [get_full_layers(MODEL_AXIS_LLAMA),
                                 MODEL_AXIS_LLAMA_LAYERS],
        "world": world, "backend": r0["backend"],
        "mesh": r0["mesh_shape"], "tol": MODEL_AXIS_TOL,
        "logits_tol": MODEL_AXIS_LOGITS_TOL,
        "checks": checks, "train_rel_err": train_err,
        "params_floor": floor, "params_limit": params_limit,
        "llm_rel_err": llm_err,
        "lite_partitioned_rel_err": lite_err,
        "llama_train_rel_err": llama_err, "llama_params_floor": l_floor,
        "llama_params_limit": l_limit, "llama_logits_rel_err": logits_err,
        "llama_pod_rel_err": pod_err, "launches": by_rank,
        "ranks": ranks, "seconds_total": time.perf_counter() - t0}})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"model_axis: {bad} failed")
    return by_rank


# ----------------------------------------------------------------- main --

def k2_entry(name, which, rs, line, launches, hybrid_launches,
             vlm_launches, vlm_train_launches, pod_launches, axis_launches):
    """The kernels line's entry of a K2 kernel: the server shape in
    bfloat16 (the LLM main path's gen_step and student_step), its
    launches over the LLM main path, and by path: the LLM main path's (D
    128), ssm_hybrid_train's (D 112), vlm_kernel_check's and
    family_train's vlm (D 128), pod_distill's two routes (D 128), each by
    route, and the route its float32
    calls take (train_check, ssm_train_check, family_train_check)."""
    import torch

    from repro_torch.kernels import flash_attention as FA

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
            "device_ms": main.get("device_ms"),
            "first_version_ms": main.get("first_version_ms"),
            "first_version_device_ms": main.get("first_version_device_ms"),
            "first_version_source":
                "src/repro_torch/kernels/csrc/flash_attention.cu",
            "launches_by_path": {
                path: {"D": d, "launches": n[name],
                       "route": FA.route(which, torch.bfloat16, d)}
                for path, d, n in (("llm_main_path", 128, launches),
                                   ("ssm_hybrid_train", 112,
                                    hybrid_launches),
                                   ("vlm_kernel_check", 128, vlm_launches),
                                   ("family_train_vlm", 128,
                                    vlm_train_launches),
                                   ("pod_distill_materialized", 128,
                                    pod_launches["materialized"]),
                                   ("pod_distill_chunked", 128,
                                    pod_launches["chunked"]))}
            | {"model_axis": {"D": 128, "dtype": "float32",
                              "route": FA.route(which, torch.float32, 128),
                              "launches": {rank: c[name] for rank, c in
                                           axis_launches.items()}}},
            "float32_route": FA.route(which, torch.float32, 128),
            "by_shape": rs}


def k3_entry(name, rs, line, launches):
    """The kernels line's entry of a K3 kernel: mamba2-130m's train shape
    in bfloat16 (the SSM LLM main path's train step), its launches over
    that path, its route (sm90 there), source and the first version's
    (``ssd_scan.cu``'s) time."""
    main = next(r for r in rs if r["shape"]["name"] == "mamba2_train"
                and r["dtype"] == "bfloat16")
    source = "ssd_scan_sm90.cu" if main["route"] == "sm90" \
        else "ssd_scan.cu"
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/ssd_scan.py:{line}",
            "launches": launches[name],
            "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shape": main["shape"],
            "dtype": main["dtype"], "k3_route": main["route"],
            "device_ms": main["device_ms"],
            "first_version_ms": main.get("first_version_ms"),
            "first_version_device_ms": main.get("first_version_device_ms"),
            "first_version_source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "float32_route": next(r["route"] for r in rs
                                  if r["shape"]["name"] == "mamba2_train"
                                  and r["dtype"] == "float32"),
            "by_shape": rs}


def main() -> None:
    t_start = time.perf_counter()
    torch, smi = setup()
    from repro_torch.configs import CONFIG
    from repro_torch.launch import dense_llm_oneshot as ONE

    rows = kernel_phase(torch)
    nonfinite_rows = k1_nonfinite_phase(torch)
    k4_rows = k4_phase(torch)
    k2_rows = k2_phase(torch)
    scfg = dataclasses.replace(CONFIG, local_epochs=1, epochs=2)
    emit({"cuts": {"local_epochs": [CONFIG.local_epochs, scfg.local_epochs],
                   "epochs": [CONFIG.epochs, scfg.epochs],
                   "grouped_check_shard_images": GROUPED_SHARD,
                   "kept": {"n_clients": scfg.n_clients,
                            "client_kinds": list(scfg.client_kinds),
                            "width": scfg.width,
                            "image_size": scfg.image_size,
                            "batch_size": scfg.batch_size,
                            "synth_batch": scfg.synth_batch,
                            "nz": scfg.nz, "t_g": scfg.t_g,
                            "alpha": scfg.alpha}}})
    clients, launches = main_path(torch, scfg)
    grouped_check(torch, scfg)
    profile_epoch(torch, scfg, clients)
    paper_launches = paper_tables(torch, scfg, clients)
    fault_launches = fault_round(torch, scfg, clients)
    fused_launches = fused_check(torch, scfg, clients)
    mesh_launches = mesh_round(torch, scfg)
    del clients
    torch.cuda.empty_cache()
    scale_launches = scale_round(torch)
    torch.cuda.empty_cache()
    step_agreement(torch)
    serve_check(torch)
    serve_launches = serve_main_path(torch)
    train_check(torch)
    dense_llm_check(torch)
    llm_launches, llm_ctx = llm_main_path(torch)
    profile_llm_epoch(torch, llm_ctx)
    pod_launches = pod_distill(torch, llm_ctx)
    del llm_ctx
    torch.cuda.empty_cache()
    pod_distill_check(torch)
    torch.cuda.empty_cache()
    k3_rows = k3_phase(torch)
    serve_check(torch, arch="zamba2-7b", n_layers=7, label="ssm_serve_check",
                prompt_range=(16, 301), max_len=336)
    serve_check(torch, arch="mamba2-130m", n_layers=2,
                label="ssm_serve_check", prompt_range=(16, 301), max_len=336)
    serve_main_path(torch, arch="zamba2-7b", label="ssm_serve")
    train_check(torch, arch="zamba2-7b", n_layers=7, batch=(2, 512),
                label="ssm_train_check")
    train_check(torch, arch="mamba2-130m", n_layers=24, batch=(8, 256),
                label="ssm_train_check")
    hybrid_launches = hybrid_train(torch)
    ssm_launches, ssm_ctx = llm_main_path(torch, oc=ONE.full_ssm(),
                                          label="ssm_llm")
    profile_llm_epoch(torch, ssm_ctx, label="profile_ssm_llm_epoch")
    del ssm_ctx
    torch.cuda.empty_cache()
    audio_launches, vlm_launches = family_phases(torch)
    vlm_train_launches = family_train(torch)
    family_train_check(torch)
    moe_launches = moe_llm_main_path(torch)
    torch.cuda.empty_cache()
    axis_launches = model_axis(torch)

    def entry(name, rs, replaces):
        main = next(r for r in rs if r["shape"] == list(MAIN_SHAPE)
                    and r["dtype"] == "float32"
                    and r.get("with_teacher_grad", True))
        return {"name": name, "route": "triton",
                "source": "src/repro_torch/kernels/distill_kl.py",
                "replaces": replaces, "launches": launches[name],
                "launches_by_path": {
                    "main_path": launches[name],
                    "paper_tables": {run: c[name] for run, c in
                                     paper_launches.items()},
                    "fault_round": {run: c[name] for run, c in
                                    fault_launches.items()},
                    "fused_check": {run: c[name] for run, c in
                                    fused_launches.items()},
                    "mesh_round": {run: c[name] for run, c in
                                   mesh_launches.items()},
                    "scale_round": scale_launches[name],
                    "moe_llm_main_path": moe_launches[name],
                    "model_axis": {rank: c[name] for rank, c in
                                   axis_launches.items()},
                    "pod_distill": {route: c[name] for route, c in
                                    pod_launches.items()}},
                "max_abs_err": main["max_abs_err"], "ms": main["ms"],
                "device_ms": main.get("device_ms"),
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None,
                "shape": list(MAIN_SHAPE), "dtype": "float32",
                "empty_triton_launch": rows["launch_floor"],
                "by_shape": rs,
                "nonfinite_rows": [r for r in nonfinite_rows
                                   if r["name"] == name]}

    R, hq, hkv, d, page, m = K4_SERVE_SHAPE
    k4 = next(r for r in k4_rows if r["dtype"] == "bfloat16"
              and r["shape"] == {"R": R, "Hq": hq, "Hkv": hkv, "D": d,
                                 "page": page, "M": m})
    print(smi, flush=True)
    emit({"profiler": {"fallbacks": PROFILER_FALLBACKS}})
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
         "launches_by_path": {
             "serve": serve_launches["paged_attention"],
             "audio_serve": audio_launches["paged_attention"]},
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": k4["library_ms"],
         "k4_route": k4["route"], "device_ms": k4["device_ms"],
         "first_version_ms": k4["first_version_ms"],
         "shape": k4["shape"], "dtype": k4["dtype"], "by_shape": k4_rows},
        *(k2_entry(name, which, k2_rows[which], line, llm_launches,
                   hybrid_launches, vlm_launches, vlm_train_launches,
                   pod_launches, axis_launches)
          for name, which, line in (
              ("flash_attention_fwd", "fwd", 171),
              ("flash_attention_bwd_dq", "dq", 342),
              ("flash_attention_bwd_dkv", "dkv", 370))),
        *(k3_entry(name, k3_rows[which], line, ssm_launches)
          for name, which, line in (("ssd_scan_fwd", "fwd", 143),
                                    ("ssd_scan_bwd", "bwd", 278)))]})
    import torch.distributed as dist

    if dist.is_initialized():       # the mesh phases' one-rank world
        dist.destroy_process_group()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
