"""Request-level continuous-batching serving engine
(``repro/launch/engine.py:80-363``).

Callers ``submit()`` requests (ragged prompt and generation lengths, any
arrival order), ``step()`` advances the engine one scheduler iteration,
``poll()`` / ``drain()`` collect the results.

Two modes:

  * ``"paged"`` (the default where the family supports it) — continuous
    batching over the block pool (launch/paging.py). One decode step
    advances every running request at once through
    ``transformer.forward_paged``, K4 on the card for every attention
    block, the mamba blocks' one-token step on their slots. Admission
    runs an exact-length dense prefill of the request (K3f on the card
    for every mamba block) and scatters the filled cache into its blocks
    and slot, so a new request joins the running batch without touching
    the others.
  * ``"dense"`` — the sequential reference: one request at a time with a
    batch-1 dense cache, the oracle paged mode is held to, and the mode
    of the families without a paged layout (``paging.supports_paged``):
    moe (MLA's latent cache), vlm and sliding-window patterns. A vlm
    attends over stubbed patch embeddings, zeros (1, n_patches,
    vision_dim), as the reference's engine passes them.

Scheduling, as the reference's: FIFO admission; a request is admitted
once a slot and its whole block budget ``ceil((prompt + max_new) /
page)`` are free (blocks are granted for the request's lifetime, so
decode never deadlocks); completion releases the slot and the blocks at
once, and the freed slot's table row goes back to the null block.

Sampling does not depend on which requests share a batch. Greedy is the
argmax of the float32 logits row, ties to the first index (as
``np.argmax``). A temperature ``T`` draws ``argmax(logits / T + n)``
with ``n = noise(rid, token_index, V)``, Gumbel noise keyed by the
request and the token index — how the reference's
``jax.random.categorical`` computes with the key
``fold_in(fold_in(k, rid), token_index)``. The default noise comes from a
``torch.Generator`` seeded from ``(seed, rid, token_index)``; the tests
inject the reference's draws. Steps run under ``torch.inference_mode()``.

Model parallelism (``mesh=``, ``launch/mesh.make_host_mesh``): the dense
steps take the mesh, whose MoE layers run expert-parallel over
``model`` (the engine holds this rank's expert rows,
``launch/shardings.local_params``); every other layer runs replicated.
With more than one ``model`` rank the mode defaults to dense and paged
is refused, as in the reference (``repro/launch/engine.py:98-109``).
Every rank samples the same token: greedy takes the argmax of logits
that the all-reduce made the same on every rank, and sampling adds the
seed's noise, the same on every rank. A data axis of more than one rank
cannot split the batch-1 step's one decode token (``moe.moe_apply``
raises); drive the engine with ``model`` the whole world, as
``make_host_mesh(n)`` builds it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.backend import resolve_device, resolve_exec_policy
from repro_torch.launch import paging as PG
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import axis_size
from repro_torch.models import transformer as T

supports_paged = PG.supports_paged


def gumbel_noise(seed: int):
    """The default noise source: ``noise(rid, token_index, V)`` gives V
    standard Gumbel draws, float32, from a CPU ``torch.Generator`` seeded
    from ``(seed, rid, token_index)`` — the same on every device."""
    tiny = torch.finfo(torch.float32).tiny

    def noise(rid: int, token_index: int, vocab: int) -> torch.Tensor:
        key = np.random.SeedSequence([seed, rid, token_index])
        gen = torch.Generator().manual_seed(
            int(key.generate_state(1, np.uint64)[0]))
        u = torch.rand(vocab, generator=gen).clamp_min(tiny)
        return -torch.log(-torch.log(u))

    return noise


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    temperature: float | None        # None -> greedy
    tokens: list = dataclasses.field(default_factory=list)
    slot: int = -1
    blocks: tuple = ()
    status: str = "queued"           # queued | running | done
    t_submit: float = 0.0
    t_done: float = 0.0


class ServeEngine:
    """See the module docstring. ``max_len`` bounds ``prompt + max_new``
    per request; ``max_reqs`` is the number of concurrent slots;
    ``n_blocks`` defaults to enough for ``max_reqs`` worst-case requests
    plus the null block. ``params=None`` draws random ones from ``seed``
    (``transformer.init_model``); on a mesh they are cut to this rank's
    expert rows. ``device`` is the card unless the caller asks for the
    CPU."""

    def __init__(self, cfg, params=None, policy=None, *, mesh=None,
                 max_reqs: int = 4, max_len: int = 256,
                 n_blocks: int | None = None, page: int | None = None,
                 mode: str | None = None, seed: int = 0, device="cuda",
                 noise=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = resolve_exec_policy(policy, device=self.device)
        model_par = mesh is not None and axis_size(mesh, SH.MP) > 1
        if mode is None:
            mode = "paged" if supports_paged(cfg) and not model_par \
                else "dense"
        if mode not in ("paged", "dense"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "paged" and (not supports_paged(cfg) or model_par):
            raise ValueError(
                f"paged mode unsupported here (family={cfg.family!r}, "
                f"sliding_window={cfg.sliding_window}, "
                f"kv_lora_rank={cfg.kv_lora_rank}, "
                f"model_parallel={model_par}); use mode='dense'")
        self.mode = mode
        if params is None:
            params = T.init_model(cfg, seed=seed, device=self.device)
        self.params = SH.local_params(params, cfg, mesh)
        self._noise = gumbel_noise(seed) if noise is None else noise
        self.max_reqs, self.max_len = int(max_reqs), int(max_len)

        self._queue: list[_Request] = []
        self._reqs: dict[int, _Request] = {}
        self._next_rid = 0
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0,
                      "decode_steps": 0, "generated": 0}

        if mode == "paged":
            self.page = page if page is not None \
                else PG.page_size(self.policy, self.max_len)
            self.page = max(1, min(int(self.page), self.max_len))
            self.n_pages = -(-self.max_len // self.page)
            if n_blocks is None:
                n_blocks = 1 + self.max_reqs * self.n_pages
            self.allocator = PG.BlockAllocator(n_blocks)
            with torch.inference_mode():
                self._pools = PG.init_paged_cache(
                    cfg, max_reqs=self.max_reqs, n_blocks=n_blocks,
                    page=self.page, device=self.device)
                self._bt = torch.zeros((self.max_reqs, self.n_pages),
                                       dtype=torch.int32, device=self.device)
            self._slots: list[_Request | None] = [None] * self.max_reqs
            self._seq = np.zeros((self.max_reqs,), np.int32)
            self._cur = np.zeros((self.max_reqs,), np.int32)
        else:
            self._prefill = ST.make_prefill_step(cfg, mesh)
            self._dec = ST.make_serve_step(cfg, mesh)
            self._vision = torch.zeros(
                (1, cfg.n_patches, cfg.vision_dim), device=self.device) \
                if cfg.family == "vlm" else None

    # ------------------------------------------------------------- API --

    def submit(self, prompt, max_new: int = 16, sampling=None) -> int:
        """Queue a request; returns its id. ``sampling``: None or {} for
        greedy argmax, ``{"temperature": t}`` for sampling at t."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if prompt.size + max_new > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds "
                f"engine max_len ({self.max_len})")
        temperature = None
        if sampling:
            temperature = float(sampling.get("temperature", 1.0))
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, prompt, int(max_new), temperature,
                       t_submit=time.perf_counter())
        self._reqs[rid] = req
        self._queue.append(req)
        return rid

    def step(self) -> int:
        """One scheduler iteration. Paged: admit whatever fits, then one
        decode step for every running slot. Dense: run the oldest queued
        request to completion. Returns the live (queued + running)
        request count."""
        with torch.inference_mode():
            if self.mode == "paged":
                admitted = self._admit()
                if (not admitted and self._queue
                        and all(s is None for s in self._slots)):
                    req = self._queue[0]
                    need = PG.blocks_needed(len(req.prompt), req.max_new,
                                            self.page)
                    raise RuntimeError(
                        f"request {req.rid} needs {need} blocks but the "
                        f"idle pool has only {self.allocator.n_free} — pool "
                        "too small for this request")
                self._decode_once()
            else:
                self._run_one_dense()
        return sum(1 for r in self._reqs.values() if r.status != "done")

    def poll(self, rid: int) -> dict:
        r = self._reqs[rid]
        out = {"status": r.status, "tokens": list(r.tokens)}
        if r.status == "done":
            out["latency_s"] = r.t_done - r.t_submit
        return out

    def drain(self, max_steps: int | None = None) -> dict:
        """step() until every submitted request completes; returns
        {rid: np.ndarray of generated tokens}."""
        if max_steps is None:
            max_steps = 4 * sum(r.max_new + 2 for r in self._reqs.values()
                                if r.status != "done") + 16
        steps = 0
        while any(r.status != "done" for r in self._reqs.values()):
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"drain exceeded {max_steps} steps — "
                                   "scheduler stuck")
        return {r.rid: np.asarray(r.tokens, np.int32)
                for r in self._reqs.values()}

    # ------------------------------------------------------ internals --

    def _sample(self, req: _Request, logits_row: torch.Tensor) -> int:
        """The next token of ``req`` from its float32 logits row (V,)."""
        self.stats["generated"] += 1
        if req.temperature is None:
            return int(torch.argmax(logits_row))
        n = self._noise(req.rid, len(req.tokens), logits_row.shape[-1])
        return int(torch.argmax(logits_row / req.temperature
                                + n.to(logits_row.device, torch.float32)))

    def _finish(self, req: _Request):
        req.status = "done"
        req.t_done = time.perf_counter()
        if req.slot >= 0:
            slot = req.slot
            self._slots[slot] = None
            self._seq[slot] = 0
            self._cur[slot] = 0
            # point the freed slot's table back at the null block so its
            # masked decode writes stop touching the released blocks
            self._bt[slot] = 0
            self.allocator.release(req.blocks)
            req.slot = -1

    def _tensor(self, a) -> torch.Tensor:
        """A copy of host data on the engine's device."""
        return torch.tensor(a, device=self.device)

    # paged mode ----------------------------------------------------------

    def _admit(self) -> int:
        admitted = 0
        while self._queue:
            req = self._queue[0]
            slot = next((i for i, s in enumerate(self._slots)
                         if s is None), None)
            if slot is None:
                break
            need = PG.blocks_needed(len(req.prompt), req.max_new, self.page)
            blocks = self.allocator.alloc(need)
            if blocks is None:
                break                    # pool exhausted: wait, FIFO holds
            self._queue.pop(0)
            t0 = time.perf_counter()
            row = np.zeros((self.n_pages,), np.int32)
            row[:need] = blocks
            p = len(req.prompt)
            # exact-length prefill: pad tokens would shift the last-token
            # logits
            cache = T.init_cache(self.cfg, 1, p, device=self.device)
            logits, filled = T.forward(
                self.params, self.cfg, tokens=self._tensor(req.prompt)[None],
                positions=torch.arange(p, dtype=torch.int32,
                                       device=self.device),
                cache=cache, cache_pos=0)
            PG.scatter_prefill(self.cfg, self._pools, self._bt, filled, slot,
                               self._tensor(row))
            req.slot, req.blocks, req.status = slot, tuple(blocks), "running"
            self._slots[slot] = req
            self._seq[slot] = p
            tok = self._sample(req, logits[0, -1].float())
            req.tokens.append(tok)
            self._cur[slot] = tok
            self.stats["prefill_s"] += time.perf_counter() - t0
            admitted += 1
            if len(req.tokens) >= req.max_new:
                self._finish(req)
        return admitted

    def _decode_once(self):
        if all(s is None for s in self._slots):
            return
        t0 = time.perf_counter()
        logits, self._pools = T.forward_paged(
            self.params, self.cfg, tokens=self._tensor(self._cur)[:, None],
            positions=self._tensor(self._seq), cache=self._pools,
            block_tables=self._bt)
        logits = logits[:, -1].float()
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            self._seq[slot] += 1
            tok = self._sample(req, logits[slot])
            req.tokens.append(tok)
            self._cur[slot] = tok
            if len(req.tokens) >= req.max_new:
                self._finish(req)
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1

    # dense (sequential reference) mode -----------------------------------

    def _run_one_dense(self):
        if not self._queue:
            return
        req = self._queue.pop(0)
        req.status = "running"
        p = len(req.prompt)
        t0 = time.perf_counter()
        cache = T.init_cache(self.cfg, 1, p + req.max_new,
                             device=self.device)
        logits, cache = self._prefill(self.params, cache,
                                      self._tensor(req.prompt)[None],
                                      vision=self._vision)
        req.tokens.append(self._sample(req, logits[0, -1].float()))
        self.stats["prefill_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(req.max_new - 1):
            logits, cache = self._dec(
                self.params, cache,
                self._tensor([[req.tokens[-1]]]), p + i,
                vision=self._vision)
            req.tokens.append(self._sample(req, logits[0, -1].float()))
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += max(0, req.max_new - 1)
        self._finish(req)
