"""The block-pool KV cache of the serving engine
(``repro/launch/paging.py:38-193``, the dense family).

  * **KV pool** — per attention layer stack, ``(L, P, page, Kh, Dh)``:
    ``P`` blocks of ``page`` tokens. Position ``t`` of the request in
    scheduler slot ``r`` lives at ``(block_tables[r, t // page],
    t % page)``.
  * **block tables** — ``(max_reqs, M)`` int32, ``M = ceil(max_len /
    page)``; unassigned entries stay 0.
  * **free list** — the host-side LIFO ``BlockAllocator``, with the
    reference's order, so block ids (and so pools) compare one to one.
    **Block 0 is reserved** as the null sink: inactive slots keep
    all-zero table rows, so their masked decode writes land there.

Prefill stays dense: a request runs an exact-length ``forward`` prefill,
then ``scatter_prefill`` copies the filled cache into its blocks.

The reference also pages the ssm and hybrid families (per-slot SSM
state); the port does not have them yet and raises
``NotImplementedError`` for them, rather than serve them another way.
"""
from __future__ import annotations

import torch

from repro_torch.configs.backend import resolve_device, resolve_exec_policy

PAGED_FAMILIES = ("dense", "audio", "ssm", "hybrid")


def supports_paged(cfg) -> bool:
    """Families the reference's paged decode covers (sliding-window
    patterns serve in dense mode there)."""
    return cfg.family in PAGED_FAMILIES and not cfg.sliding_window


def page_size(policy=None, max_len: int | None = None, *,
              device="cuda") -> int:
    """The pool's page size, from the execution policy (16 tokens),
    clamped to ``max_len`` when given."""
    page = resolve_exec_policy(policy, device=device).page
    if max_len is not None:
        page = min(int(page), int(max_len))
    return max(1, int(page))


def blocks_needed(prompt_len: int, max_new: int, page: int) -> int:
    """Pool blocks a request holds for its whole lifetime (granted at
    admission, so decode never allocates and never deadlocks)."""
    return -(-(int(prompt_len) + int(max_new)) // int(page))


class BlockAllocator:
    """Host-side free-list allocator over pool blocks 1..n_blocks-1
    (block 0 is the reserved null sink and is never handed out)."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.n_blocks = int(n_blocks)
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self._used: set[int] = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int):
        """``n`` block ids, or None if the pool cannot cover the request
        (all or nothing: a partial grant could deadlock two admissions)."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._used.update(ids)
        return ids

    def release(self, ids):
        for i in ids:
            if i not in self._used:
                raise ValueError(f"double free of block {i}")
            self._used.remove(i)
            self._free.append(i)


def _check_dense(cfg) -> None:
    if not supports_paged(cfg):
        raise ValueError(f"no paged cache layout for family {cfg.family!r} "
                         f"(sliding_window={cfg.sliding_window}) — use the "
                         "sequential dense engine mode")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the paged cache of family {cfg.family!r} is not ported yet "
            "(ROADMAP.md: ssm and hybrid come with the ssm/hybrid serving "
            "slice, audio with the dense-mode-only families)")


def init_paged_cache(cfg, *, max_reqs: int, n_blocks: int, page: int,
                     device="cuda") -> dict:
    """The pool tree, ``{"layers": {"k", "v"}}`` of zeros in
    ``(L, P, page, Kh, Dh)`` and ``cfg.dtype`` (unwritten rows are finite).
    ``max_reqs`` sizes the reference's SSM slots, which the dense family
    has none of."""
    _check_dense(cfg)
    shape = (cfg.n_layers, n_blocks, page, cfg.n_kv_heads, cfg.head_dim)
    kw = {"dtype": getattr(torch, cfg.dtype), "device": resolve_device(device)}
    return {"layers": {"k": torch.zeros(shape, **kw),
                       "v": torch.zeros(shape, **kw)}}


def _scatter_kv(pool: dict, cache: dict, row: torch.Tensor) -> dict:
    """Dense prefill KV ``(L, 1, p, Kh, Dh)`` -> pool blocks ``row[:nb]``
    of ``(L, P, page, Kh, Dh)``, in place; the tail of the last block is
    written as zeros."""
    page = pool["k"].shape[2]
    p = cache["k"].shape[2]
    nb = -(-p // page)
    for n in ("k", "v"):
        c = cache[n][:, 0]                                 # (L, p, Kh, Dh)
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, nb * page - p))
        pool[n][:, row[:nb].long()] = c.reshape(
            c.shape[0], nb, page, *c.shape[2:]).to(pool[n].dtype)
    return pool


def scatter_prefill(cfg, pools: dict, block_tables: torch.Tensor,
                    filled: dict, slot: int, row: torch.Tensor):
    """Install one admitted request: copy its filled exact-length dense
    prefill cache (``init_cache(cfg, 1, p)`` after ``forward``) into the
    pool and point block-table row ``slot`` at ``row`` (the allocated
    block ids, zero-padded to M). In place; returns
    ``(pools, block_tables)``."""
    _check_dense(cfg)
    _scatter_kv(pools["layers"], filled["layers"], row)
    block_tables[slot] = row
    return pools, block_tables
