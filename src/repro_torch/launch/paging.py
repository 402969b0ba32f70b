"""The block-pool cache of the serving engine
(``repro/launch/paging.py:38-193``: the dense, audio, ssm and hybrid
families).

  * **KV pool** — per attention layer stack, ``(L, P, page, Kh, Dh)``:
    ``P`` blocks of ``page`` tokens. Position ``t`` of the request in
    scheduler slot ``r`` lives at ``(block_tables[r, t // page],
    t % page)``.
  * **block tables** — ``(max_reqs, M)`` int32, ``M = ceil(max_len /
    page)``; unassigned entries stay 0.
  * **SSM slots** — every mamba block's state (``ssm``, ``conv_x``,
    ``conv_bc``) with its batch axis sized to ``max_reqs`` slots, stacked
    as the block's parameters; the state is O(1) a request, so it is
    indexed by slot, not paged. A hybrid has both: slots for its mamba
    blocks, a KV pool per application of its shared block.
  * **free list** — the host-side LIFO ``BlockAllocator``, with the
    reference's order, so block ids (and so pools) compare one to one.
    **Block 0 is reserved** as the null sink: inactive slots keep
    all-zero table rows, so their masked decode writes land there.

Prefill stays dense: a request runs an exact-length ``forward`` prefill
(padding would advance the SSM recurrence), then ``scatter_prefill``
copies the filled cache into its blocks and its slot. Every leaf of the
slot is overwritten: a free slot's state keeps evolving under the
inactive slots' decode. The audio family (musicgen) pages exactly as the
dense one does. The moe family (MLA's latent cache), the vlm
(cross-attention) and sliding-window patterns have no paged layout, in
the reference as here: they serve in the engine's dense mode.
"""
from __future__ import annotations

import torch

from repro_torch.configs.backend import resolve_device, resolve_exec_policy
from repro_torch.models import transformer as T

PAGED_FAMILIES = ("dense", "audio", "ssm", "hybrid")


def supports_paged(cfg) -> bool:
    """Families the paged decode covers. moe (MLA's latent cache), vlm
    (the cross-attention stream) and sliding-window patterns serve in the
    engine's sequential dense mode."""
    return (cfg.family in PAGED_FAMILIES and not cfg.sliding_window
            and not cfg.kv_lora_rank)


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


def _check_paged(cfg) -> None:
    """Raise unless ``cfg``'s family has a paged layout."""
    if not supports_paged(cfg):
        raise ValueError(f"no paged cache layout for family {cfg.family!r} "
                         f"(sliding_window={cfg.sliding_window}, "
                         f"kv_lora_rank={cfg.kv_lora_rank}) — use the "
                         "sequential dense engine mode")


def init_paged_cache(cfg, *, max_reqs: int, n_blocks: int, page: int,
                     device="cuda") -> dict:
    """The pool tree, zeros (unwritten rows are finite), in ``init_cache``'s
    structure: each attention stack's ``{"k", "v"}`` as ``(L, P, page,
    Kh, Dh)`` blocks in ``cfg.dtype``, each mamba stack's states with
    ``max_reqs`` slots."""
    _check_paged(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def kv_pool(n):
        shape = (n, n_blocks, page, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    if cfg.family in ("dense", "audio"):
        return {"layers": kv_pool(cfg.n_layers)}
    # the mamba states of a batch of max_reqs (one slot a request) from
    # init_cache; a hybrid's shared-block cache becomes its block pool
    c = T.init_cache(cfg, max_reqs, 0, device=dev)
    if "shared" in c:
        c["shared"] = kv_pool(T.hybrid_shape(cfg)[0])
    return c


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


def _scatter_slot(slots: dict, state: dict, slot: int, *, lead: int = 1):
    """A batch-1 SSM state tree -> slot ``slot`` of the slot-indexed tree
    (``lead`` stack axes before the batch axis), every leaf, in place."""
    pre = (slice(None),) * lead
    for k, t in state.items():
        slots[k][pre + (slot,)] = t[pre + (0,)].to(slots[k].dtype)
    return slots


def scatter_prefill(cfg, pools: dict, block_tables: torch.Tensor,
                    filled: dict, slot: int, row: torch.Tensor):
    """Install one admitted request: copy its filled exact-length dense
    prefill cache (``init_cache(cfg, 1, p)`` after ``forward``) into the
    pool and its slot, and point block-table row ``slot`` at ``row`` (the
    allocated block ids, zero-padded to M). In place; returns
    ``(pools, block_tables)``."""
    _check_paged(cfg)
    if cfg.family in ("dense", "audio"):
        _scatter_kv(pools["layers"], filled["layers"], row)
    elif cfg.family == "ssm":
        _scatter_slot(pools["layers"], filled["layers"], slot)
    else:
        _scatter_slot(pools["layers"], filled["layers"], slot, lead=2)
        _scatter_kv(pools["shared"], filled["shared"], row)
        if "tail" in pools:
            _scatter_slot(pools["tail"], filled["tail"], slot)
    block_tables[slot] = row
    return pools, block_tables
