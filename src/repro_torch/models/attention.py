"""Grouped-query attention of the dense and audio families
(``repro/models/attention.py:23-253``).

``gqa_apply`` attends over x alone (training, the LLM DENSE steps),
prefills a dense cache and decodes against it; ``gqa_apply_paged``
decodes one token per request against the serving engine's block pool
through ``kernels.ops.paged_attention`` (K4 on the card). Query head
``h`` attends with KV head ``h // G`` (``h = kv·G + g``, G = n_heads /
n_kv_heads), masked scores are set to ``NEG_INF = -2^30``, and q, k and
v carry a bias where ``cfg.qkv_bias`` (qwen), as in the reference.

Without a cache, the route follows the execution policy as in the
reference (``attention.py:152-172``): under a kernel profile
(``kernel_vjp != "ref"``, the cuda default) ``kernels.ops.flash_attention``
runs K2 on (B, H, S, D) copies of q, k and v, causal with window 0 (the
port has no sliding-window pattern) under the contract that the
positions are contiguous from 0; under ``"ref"`` the plain ``_sdpa``
runs. Prefill with a cache stays on ``_sdpa`` on every profile, as in
the reference.

Caches and pools are updated in place and returned (the reference
returns updated copies): a decode step writes one row, not a new cache.
The blockwise online-softmax prefill for S ≥ 4096 (``_use_blockwise``)
is not ported and raises ``NotImplementedError``.

``_sdpa`` stays plain torch matmul and softmax: the reference computes it
in XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.backend import resolve_exec_policy
from repro_torch.kernels import ops
from repro_torch.models import layers as L

NEG_INF = -2.0 ** 30
BLOCKWISE_MIN = 4096


def gqa_init(cfg, *, generator, dtype, lead: tuple = ()) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = {"generator": generator, "dtype": dtype, "lead": lead}
    qkv = dict(kw, bias=cfg.qkv_bias)
    return {"wq": L.linear_init(d, h * hd, **qkv),
            "wk": L.linear_init(d, kh * hd, **qkv),
            "wv": L.linear_init(d, kh * hd, **qkv),
            "wo": L.linear_init(h * hd, d, **kw)}


def gqa_cache_init(cfg, batch: int, max_len: int, dtype, device,
                   lead: tuple = ()) -> dict:
    shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _sdpa(q, k, v, mask, scale):
    """q: (B,S,Kh,G,Dh), k/v: (B,T,Kh,Dh), mask: (B,S,T) or (S,T) ->
    (B,S,Kh,G,Dh). Scores in float32, probabilities cast to v's dtype."""
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def _use_blockwise(sq: int, t: int, bq: int, bk: int) -> bool:
    return sq >= BLOCKWISE_MIN and sq % bq == 0 and t % bk == 0


def _qkv(p, x, cfg, cos, sin):
    B, S, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.apply_rope(L.linear(p["wq"], x).reshape(B, S, h, hd), cos, sin)
    k = L.apply_rope(L.linear(p["wk"], x).reshape(B, S, kh, hd), cos, sin)
    v = L.linear(p["wv"], x).reshape(B, S, kh, hd)
    return q, k, v


def gqa_apply(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              cache: dict | None = None, cache_pos: int | None = None):
    """Self-attention. x: (B, S, D); positions: (S,) absolute positions.

    Prefill: a cache to fill from ``cache_pos`` (default positions[0]).
    Decode: S == 1 against the cached K/V. ``cache=None`` attends over x
    alone, through K2 under a kernel profile (positions must then be
    0..S-1). Returns (y, cache)."""
    B, S, _ = x.shape
    T = S if cache is None else cache["k"].shape[1]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cos, sin = L.rope_cos_sin(positions, hd, cfg.rope_theta)
    q, k, v = _qkv(p, x, cfg, cos, sin)

    pol = resolve_exec_policy(cfg, device=x.device)
    if cache is None and pol.kernel_vjp != "ref":
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True, window=0,
                                  policy=pol)
        out = out.transpose(1, 2).reshape(B, S, h * hd)
        return L.linear(p["wo"], out.to(x.dtype)), None
    if cfg.use_blockwise_attn and _use_blockwise(S, T, cfg.attn_block_q,
                                                 cfg.attn_block_kv):
        raise NotImplementedError(
            f"the blockwise prefill (S={S} >= {BLOCKWISE_MIN}) is not "
            "ported yet (ROADMAP.md)")

    if cache is not None:
        pos = int(positions[0] if cache_pos is None else cache_pos)
        pos = min(max(pos, 0), T - S)        # as dynamic_update_slice clamps
        cache["k"][:, pos:pos + S] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + S] = v.to(cache["v"].dtype)
        k_all, v_all = cache["k"], cache["v"]
        k_pos = torch.arange(T, device=x.device)
    else:
        k_all, v_all, k_pos = k, v, positions
    mask = k_pos[None, :] <= positions[:, None]

    q = q.reshape(B, S, kh, h // kh, hd)
    out = _sdpa(q, k_all.to(q.dtype), v_all.to(q.dtype), mask,
                1.0 / math.sqrt(hd))
    return L.linear(p["wo"], out.reshape(B, S, h * hd).to(x.dtype)), cache


def gqa_apply_paged(p: dict, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor, pool: dict,
                    block_tables: torch.Tensor):
    """One-token-per-request decode against a block-pool cache
    (launch/paging.py).

    x: (R, 1, D), the incoming token of each scheduler slot; positions:
    (R,) int32, its absolute position (the tokens already cached);
    pool: {"k", "v"} of (P, page, Kh, Dh); block_tables: (R, M) int32.
    The new K/V goes to pool row ``block_tables[r, pos // page]·page +
    pos % page`` (inactive slots have all-zero table rows, so theirs
    lands in the null block 0); then attention runs over each slot's
    first ``positions[r] + 1`` tokens. Returns (y, pool)."""
    R, S, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cos, sin = L.rope_cos_sin(positions[:, None], hd, cfg.rope_theta)
    q, k, v = _qkv(p, x, cfg, cos, sin)

    P, page = pool["k"].shape[:2]
    blk = block_tables.gather(1, (positions // page)[:, None].long())[:, 0]
    flat = (blk.long() * page + positions % page).long()
    for name, cur in (("k", k), ("v", v)):
        pool[name].view(P * page, kh, hd)[flat] = \
            cur[:, 0].to(pool[name].dtype)

    out = ops.paged_attention(q[:, 0].contiguous(), pool["k"], pool["v"],
                              block_tables, positions + 1,
                              policy=resolve_exec_policy(cfg,
                                                         device=x.device))
    return L.linear(p["wo"], out.reshape(R, 1, h * hd).to(x.dtype)), pool
