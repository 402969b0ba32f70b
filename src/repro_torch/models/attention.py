"""Attention of the LM families (``repro/models/attention.py``):
grouped-query attention with its sliding window, cache and block pool,
gated cross-attention (the vlm) and DeepSeek-V2's multi-head latent
attention (MLA, the moe family).

``gqa_apply`` attends over x alone (training, the LLM DENSE steps),
prefills a dense cache and decodes against it; ``gqa_apply_paged``
decodes one token per request against the serving engine's block pool
through ``kernels.ops.paged_attention`` (K4 on the card). Query head
``h`` attends with KV head ``h // G`` (``h = kv·G + g``, G = n_heads /
n_kv_heads), masked scores are set to ``NEG_INF = -2^30``, and q, k and
v carry a bias where ``cfg.qkv_bias`` (qwen), as in the reference. The
mask is causal and, for a layer's ``window`` w > 0, keeps keys with
``q_pos − k_pos < w`` (``attention.py:194-198``).

Without a cache, the route follows the execution policy as in the
reference (``attention.py:152-172``): under a kernel profile
(``kernel_vjp != "ref"``, the cuda default) ``kernels.ops.flash_attention``
runs K2 on (B, H, S, D) copies of q, k and v, causal with the layer's
window, under the contract that the positions are contiguous from 0;
under ``"ref"`` the plain path runs. A config with a sliding-window
pattern (gemma3) takes the plain path in every layer, global ones too:
the reference scans its per-layer window as a traced value, which keeps
every layer off its Pallas kernel (``attention.py:120-131``,
``transformer.py:296-303``). Prefill with a cache stays plain on every
profile, as in the reference.

The plain path is ``_sdpa`` (scores materialized), or, where S ≥ 4096
and the blocks tile S and T (``_blockwise``), ``_sdpa_blockwise``:
the reference's online-softmax prefill over (1024, 1024) blocks,
with the same arithmetic (a block whose every key is masked adds
``exp(0)`` terms that the next live block's rescale by 0 wipes out).
Both stay plain torch matmul and softmax, as MLA and cross-attention
do: the reference computes them in XLA, outside any Pallas kernel.

MLA caches the compressed latent ``c_kv`` (B, T, kv_lora_rank) and one
rope key ``k_rope`` (B, T, rope dim) shared by every head, and
decompresses the whole cache through ``wkv_b`` at every step, as the
reference does; its scale is 1/√(nope + rope dims).

Caches and pools are updated in place and returned (the reference
returns updated copies): a decode step writes one row, not a new cache.

Partitioned (``tp``, a ``launch/shardings.Layout``): where
``attn_sharded``, ``gqa_apply`` runs this rank's n_heads/m query and
n_kv_heads/m KV heads (``wq``/``wk``/``wv`` column-, ``wo`` row-sharded,
the output summed over ``model``) and ``mla_apply`` this rank's n_heads/m
heads (``wq_b``/``wkv_b`` column-, ``wo`` row-sharded; the latent and
the rope key replicated). Cross-attention stays replicated. A cache
whose sequence dim is cut (``cache_specs``: over ``model`` where
attention is replicated, over ``data`` at a global batch of one) holds
this rank's positions: a write lands on the rank that holds the
position, each rank attends over its slice and the slices' row maxima,
sums and weighted values are combined over the cut axes, flash-decode
style (``_sdpa_over``), as the reference's compiler realizes the softmax
over a sharded axis.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.backend import resolve_exec_policy
from repro_torch.kernels import ops
from repro_torch.launch.mesh import _block, max_over, sum_over
from repro_torch.models import layers as L

NEG_INF = -2.0 ** 30
BLOCKWISE_MIN = 4096        # the blockwise prefill from this many queries


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


def _sdpa_blockwise(q, k, v, q_pos, k_pos, window: int, scale: float,
                    bq: int, bk: int):
    """``_sdpa`` with the mask given by positions and ``window`` (0 =
    causal only), over (bq, bk) blocks with an online softmax
    (``repro/models/attention.py:62-111``). q: (B, S, Kh, G, Dk); k: (B,
    T, Kh, Dk); v: (B, T, Kh, Dv) (Dv may differ from Dk: MLA); q_pos:
    (S,), k_pos: (T,). Returns (B, S, Kh, G, Dv) in v's dtype."""
    B, S, Kh, G, _ = q.shape
    T, Dv = k.shape[1], v.shape[-1]
    out = []
    for i in range(0, S, bq):
        qc, qp = q[:, i:i + bq].float(), q_pos[i:i + bq]
        m = torch.full((B, Kh, G, bq), NEG_INF, device=q.device)
        l = torch.zeros((B, Kh, G, bq), device=q.device)
        acc = torch.zeros((B, Kh, G, bq, Dv), device=q.device)
        for j in range(0, T, bk):
            kp = k_pos[j:j + bk]
            s = torch.einsum("bqkgd,btkd->bkgqt", qc,
                             k[:, j:j + bk].float()) * scale
            mask = kp[None, :] <= qp[:, None]
            if window:
                mask = mask & (qp[:, None] - kp[None, :] < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(v.dtype).float(),
                v[:, j:j + bk].float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out.append(o.permute(0, 3, 1, 2, 4))            # (B, bq, Kh, G, Dv)
    return torch.cat(out, dim=1).to(v.dtype)


def _blockwise(cfg, S: int, T: int) -> bool:
    """Whether ``cfg`` attends S queries over T keys blockwise: from
    ``BLOCKWISE_MIN`` queries, where its blocks tile S and T
    (``attention.py:114-117``; the blocks then the config's, clamped to S
    and T)."""
    return (cfg.use_blockwise_attn and S >= BLOCKWISE_MIN
            and S % cfg.attn_block_q == 0 and T % cfg.attn_block_kv == 0)


def _mask(q_pos, k_pos, window: int):
    """(S, T): causal, and within ``window`` where it is not 0."""
    mask = k_pos[None, :] <= q_pos[:, None]
    if window:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    return mask


def _write(cache: dict, new: dict, pos: int, off: int = 0,
           total: int | None = None) -> None:
    """Each ``new[name]`` (B, S, ...) into ``cache[name]`` at ``pos``,
    clamped as ``dynamic_update_slice`` clamps. A cache holding the
    positions [off, off + its length) of ``total`` takes the rows that
    fall there."""
    for name, t in new.items():
        c = cache[name]
        S, T = t.shape[1], c.shape[1]
        at = min(max(pos, 0), (T if total is None else total) - S)
        lo, hi = max(at, off), min(at + S, off + T)
        if lo < hi:
            c[:, lo - off:hi - off] = t[:, lo - at:hi - at].to(c.dtype)


def _seq_slice(tp, axes, T: int):
    """(this rank's first position, the full length) of a cache whose
    sequence dim (T a rank) is cut over ``axes``."""
    idx, n = _block(tp.mesh, axes)
    return idx * T, n * T


def _sdpa_over(q, k, v, q_pos, k_pos, window: int, scale: float, bq: int,
               mesh, axes):
    """Attention of q (B, S, Kh, G, Dk) over the keys this rank holds, k
    (B, T, Kh, Dk) and v (B, T, Kh, Dv) at positions ``k_pos``, combined
    over ``axes``: per query block of ``bq`` rows, this rank's row
    maxima, sums of exponentials and weighted values, then one all-reduce
    max and one all-reduce sum over ``axes`` (a slice with every key
    masked weighs exp(NEG_INF − max) = 0). Returns (B, S, Kh, G, Dv) in
    v's dtype."""
    S = q.shape[1]
    ms, ls, accs = [], [], []
    for i in range(0, S, bq):
        s = torch.einsum("bqkgd,btkd->bkgqt", q[:, i:i + bq].float(),
                         k.float()) * scale
        s = torch.where(_mask(q_pos[i:i + bq], k_pos, window), s, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).float(),
                                 v.float()))
    m, l, acc = torch.cat(ms, -1), torch.cat(ls, -1), torch.cat(accs, -2)
    w = torch.exp(m - max_over(m, mesh, axes))
    both = sum_over(torch.cat([acc * w[..., None], (l * w)[..., None]], -1),
                    mesh, axes)
    out = both[..., :-1] / torch.clamp(both[..., -1:], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)


def _query_block(cfg, S: int) -> int:
    """``_sdpa_over``'s query block: the config's where the blockwise
    prefill would run (``_blockwise``' rule on the queries), else S."""
    if cfg.use_blockwise_attn and S >= BLOCKWISE_MIN \
            and S % cfg.attn_block_q == 0:
        return cfg.attn_block_q
    return S


def _qkv(p, x, cfg, cos, sin, heads: tuple | None = None):
    """Rotated q (B, S, h, hd), k and v (B, S, kh, hd); ``heads`` (h, kh)
    where this rank holds a share of them."""
    B, S, _ = x.shape
    h, kh = heads or (cfg.n_heads, cfg.n_kv_heads)
    hd = cfg.head_dim
    q = L.apply_rope(L.linear(p["wq"], x).reshape(B, S, h, hd), cos, sin)
    k = L.apply_rope(L.linear(p["wk"], x).reshape(B, S, kh, hd), cos, sin)
    v = L.linear(p["wv"], x).reshape(B, S, kh, hd)
    return q, k, v


def gqa_apply(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              window: int = 0, cache: dict | None = None,
              cache_pos: int | None = None, tp=None):
    """Self-attention. x: (B, S, D); positions: (S,) absolute positions;
    ``window``: the layer's window (0: causal only).

    Prefill: a cache to fill from ``cache_pos`` (default positions[0]).
    Decode: S == 1 against the cached K/V. ``cache=None`` attends over x
    alone, through K2 under a kernel profile without a sliding-window
    pattern (positions must then be 0..S-1). ``tp``: partitioned (module
    doc). Returns (y, cache)."""
    B, S, _ = x.shape
    T = S if cache is None else cache["k"].shape[1]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sharded = tp is not None and tp.attn
    if sharded:
        h, kh = tp.local(h, "n_heads"), tp.local(kh, "n_kv_heads")
        x = tp.enter(x)
    cos, sin = L.rope_cos_sin(positions, hd, cfg.rope_theta)
    q, k, v = _qkv(p, x, cfg, cos, sin, (h, kh))

    def out_proj(out):
        y = L.linear(p["wo"], out.reshape(B, S, h * hd).to(x.dtype))
        return tp.sum(y) if sharded else y

    pol = resolve_exec_policy(cfg, device=x.device)
    if cache is None and pol.kernel_vjp != "ref" and not cfg.sliding_window:
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True,
                                  window=window, policy=pol)
        return out_proj(out.transpose(1, 2)), None

    q = q.reshape(B, S, kh, h // kh, hd)
    scale = 1.0 / math.sqrt(hd)
    seq = tp.kv_seq if tp is not None and cache is not None else ()
    if seq:
        off, total = _seq_slice(tp, seq, T)
        _write(cache, {"k": k, "v": v},
               int(positions[0] if cache_pos is None else cache_pos), off,
               total)
        k_pos = torch.arange(off, off + T, device=x.device)
        out = _sdpa_over(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                         positions, k_pos, window, scale,
                         _query_block(cfg, S), tp.mesh, seq)
        return out_proj(out), cache
    if cache is not None:
        _write(cache, {"k": k, "v": v},
               int(positions[0] if cache_pos is None else cache_pos))
        k_all, v_all = cache["k"], cache["v"]
        k_pos = torch.arange(T, device=x.device)
    else:
        k_all, v_all, k_pos = k, v, positions
    k_all, v_all = k_all.to(q.dtype), v_all.to(q.dtype)
    if _blockwise(cfg, S, T):
        out = _sdpa_blockwise(q, k_all, v_all, positions, k_pos, window,
                              scale, min(cfg.attn_block_q, S),
                              min(cfg.attn_block_kv, T))
    else:
        out = _sdpa(q, k_all, v_all, _mask(positions, k_pos, window), scale)
    return out_proj(out), cache


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


# -------------------------------------------------------- cross-attention --

def cross_attn_init(cfg, *, generator, dtype, lead: tuple = ()) -> dict:
    """Gated cross-attention onto the stubbed vision stream, its tanh
    gate zero at init (``attention.py:259-274``)."""
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = cfg.vision_dim or d
    kw = {"generator": generator, "dtype": dtype, "lead": lead}
    return {"wq": L.linear_init(d, h * hd, **kw),
            "wk": L.linear_init(src, kh * hd, **kw),
            "wv": L.linear_init(src, kh * hd, **kw),
            "wo": L.linear_init(h * hd, d, **kw),
            "gate": torch.zeros(lead, dtype=dtype, device=generator.device)}


def cross_attn_apply(p: dict, x: torch.Tensor, src: torch.Tensor,
                     cfg) -> torch.Tensor:
    """x: (B, S, D) attends over every row of src: (B, P, src_dim);
    the output scaled by tanh(gate)."""
    B, S, _ = x.shape
    P = src.shape[1]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = src.to(x.dtype)
    q = L.linear(p["wq"], x).reshape(B, S, kh, h // kh, hd)
    k = L.linear(p["wk"], src).reshape(B, P, kh, hd)
    v = L.linear(p["wv"], src).reshape(B, P, kh, hd)
    mask = torch.ones((S, P), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(hd))
    y = L.linear(p["wo"], out.reshape(B, S, h * hd).to(x.dtype))
    return torch.tanh(p["gate"].to(x.dtype)) * y


# -------------------------------------------------------------------- MLA --

def mla_init(cfg, *, generator, dtype, lead: tuple = ()) -> dict:
    """DeepSeek-V2's attention (``attention.py:292-311``): q through the
    low-rank ``wq_a``/``q_norm``/``wq_b`` where ``q_lora_rank``, else
    ``wq``; the KV latent and the shared rope key from ``wkv_a``."""
    d, h = cfg.d_model, cfg.n_heads
    qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    kw = {"generator": generator, "dtype": dtype, "lead": lead}
    dev = generator.device
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = L.linear_init(d, cfg.q_lora_rank, **kw)
        p["q_norm"] = L.rmsnorm_init(cfg.q_lora_rank, dtype=dtype,
                                     device=dev, lead=lead)
        p["wq_b"] = L.linear_init(cfg.q_lora_rank, h * qd, **kw)
    else:
        p["wq"] = L.linear_init(d, h * qd, **kw)
    p["wkv_a"] = L.linear_init(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                               **kw)
    p["kv_norm"] = L.rmsnorm_init(cfg.kv_lora_rank, dtype=dtype, device=dev,
                                  lead=lead)
    p["wkv_b"] = L.linear_init(
        cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim), **kw)
    p["wo"] = L.linear_init(h * cfg.v_head_dim, d, **kw)
    return p


def mla_cache_init(cfg, batch: int, max_len: int, dtype, device,
                   lead: tuple = ()) -> dict:
    """The compressed latent and the shared rope key, zeros."""
    return {"c_kv": torch.zeros((*lead, batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((*lead, batch, max_len,
                                   cfg.qk_rope_head_dim), dtype=dtype,
                                  device=device)}


def mla_apply(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              cache: dict | None = None, cache_pos: int | None = None,
              window: int = 0, tp=None):
    """MLA over x: (B, S, D) (``attention.py:319-380``), with a cache as
    ``gqa_apply`` takes one (the latent and the rope key written at
    ``cache_pos``). ``tp``: partitioned (module doc). Returns (y,
    cache)."""
    B, S, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    sharded = tp is not None and tp.attn
    if sharded:
        h = tp.local(h, "n_heads")

    def local_in(t):            # a replicated tensor into this rank's heads
        return tp.enter(t) if sharded else t

    if cfg.q_lora_rank:
        q = L.linear(p["wq_b"], local_in(L.rmsnorm(
            p["q_norm"], L.linear(p["wq_a"], x))))
    else:
        q = L.linear(p["wq"], local_in(x))
    q = q.reshape(B, S, h, nd + rd)
    cos, sin = L.rope_cos_sin(positions, rd, cfg.rope_theta)
    qn, qr = q[..., :nd], L.apply_rope(q[..., nd:], cos, sin)
    kv_a = L.linear(p["wkv_a"], x)
    c_kv = L.rmsnorm(p["kv_norm"], kv_a[..., :r])
    k_rope = L.apply_rope(kv_a[..., None, r:], cos, sin)[:, :, 0]

    seq = tp.latent_seq if tp is not None and cache is not None else ()
    if cache is not None:
        T = cache["c_kv"].shape[1]
        off, total = _seq_slice(tp, seq, T) if seq else (0, None)
        _write(cache, {"c_kv": c_kv, "k_rope": k_rope},
               int(positions[0] if cache_pos is None else cache_pos), off,
               total)
        c_all, r_all = cache["c_kv"], cache["k_rope"]
        k_pos = torch.arange(off, off + T, device=x.device)
    else:
        c_all, r_all, k_pos = c_kv, k_rope, positions
    T = c_all.shape[1]
    kv = L.linear(p["wkv_b"], local_in(c_all.to(x.dtype))).reshape(
        B, T, h, nd + vd)
    kn, v = kv[..., :nd], kv[..., nd:]
    r_all = local_in(r_all.to(x.dtype))
    scale = 1.0 / math.sqrt(nd + rd)

    def out_proj(out):
        y = L.linear(p["wo"], out.reshape(B, S, h * vd).to(x.dtype))
        return tp.sum(y) if sharded else y

    if seq:
        q_cat = torch.cat([qn, qr], -1)[:, :, :, None, :]        # G = 1
        k_cat = torch.cat([kn, r_all[:, :, None, :].expand(B, T, h, rd)],
                          -1)
        out = _sdpa_over(q_cat, k_cat, v, positions, k_pos, window, scale,
                         _query_block(cfg, S), tp.mesh, seq)[:, :, :, 0]
        return out_proj(out), cache
    if _blockwise(cfg, S, T):
        q_cat = torch.cat([qn, qr], -1)[:, :, :, None, :]        # G = 1
        k_cat = torch.cat([kn, r_all[:, :, None, :].expand(B, T, h, rd)],
                          -1)
        out = _sdpa_blockwise(q_cat, k_cat, v, positions, k_pos, window,
                              scale, min(cfg.attn_block_q, S),
                              min(cfg.attn_block_kv, T))[:, :, :, 0]
    else:
        scores = (torch.einsum("bshd,bthd->bhst", qn.float(), kn.float())
                  + torch.einsum("bshd,btd->bhst", qr.float(),
                                 r_all.float())) * scale
        scores = torch.where(_mask(positions, k_pos, window)[None, None],
                             scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhst,bthd->bshd", probs, v)
    return out_proj(out), cache
