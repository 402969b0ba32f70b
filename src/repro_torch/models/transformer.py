"""The LM trunk of the dense and audio (attention) families
(``repro/models/transformer.py:64,134,176,263,458-574``).

Parameters are a dict of tensors named as the reference's tree:
``embed.table``, ``final_norm.scale`` and ``blocks``, whose leaves carry
a leading layer axis (the reference scans them; the port loops over the
layers, viewing each by ``layer`` or, in ``forward``, by one ``unstack``). Caches and block pools keep the
reference's layouts as well, so ``interop`` carries either across as it
is. The audio family (musicgen) runs the dense blocks over codec tokens.

  * ``init_model`` / ``init_cache`` — parameters drawn from a
    ``torch.Generator``; a dense (L, B, T, Kh, Dh) cache of zeros.
  * ``forward`` — over ``tokens`` or soft ``embeds`` (the token
    generator's), without a cache (K2 on the card, each layer recomputed
    in the backward when ``remat``), prefill into a cache and decode
    against it.
  * ``forward_paged`` — one continuous-batching decode step over the
    block pool, through K4 on the card.
  * ``loss_fn`` — next-token cross-entropy.

Other families (moe, ssm, hybrid, vlm) and sliding-window patterns raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.backend import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def check_ported(cfg) -> None:
    """Raise unless the port has ``cfg``'s family: dense or audio (the
    same blocks), every layer global."""
    if cfg.family not in ("dense", "audio") or cfg.sliding_window:
        raise NotImplementedError(
            f"family {cfg.family!r} (sliding_window={cfg.sliding_window}) "
            "is not ported yet; the port runs the dense and audio families "
            "without a sliding window (ROADMAP.md lists the slices that "
            "bring the others)")


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: every leaf indexed on its leading
    axis (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unstack(tree: dict, n: int) -> list:
    """The ``n`` layers of a stacked tree as views, one ``unbind`` a leaf:
    its backward stacks a leaf's gradients once, where indexing each
    layer (``layer``) would add ``n`` full-size zero-padded gradients."""
    per = {k: unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
           for k, v in tree.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def leaves(tree: dict) -> list:
    """The tensors of a nested dict, in insertion order."""
    return [t for v in tree.values()
            for t in (leaves(v) if isinstance(v, dict) else [v])]


def init_model(cfg, *, seed: int = 0, generator: torch.Generator | None = None,
               device="cuda") -> dict:
    """Random parameters: linear weights N(0, 1/d_in), the embedding
    N(0, 1/d_model), norms at one, as the reference draws them. Drawn in
    float32 on the generator's device (default: a generator seeded with
    ``seed`` on ``device``), then cast to ``cfg.param_dtype``."""
    check_ported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    kw = {"generator": generator, "dtype": dtype}
    lead = (cfg.n_layers,)
    d = cfg.d_model
    params = {
        "embed": L.embed_init(cfg.vocab_size, d, **kw),
        "final_norm": L.rmsnorm_init(d, dtype=dtype, device=dev),
        "blocks": {
            "norm1": L.rmsnorm_init(d, dtype=dtype, device=dev, lead=lead),
            "attn": A.gqa_init(cfg, lead=lead, **kw),
            "norm2": L.rmsnorm_init(d, dtype=dtype, device=dev, lead=lead),
            "mlp": L.swiglu_init(d, cfg.d_ff, lead=lead, **kw)}}

    def to_dev(tree):
        return {k: to_dev(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    return to_dev(params)


def init_cache(cfg, batch: int, max_len: int, *, device="cuda") -> dict:
    check_ported(cfg)
    return {"layers": A.gqa_cache_init(
        cfg, batch, max_len, getattr(torch, cfg.dtype),
        resolve_device(device), lead=(cfg.n_layers,))}


def _dense_block(p, x, cfg, positions, cache, cache_pos):
    h, _ = A.gqa_apply(p["attn"], L.rmsnorm(p["norm1"], x), cfg,
                       positions=positions, cache=cache, cache_pos=cache_pos)
    x = x + h
    return x + L.swiglu(p["mlp"], L.rmsnorm(p["norm2"], x))


def forward(params: dict, cfg, *, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, cache: dict | None = None,
            cache_pos: int | None = None, remat: bool | None = None):
    """Run the trunk over ``tokens`` (B, S) or soft ``embeds`` (B, S, D),
    cast to ``cfg.dtype``. positions: (S,) absolute positions (default
    arange(S)). cache: from ``init_cache``; prefill fills it and decode
    updates it, in place. Without a cache, ``remat`` (default
    ``cfg.remat``) recomputes each layer in the backward
    (``torch.utils.checkpoint``). Returns (logits (B, S, V), cache)."""
    check_ported(cfg)
    dtype = getattr(torch, cfg.dtype)
    if embeds is None:
        x = L.embed(params["embed"], tokens, compute_dtype=dtype)
    else:
        x = embeds.to(dtype)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    use_remat = (cfg.remat if remat is None else remat) and cache is None \
        and torch.is_grad_enabled()
    for i, p_l in enumerate(unstack(params["blocks"], cfg.n_layers)):
        if use_remat:
            x = checkpoint(_dense_block, p_l, x, cfg, positions, None, None,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            c_l = None if cache is None else layer(cache["layers"], i)
            x = _dense_block(p_l, x, cfg, positions, c_l, cache_pos)
    x = L.rmsnorm(params["final_norm"], x)
    return L.unembed(params["embed"], x), cache


def forward_paged(params: dict, cfg, *, tokens: torch.Tensor,
                  positions: torch.Tensor, cache: dict,
                  block_tables: torch.Tensor):
    """One continuous-batching decode step over the block pool
    (``launch/paging.init_paged_cache``).

    tokens: (R, 1) int — each scheduler slot's incoming token; positions:
    (R,) int32 — its absolute position (inactive slots pass 0, and their
    writes land in the null block); block_tables: (R, M) int32. The
    dense decode with the cache attention swapped for the paged gather
    (K4 on the card, once per layer). Returns (logits (R, 1, V), cache)."""
    check_ported(cfg)
    x = L.embed(params["embed"], tokens, compute_dtype=getattr(torch,
                                                               cfg.dtype))
    for i in range(cfg.n_layers):
        p = layer(params["blocks"], i)
        h, _ = A.gqa_apply_paged(p["attn"], L.rmsnorm(p["norm1"], x), cfg,
                                 positions=positions,
                                 pool=layer(cache["layers"], i),
                                 block_tables=block_tables)
        x = x + h
        x = x + L.swiglu(p["mlp"], L.rmsnorm(p["norm2"], x))
    x = L.rmsnorm(params["final_norm"], x)
    return L.unembed(params["embed"], x), cache


def loss_fn(params: dict, cfg, batch: dict):
    """Next-token cross-entropy over ``batch["tokens"]`` (B, S) against
    ``batch["labels"]`` (B, S): float32 log-softmax NLL, averaged over
    the tokens, or over ``batch["mask"]`` where given. Returns (loss,
    {"ce", "moe_aux"}); the dense families have no router, so moe_aux is
    0 and the loss is the cross-entropy."""
    logits, _ = forward(params, cfg, tokens=batch["tokens"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        loss = nll.mean()
    else:
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss, {"ce": loss, "moe_aux": torch.zeros((), device=loss.device)}
