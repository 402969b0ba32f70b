"""The LM trunk of the dense and audio (attention), ssm (Mamba-2) and
hybrid (Zamba2) families (``repro/models/transformer.py:59-574``).

Parameters are a dict of tensors named as the reference's tree:
``embed.table``, ``final_norm.scale`` and ``blocks``, whose leaves carry
a leading layer axis (the reference scans them; the port loops over the
layers, viewing each by ``layer`` or, in ``forward``, by one ``unstack``).
A hybrid's ``blocks`` are stacked (n_super, attn_every, ...), its
``tail`` (n_layers % attn_every, ...), and its one weight-tied ``shared``
attention block runs after each super-block. Caches and block pools keep
the reference's layouts as well, so ``interop`` carries either across as
it is. The audio family (musicgen) runs the dense blocks over codec
tokens.

  * ``init_model`` / ``init_cache`` — parameters drawn from a
    ``torch.Generator``; a dense (L, B, T, Kh, Dh) KV cache and the
    mamba blocks' (L, B, ...) states, zeros.
  * ``forward`` — over ``tokens`` or soft ``embeds`` (the token
    generator's), without a cache (K2 and K3 on the card, each layer
    recomputed in the backward when ``remat``), prefill into a cache
    (K3f seeded with the state) and decode against it (``decode=True``:
    the mamba blocks' one-token step).
  * ``forward_paged`` — one continuous-batching decode step over the
    block pool, through K4 on the card; the mamba blocks step their
    per-slot states.
  * ``loss_fn`` — next-token cross-entropy.

Other families (moe, vlm) and sliding-window patterns raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.backend import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

FAMILIES = ("dense", "audio", "ssm", "hybrid")


def check_ported(cfg) -> None:
    """Raise unless the port has ``cfg``'s family: dense or audio (the
    same blocks), ssm or hybrid, every attention layer global."""
    if cfg.family not in FAMILIES or cfg.sliding_window:
        raise NotImplementedError(
            f"family {cfg.family!r} (sliding_window={cfg.sliding_window}) "
            "is not ported yet; the port runs the dense, audio, ssm and "
            "hybrid families without a sliding window (ROADMAP.md lists the "
            "slices that bring the others)")


def hybrid_shape(cfg) -> tuple[int, int]:
    """(super-blocks, tail mamba blocks) of a hybrid: ``n_layers`` mamba
    blocks, the shared block after every ``attn_every`` of them."""
    return cfg.n_layers // cfg.attn_every, cfg.n_layers % cfg.attn_every


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
    d = cfg.d_model
    params = {"embed": L.embed_init(cfg.vocab_size, d, **kw),
              "final_norm": L.rmsnorm_init(d, dtype=dtype, device=dev)}

    def dense_blocks(lead):
        return {"norm1": L.rmsnorm_init(d, dtype=dtype, device=dev, lead=lead),
                "attn": A.gqa_init(cfg, lead=lead, **kw),
                "norm2": L.rmsnorm_init(d, dtype=dtype, device=dev, lead=lead),
                "mlp": L.swiglu_init(d, cfg.d_ff, lead=lead, **kw)}

    def ssm_blocks(lead):
        return {"norm": L.rmsnorm_init(d, dtype=dtype, device=dev, lead=lead),
                "mamba": S.mamba2_init(cfg, lead=lead, **kw)}

    if cfg.family in ("dense", "audio"):
        params["blocks"] = dense_blocks((cfg.n_layers,))
    elif cfg.family == "ssm":
        params["blocks"] = ssm_blocks((cfg.n_layers,))
    else:
        n_super, tail = hybrid_shape(cfg)
        params["blocks"] = ssm_blocks((n_super, cfg.attn_every))
        if tail:
            params["tail"] = ssm_blocks((tail,))
        params["shared"] = dense_blocks(())

    def to_dev(tree):
        return {k: to_dev(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    return to_dev(params)


def init_cache(cfg, batch: int, max_len: int, *, device="cuda") -> dict:
    """Zeros in the reference's layout: ``{"layers": {"k", "v"}}`` (L, B,
    T, Kh, Dh) for the attention families; the mamba blocks' states
    stacked as their parameters (``"layers"``, and a hybrid's ``"tail"``)
    beside a hybrid's shared block's KV cache (``"shared"``, one per
    application)."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    if cfg.family in ("dense", "audio"):
        return {"layers": A.gqa_cache_init(cfg, batch, max_len, dtype, dev,
                                           lead=(cfg.n_layers,))}
    if cfg.family == "ssm":
        return {"layers": S.mamba2_state_init(cfg, batch, dtype, dev,
                                              lead=(cfg.n_layers,))}
    n_super, tail = hybrid_shape(cfg)
    c = {"layers": S.mamba2_state_init(cfg, batch, dtype, dev,
                                       lead=(n_super, cfg.attn_every)),
         "shared": A.gqa_cache_init(cfg, batch, max_len, dtype, dev,
                                    lead=(n_super,))}
    if tail:
        c["tail"] = S.mamba2_state_init(cfg, batch, dtype, dev, lead=(tail,))
    return c


def _dense_block(p, x, cfg, positions, cache, cache_pos):
    h, _ = A.gqa_apply(p["attn"], L.rmsnorm(p["norm1"], x), cfg,
                       positions=positions, cache=cache, cache_pos=cache_pos)
    x = x + h
    return x + L.swiglu(p["mlp"], L.rmsnorm(p["norm2"], x))


def _ssm_block(p, x, cfg, state, decode):
    """x + mamba(norm(x)); a given state (views of the cache) is
    overwritten with the new one."""
    h, new = S.mamba2_apply(p["mamba"], L.rmsnorm(p["norm"], x), cfg,
                            state=state, decode=decode)
    if state is not None:
        for k, t in new.items():
            state[k].copy_(t)
    return x + h


def _layers(cfg, params: dict) -> list:
    """The trunk in order: ("ssm", params, state index) and ("attn",
    params, application index) entries; the state index addresses
    ``init_cache``'s tree."""
    if cfg.family in ("dense", "audio"):
        return [("attn", p, ("layers", i)) for i, p in
                enumerate(unstack(params["blocks"], cfg.n_layers))]
    if cfg.family == "ssm":
        return [("ssm", p, ("layers", i)) for i, p in
                enumerate(unstack(params["blocks"], cfg.n_layers))]
    n_super, tail = hybrid_shape(cfg)
    out = []
    for j, grp in enumerate(unstack(params["blocks"], n_super)):
        out += [("ssm", p, ("layers", j, i))
                for i, p in enumerate(unstack(grp, cfg.attn_every))]
        out.append(("attn", params["shared"], ("shared", j)))
    if tail:
        out += [("ssm", p, ("tail", i))
                for i, p in enumerate(unstack(params["tail"], tail))]
    return out


def _at(cache: dict, index: tuple) -> dict:
    """The per-layer views of ``cache`` at ``index`` (a name, then stack
    indices)."""
    tree = cache[index[0]]
    for i in index[1:]:
        tree = layer(tree, i)
    return tree


def forward(params: dict, cfg, *, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, cache: dict | None = None,
            cache_pos: int | None = None, decode: bool = False,
            remat: bool | None = None):
    """Run the trunk over ``tokens`` (B, S) or soft ``embeds`` (B, S, D),
    cast to ``cfg.dtype``. positions: (S,) absolute positions (default
    arange(S)). cache: from ``init_cache``; prefill fills it and decode
    (``decode=True`` for the mamba blocks' one-token step; the attention
    blocks decode whenever S == 1 against a cache) updates it, in place.
    Without a cache, ``remat`` (default ``cfg.remat``) recomputes each
    block in the backward (``torch.utils.checkpoint``). Returns (logits
    (B, S, V), cache)."""
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
    for kind, p_l, idx in _layers(cfg, params):
        if kind == "attn":
            fn, args = _dense_block, (cfg, positions, None, None)
            if cache is not None:
                args = (cfg, positions, _at(cache, idx), cache_pos)
        else:
            fn, args = _ssm_block, (cfg, None, False)
            if cache is not None:
                args = (cfg, _at(cache, idx), decode)
        if use_remat:
            x = checkpoint(fn, p_l, x, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = fn(p_l, x, *args)
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
    attention blocks swap the cache attention for the paged gather (K4 on
    the card, once per attention block); the mamba blocks take their
    one-token step on the slot-indexed states (the batch axis is the slot
    axis). Returns (logits (R, 1, V), cache)."""
    check_ported(cfg)
    x = L.embed(params["embed"], tokens, compute_dtype=getattr(torch,
                                                               cfg.dtype))
    for kind, p, idx in _layers(cfg, params):
        if kind == "ssm":
            x = _ssm_block(p, x, cfg, _at(cache, idx), True)
            continue
        h, _ = A.gqa_apply_paged(p["attn"], L.rmsnorm(p["norm1"], x), cfg,
                                 positions=positions, pool=_at(cache, idx),
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
