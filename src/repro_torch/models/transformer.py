"""The LM trunk of every family the reference registers
(``repro/models/transformer.py:59-574``): dense (llama, qwen, phi,
gemma3's sliding-window pattern) and audio (musicgen, the dense blocks
over codec tokens), moe (DeepSeek-V2: MLA attention, a routed and shared
MoE, layer 0 a dense MLP), vlm (llama-3.2-vision: self layers and gated
cross-attention onto stubbed patch embeddings), ssm (Mamba-2) and hybrid
(Zamba2).

Parameters are a dict of tensors named as the reference's tree:
``embed.table``, ``final_norm.scale`` and ``blocks``, whose leaves carry
a leading layer axis (the reference scans them; the port loops over the
layers, viewing each by ``layer`` or, in ``forward``, by one ``unstack``).
A hybrid's ``blocks`` are stacked (n_super, attn_every, ...), its
``tail`` (n_layers % attn_every, ...), and its one weight-tied ``shared``
attention block runs after each super-block. A vlm's ``blocks`` are
stacked (n_super, cross_every, ...) and its ``cross`` (n_super, ...), one
cross block after each super-block. A moe's ``blocks`` are its MoE
layers and ``block0`` its first, dense-MLP layer (MLP width
``d_ff_expert·(top_k + n_shared_experts)``) where ``first_dense``.
Caches and block pools keep the reference's layouts as well (MLA's
``c_kv`` and ``k_rope``, a moe's ``layer0``, a vlm's ``layers`` (n_super,
cross_every, ...)), so ``interop`` carries either across as it is.

  * ``init_model`` / ``init_cache`` — parameters drawn from a
    ``torch.Generator``; zero caches: dense (…, B, T, Kh, Dh) KV, MLA's
    latent, the mamba blocks' (…, B, ...) states.
  * ``forward`` — over ``tokens`` or soft ``embeds`` (the token
    generator's), without a cache (K2 and K3 on the card, each layer
    recomputed in the backward when ``remat``), prefill into a cache
    (K3f seeded with the state) and decode against it (``decode=True``:
    the mamba blocks' one-token step); a vlm takes ``vision`` (B, P,
    vision_dim); ``with_aux`` adds the summed MoE load-balance term.
    gemma3's layers take ``layer_windows`` and the plain attention path.
  * ``forward_paged`` — one continuous-batching decode step over the
    block pool, through K4 on the card; the mamba blocks step their
    per-slot states (the families ``launch/paging.supports_paged``
    takes).
  * ``loss_fn`` — next-token cross-entropy plus ``router_aux_coef`` times
    the MoE auxiliary; every family trains through it, as in the
    reference (gemma3's windows and MLA on the plain path, a vlm's self
    layers through K2 forward and backward on the card, its cross blocks
    and the MoE layers plain).

``forward`` and ``loss_fn`` take ``tp`` (a ``launch/shardings.Layout``):
the partitioned trunk, every layer on this rank's shards as
``param_specs`` cuts them and the batch as the step cut it (module docs
of ``layers``, ``attention``, ``ssm`` and ``moe``); the logits are then
this rank's vocabulary columns where the embedding is cut, and
``loss_fn`` takes the cross-entropy over them vocabulary-parallel and
the mean over ``batch_axes``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.backend import resolve_device
from repro_torch.launch.mesh import axis_size, max_over, sum_over
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

FAMILIES = ("dense", "audio", "moe", "ssm", "hybrid", "vlm")


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def hybrid_shape(cfg) -> tuple[int, int]:
    """(super-blocks, tail mamba blocks) of a hybrid: ``n_layers`` mamba
    blocks, the shared block after every ``attn_every`` of them."""
    return cfg.n_layers // cfg.attn_every, cfg.n_layers % cfg.attn_every


def vlm_shape(cfg) -> tuple[int, int]:
    """(super-blocks, self layers a super-block) of a vlm: ``n_layers``
    counts ``cross_every`` self layers and one cross layer a
    super-block."""
    per = cfg.cross_every
    n_super = cfg.n_layers // (per + 1)
    if n_super * (per + 1) != cfg.n_layers:
        raise ValueError(f"vlm layout must tile: {cfg.n_layers} layers in "
                         f"super-blocks of {per} + 1")
    return n_super, per


def layer_windows(cfg) -> list:
    """Each layer's sliding window, 0 for a global layer (gemma3: every
    ``global_every``-th layer global, the others ``sliding_window``)."""
    w = [cfg.sliding_window] * cfg.n_layers
    if cfg.sliding_window and cfg.global_every:
        for i in range(cfg.global_every - 1, cfg.n_layers, cfg.global_every):
            w[i] = 0
    return w


def n_moe_layers(cfg) -> int:
    """The MoE layers of a moe: all but a ``first_dense`` layer 0."""
    return cfg.n_layers - (1 if cfg.first_dense else 0)


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


def _device(device) -> torch.device:
    """``resolve_device``, which also passes the meta device."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def init_model(cfg, *, seed: int = 0, generator: torch.Generator | None = None,
               device="cuda") -> dict:
    """Random parameters: linear weights N(0, 1/d_in), the embedding
    N(0, 1/d_model), the experts N(0, 1/d_in) (the router float32), norms
    at one, gates at zero, as the reference draws them. Drawn in float32
    on the generator's device (default: a generator seeded with ``seed``
    on ``device``), then cast to ``cfg.param_dtype``. On the meta device
    nothing is drawn: the tree's shapes and dtypes alone
    (``launch/specs.abstract_params``)."""
    _check_family(cfg)
    dev = _device(device)
    if generator is None:
        generator = L.MetaDraws() if dev.type == "meta" \
            else torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    kw = {"generator": generator, "dtype": dtype}
    d = cfg.d_model
    params = {"embed": L.embed_init(cfg.vocab_size, d, **kw),
              "final_norm": L.rmsnorm_init(d, dtype=dtype, device=dev)}

    def norm(lead):
        return L.rmsnorm_init(d, dtype=dtype, device=dev, lead=lead)

    def attn(lead):
        init = A.mla_init if cfg.kv_lora_rank else A.gqa_init
        return init(cfg, lead=lead, **kw)

    def dense_blocks(lead, d_ff=cfg.d_ff):
        return {"norm1": norm(lead), "attn": attn(lead), "norm2": norm(lead),
                "mlp": L.swiglu_init(d, d_ff, lead=lead, **kw)}

    def ssm_blocks(lead):
        return {"norm": norm(lead), "mamba": S.mamba2_init(cfg, lead=lead,
                                                           **kw)}

    if cfg.family in ("dense", "audio"):
        params["blocks"] = dense_blocks((cfg.n_layers,))
    elif cfg.family == "moe":
        lead = (n_moe_layers(cfg),)
        params["blocks"] = {"norm1": norm(lead), "attn": attn(lead),
                            "norm2": norm(lead),
                            "moe": M.moe_init(cfg, lead=lead, **kw)}
        if cfg.first_dense:
            params["block0"] = dense_blocks(
                (), cfg.d_ff_expert * (cfg.top_k + cfg.n_shared_experts))
    elif cfg.family == "ssm":
        params["blocks"] = ssm_blocks((cfg.n_layers,))
    elif cfg.family == "hybrid":
        n_super, tail = hybrid_shape(cfg)
        params["blocks"] = ssm_blocks((n_super, cfg.attn_every))
        if tail:
            params["tail"] = ssm_blocks((tail,))
        params["shared"] = dense_blocks(())
    else:
        n_super, per = vlm_shape(cfg)
        lead = (n_super,)
        params["blocks"] = dense_blocks((n_super, per))
        params["cross"] = {
            "norm1": norm(lead),
            "xattn": A.cross_attn_init(cfg, lead=lead, **kw),
            "norm2": norm(lead),
            "mlp": L.swiglu_init(d, cfg.d_ff, lead=lead, **kw),
            "mlp_gate": torch.zeros(lead, dtype=dtype, device=dev)}

    def to_dev(tree):
        return {k: to_dev(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    return to_dev(params)


def init_cache(cfg, batch: int, max_len: int, *, device="cuda") -> dict:
    """Zeros in the reference's layout: ``{"layers": {"k", "v"}}`` (L, B,
    T, Kh, Dh) for the dense and audio families, (n_super, cross_every,
    B, T, Kh, Dh) for a vlm; a moe's MLA ``{"c_kv", "k_rope"}`` for its
    MoE layers (``"layers"``) and its layer 0 (``"layer0"``); the mamba
    blocks' states stacked as their parameters (``"layers"``, and a
    hybrid's ``"tail"``) beside a hybrid's shared block's KV cache
    (``"shared"``, one per application). ``device`` may be meta."""
    _check_family(cfg)
    dev = _device(device)
    dtype = getattr(torch, cfg.dtype)

    def attn_cache(lead):
        init = A.mla_cache_init if cfg.kv_lora_rank else A.gqa_cache_init
        return init(cfg, batch, max_len, dtype, dev, lead=lead)

    if cfg.family in ("dense", "audio"):
        return {"layers": attn_cache((cfg.n_layers,))}
    if cfg.family == "moe":
        c = {"layers": attn_cache((n_moe_layers(cfg),))}
        if cfg.first_dense:
            c["layer0"] = attn_cache(())
        return c
    if cfg.family == "vlm":
        return {"layers": attn_cache(vlm_shape(cfg))}
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


def _attn(p, x, cfg, positions, window, cache, cache_pos, tp=None):
    apply = A.mla_apply if cfg.kv_lora_rank else A.gqa_apply
    return apply(p, x, cfg, positions=positions, window=window, cache=cache,
                 cache_pos=cache_pos, tp=tp)


def _dense_block(p, x, cfg, positions, window, cache, cache_pos, tp=None):
    """x + attn(norm(x)), then x + swiglu(norm(x)); MLA attention in a
    moe's layer 0 (``_apply_mla_dense0``)."""
    h, _ = _attn(p["attn"], L.rmsnorm(p["norm1"], x), cfg, positions, window,
                 cache, cache_pos, tp)
    x = x + h
    return x + L.swiglu(p["mlp"], L.rmsnorm(p["norm2"], x), tp)


def _moe_block(p, x, cfg, positions, cache, cache_pos, mesh, dp_axes,
               tp=None):
    """x + attn(norm(x)), then x + moe(norm(x)) (expert-parallel on a
    mesh with a ``model`` axis); returns (x, aux)."""
    h, _ = _attn(p["attn"], L.rmsnorm(p["norm1"], x), cfg, positions, 0,
                 cache, cache_pos, tp)
    x = x + h
    y, aux = M.moe_apply(p["moe"], L.rmsnorm(p["norm2"], x), cfg,
                         mesh=mesh, dp_axes=dp_axes, tp=tp)
    return x + y, aux


def _cross_block(p, x, cfg, vision, tp=None):
    """x + gated cross-attention onto ``vision`` (replicated), then x +
    tanh(mlp_gate)·swiglu(norm(x))."""
    x = x + A.cross_attn_apply(p["xattn"], L.rmsnorm(p["norm1"], x), vision,
                               cfg)
    return x + torch.tanh(p["mlp_gate"].to(x.dtype)) \
        * L.swiglu(p["mlp"], L.rmsnorm(p["norm2"], x), tp)


def _ssm_block(p, x, cfg, state, decode, tp=None):
    """x + mamba(norm(x)); a given state (views of the cache) is
    overwritten with the new one."""
    h, new = S.mamba2_apply(p["mamba"], L.rmsnorm(p["norm"], x), cfg,
                            state=state, decode=decode, tp=tp)
    if state is not None:
        for k, t in new.items():
            state[k].copy_(t)
    return x + h


def _layers(cfg, params: dict) -> list:
    """The trunk in order: (kind, params, cache index, window) with kind
    "attn" (a dense-MLP block), "moe", "cross" (no cache) or "ssm"; the
    cache index (a name, then stack indices) addresses ``init_cache``'s
    tree."""
    fam = cfg.family
    if fam in ("dense", "audio"):
        return [("attn", p, ("layers", i), w) for i, (p, w) in enumerate(
            zip(unstack(params["blocks"], cfg.n_layers), layer_windows(cfg)))]
    if fam == "moe":
        out = [("attn", params["block0"], ("layer0",), 0)] \
            if cfg.first_dense else []
        return out + [("moe", p, ("layers", i), 0) for i, p in enumerate(
            unstack(params["blocks"], n_moe_layers(cfg)))]
    if fam == "ssm":
        return [("ssm", p, ("layers", i), 0) for i, p in
                enumerate(unstack(params["blocks"], cfg.n_layers))]
    out = []
    if fam == "vlm":
        n_super, per = vlm_shape(cfg)
        for j, (grp, cross) in enumerate(zip(
                unstack(params["blocks"], n_super),
                unstack(params["cross"], n_super))):
            out += [("attn", p, ("layers", j, i), 0)
                    for i, p in enumerate(unstack(grp, per))]
            out.append(("cross", cross, None, 0))
        return out
    n_super, tail = hybrid_shape(cfg)
    for j, grp in enumerate(unstack(params["blocks"], n_super)):
        out += [("ssm", p, ("layers", j, i), 0)
                for i, p in enumerate(unstack(grp, cfg.attn_every))]
        out.append(("attn", params["shared"], ("shared", j), 0))
    if tail:
        out += [("ssm", p, ("tail", i), 0)
                for i, p in enumerate(unstack(params["tail"], tail))]
    return out


def _at(cache: dict | None, index: tuple | None) -> dict | None:
    """The per-layer views of ``cache`` at ``index`` (a name, then stack
    indices); None without a cache or an index."""
    if cache is None or index is None:
        return None
    tree = cache[index[0]]
    for i in index[1:]:
        tree = layer(tree, i)
    return tree


def forward(params: dict, cfg, *, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            positions: torch.Tensor | None = None, cache: dict | None = None,
            cache_pos: int | None = None, vision: torch.Tensor | None = None,
            mesh=None, dp_axes: tuple = (), decode: bool = False,
            remat: bool | None = None,
            with_aux: bool = False, return_hidden: bool = False, tp=None):
    """Run the trunk over ``tokens`` (B, S) or soft ``embeds`` (B, S, D),
    cast to ``cfg.dtype``. positions: (S,) absolute positions (default
    arange(S)). cache: from ``init_cache``; prefill fills it and decode
    (``decode=True`` for the mamba blocks' one-token step; the attention
    blocks decode whenever S == 1 against a cache) updates it, in place.
    ``vision`` (B, P, vision_dim): a vlm's patch embeddings, which its
    cross blocks attend over. ``mesh`` and ``dp_axes`` reach the MoE
    layers alone, as the reference's run time takes them: on a mesh with
    a ``model`` axis they run expert-parallel (``moe.moe_apply``; the
    experts are then this rank's rows), every other layer replicated.
    ``tp`` (a ``launch/shardings.Layout``) reaches every layer instead:
    the partitioned trunk on this rank's shards of the parameters, the
    batch and the cache (module doc); the logits are then this rank's
    vocabulary columns where the embedding is cut. Without a cache,
    ``remat`` (default ``cfg.remat``) recomputes each block in the
    backward (``torch.utils.checkpoint``). Returns (logits (B, S, V), cache), and
    with ``with_aux`` a third item ``{"moe_aux"}``: the MoE layers'
    load-balance terms summed (float32, 0 without MoE layers).
    ``return_hidden`` returns the final norm's output (B, S, D) in place
    of the logits, for callers that fuse their own readout
    (``core/dense_llm.make_pod_distill_step``'s ``chunked_kl``), as the
    reference's ``forward(..., return_hidden=True)`` does."""
    _check_family(cfg)
    if cfg.family == "vlm" and vision is None:
        raise ValueError("a vlm needs the (stubbed) patch embeddings: "
                         "vision=")
    dtype = getattr(torch, cfg.dtype)
    if embeds is None:
        x = L.embed(params["embed"], tokens, compute_dtype=dtype, tp=tp)
    else:
        x = embeds.to(dtype)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    use_remat = (cfg.remat if remat is None else remat) and cache is None \
        and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    for kind, p_l, idx, window in _layers(cfg, params):
        c = _at(cache, idx)
        if kind == "attn":
            fn, args = _dense_block, (cfg, positions, window, c, cache_pos,
                                      tp)
        elif kind == "moe":
            fn, args = _moe_block, (cfg, positions, c, cache_pos, mesh,
                                    dp_axes, tp)
        elif kind == "cross":
            fn, args = _cross_block, (cfg, vision, tp)
        else:
            fn, args = _ssm_block, (cfg, c, decode and c is not None, tp)
        if use_remat:
            y = checkpoint(fn, p_l, x, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            y = fn(p_l, x, *args)
        if kind == "moe":
            x, a = y
            aux = aux + a
        else:
            x = y
    x = L.rmsnorm(params["final_norm"], x)
    out = x if return_hidden else L.unembed(params["embed"], x, tp)
    if with_aux:
        return out, cache, {"moe_aux": aux}
    return out, cache


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
    axis). The dense, audio, ssm and hybrid families without a
    sliding-window pattern; the others serve in the engine's dense mode
    (a ``ValueError`` here, as in the reference). Returns (logits (R, 1,
    V), cache)."""
    from repro_torch.launch.paging import supports_paged

    if not supports_paged(cfg):
        raise ValueError(f"forward_paged: unsupported family {cfg.family!r} "
                         "(moe/vlm/sliding-window serve via the sequential "
                         "dense engine mode)")
    x = L.embed(params["embed"], tokens, compute_dtype=getattr(torch,
                                                               cfg.dtype))
    for kind, p, idx, _ in _layers(cfg, params):
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


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              tp=None) -> torch.Tensor:
    """Each token's float32 −log softmax(logits)[label]. Under a
    vocabulary-parallel ``tp`` the logits are this rank's columns: the
    row maximum (all-reduce max) and sum of exponentials (all-reduce sum)
    are taken over ``model``, and the label's logit from the rank that
    holds it (an all-reduce sum of the one nonzero share)."""
    lf = logits.float()
    if tp is None or not tp.vocab:
        logp = torch.log_softmax(lf, dim=-1)
        return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    n = lf.shape[-1]
    mx = max_over(lf.amax(dim=-1, keepdim=True), tp.mesh, "model")
    lse = (mx + torch.log(tp.sum(torch.exp(lf - mx).sum(
        dim=-1, keepdim=True))))[..., 0]
    local = labels.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    picked = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return lse - tp.sum(torch.where(inside, picked, 0.0))


def loss_fn(params: dict, cfg, batch: dict, *, mesh=None,
            dp_axes: tuple = (), tp=None, batch_axes: tuple = ()):
    """Next-token cross-entropy over ``batch["tokens"]`` (B, S) against
    ``batch["labels"]`` (B, S): float32 log-softmax NLL, averaged over
    the tokens, or over ``batch["mask"]`` where given, plus
    ``router_aux_coef`` times the MoE auxiliary (0 without MoE layers). A
    vlm reads ``batch["vision"]``; ``mesh``, ``dp_axes`` and ``tp`` as in
    ``forward``. Under ``tp`` the batch is this rank's rows of the one
    cut over ``batch_axes``: the cross-entropy is the mean over the whole
    batch and the auxiliary the mean of every data shard's, each summed
    over ``batch_axes`` (replicated; the gradients are this rank's share,
    which the step sums). Returns (loss, {"ce", "moe_aux"})."""
    logits, _, aux = forward(params, cfg, tokens=batch["tokens"],
                             vision=batch.get("vision"), mesh=mesh,
                             dp_axes=dp_axes, with_aux=True, tp=tp)
    nll = token_nll(logits, batch["labels"], tp)
    mask = batch.get("mask")
    moe_aux = aux["moe_aux"]
    if tp is not None:
        shards = 1
        for a in batch_axes:
            shards *= axis_size(tp.mesh, a)
        if mask is None:
            den = float(nll.numel() * shards)
        else:
            nll = nll * mask
            den = torch.clamp(sum_over(mask.sum().float(), tp.mesh,
                                       batch_axes), min=1.0)
        loss = sum_over(nll.sum(), tp.mesh, batch_axes) / den
        moe_aux = sum_over(moe_aux, tp.mesh, batch_axes) / shards
    elif mask is None:
        loss = nll.mean()
    else:
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    total = loss + cfg.router_aux_coef * moe_aux
    return total, {"ce": loss, "moe_aux": moe_aux}
