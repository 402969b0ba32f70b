"""Weights carried between the JAX package and the port.

The reference keeps parameters as nested dicts and lists of arrays
(tests get them as numpy with ``jax.tree.map(np.asarray, p)``). The
port's modules name their parameters and buffers by the same paths, so
a tree maps onto a ``state_dict`` key by key ("stages.1.0.proj.bn.var").
Only the layouts differ:

  * conv weights: HWIO in the reference, OIHW here;
  * linear weights: (d_in, d_out) in the reference, (d_out, d_in) here;
  * BatchNorm scale, bias, mean and var, and biases: copied as they are.

A grouped representation (``core/ensemble.stack_grouped``) carries the
same way with its leading client axis: ``grouped_from_reference`` takes
the reference's (gspecs, gparams), stacked groups (conv weights
(m, k, k, I, O) -> (m, O, I, k, k), linear (m, in, out) -> (m, out, in))
and flat singletons, into the port's, and ``grouped_to_reference`` back.

The token generator (``core/generator.TokGenerator``) names its
parameters as the reference's tree, whose blocks are a list
("blocks.0.mix.w"), and maps onto its ``state_dict`` the same way.

The fc after a conv stack's flatten and the generator's fc keep the
reference's NHWC feature order (models/cnn.py, core/generator.py), so no
rows are permuted. The reverse direction (``*_to_ref``) serves the
tests' comparisons.

The LM stack (``models/transformer.py``) keeps the reference's tree and
layouts as they are: ``embed.table``, ``final_norm.scale`` and the
stacked ``blocks`` (``attn.{wq,wk,wv,wo}.w``, ``mlp.{gate,up,down}.w``,
``norm1/norm2.scale``, and the q, k and v biases ``attn.{wq,wk,wv}.b``
where ``cfg.qkv_bias``; a mamba block's ``norm.scale`` and
``mamba.{in_z,in_x,in_bc,in_dt,out_proj}.w``, ``conv_x/conv_bc.{w,b}``
with w (K, C), ``a_log``, ``dt_bias``, ``d_skip`` and ``norm.scale``;
a hybrid's ``tail`` and ``shared`` too; a moe's ``block0`` and MLA
leaves ``attn.{wq | wq_a, q_norm, wq_b, wkv_a, kv_norm, wkv_b, wo}``, its
experts ``moe.{gate, up, down}`` (E, d, f) / (E, f, d), raw arrays, the
float32 ``moe.router.w`` and ``moe.shared``; a vlm's ``blocks`` (n_super,
cross_every, ...) and ``cross`` (``xattn`` with its ``gate``,
``mlp_gate``)), with linear weights (d_in, d_out) and the leading layer
axes. ``lm_params_from_reference``
and ``paged_cache_from_reference`` carry such trees (and a block pool,
SSM slots included, with its block table; ``tree_from_reference`` a dense
cache, MLA's ``c_kv`` and ``k_rope`` and a vlm's (n_super, cross_every,
...) ``layers`` among them) across as they are: no leaf is
transposed, and every leaf keeps its dtype (bfloat16 arrays their bits,
the float32 SSM scalars and states their float32). The reverse direction returns
numpy, bfloat16 widened exactly to float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.backend import resolve_device
from repro_torch.core.generator import (ImgGenerator, TokGenerator,
                                       img_generator_init,
                                       tok_generator_init)
from repro_torch.models.cnn import (CNN, CNNSpec, cnn_init, group_size,
                                    stack_tensors)
from repro_torch.models.transformer import (hybrid_shape, n_moe_layers,
                                            vlm_shape)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _to_port(key: str, a: np.ndarray) -> np.ndarray:
    if key.rsplit(".", 1)[-1] == "w":
        if a.ndim == 4:
            return a.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        if a.ndim == 2:
            return a.T                              # (in, out) -> (out, in)
    return a


def _to_ref(key: str, a: np.ndarray) -> np.ndarray:
    if key.rsplit(".", 1)[-1] == "w":
        if a.ndim == 4:
            return a.transpose(2, 3, 1, 0)          # OIHW -> HWIO
        if a.ndim == 2:
            return a.T
    return a


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":                 # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def tree_from_reference(tree, *, device="cuda"):
    """A nested dict of arrays as the same dict of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_reference(v, device=dev) for k, v in tree.items()}
    return _tensor(np.asarray(tree), dev)


def tree_to_reference(tree):
    """A nested dict of tensors as the same dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_reference(v) for k, v in tree.items()}
    return _numpy(tree)


def _attn_shapes(cfg, lead: tuple) -> dict:
    """An attention layer's leaves: GQA's q, k, v, o (and the q, k and v
    biases where ``cfg.qkv_bias``), or MLA's."""
    d, hd, h = cfg.d_model, cfg.head_dim, cfg.n_heads
    if cfg.kv_lora_rank:
        nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
            cfg.v_head_dim
        r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
        want = {("wq_a", "w"): (d, qr), ("q_norm", "scale"): (qr,),
                ("wq_b", "w"): (qr, h * (nd + rd))} if qr \
            else {("wq", "w"): (d, h * (nd + rd))}
        want.update({("wkv_a", "w"): (d, r + rd), ("kv_norm", "scale"): (r,),
                     ("wkv_b", "w"): (r, h * (nd + vd)),
                     ("wo", "w"): (h * vd, d)})
        return {k: (*lead, *v) for k, v in want.items()}
    want = {("wq", "w"): (*lead, d, h * hd),
            ("wk", "w"): (*lead, d, cfg.n_kv_heads * hd),
            ("wv", "w"): (*lead, d, cfg.n_kv_heads * hd),
            ("wo", "w"): (*lead, h * hd, d)}
    if cfg.qkv_bias:
        for name, width in (("wq", h), ("wk", cfg.n_kv_heads),
                            ("wv", cfg.n_kv_heads)):
            want[(name, "b")] = (*lead, width * hd)
    return want


def _mlp_shapes(d: int, d_ff: int, lead: tuple) -> dict:
    return {("gate", "w"): (*lead, d, d_ff), ("up", "w"): (*lead, d, d_ff),
            ("down", "w"): (*lead, d_ff, d)}


def _block_shapes(cfg, lead: tuple, **parts) -> dict:
    """A block's leaves: its two norms and ``parts`` (name -> shapes)."""
    want = {("norm1", "scale"): (*lead, cfg.d_model),
            ("norm2", "scale"): (*lead, cfg.d_model)}
    for name, shapes in parts.items():
        want.update({(name, *k): v for k, v in shapes.items()})
    return want


def _dense_shapes(cfg, lead: tuple, d_ff: int | None = None) -> dict:
    return _block_shapes(cfg, lead, attn=_attn_shapes(cfg, lead),
                         mlp=_mlp_shapes(cfg.d_model, d_ff or cfg.d_ff,
                                         lead))


def _moe_shapes(cfg, lead: tuple) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    want = {("router", "w"): (*lead, d, e), ("gate",): (*lead, e, d, f),
            ("up",): (*lead, e, d, f), ("down",): (*lead, e, f, d)}
    if cfg.n_shared_experts:
        want.update({("shared", *k): v for k, v in _mlp_shapes(
            d, cfg.n_shared_experts * f, lead).items()})
    return _block_shapes(cfg, lead, attn=_attn_shapes(cfg, lead), moe=want)


def _cross_shapes(cfg, lead: tuple) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = cfg.vision_dim or d
    xattn = {("wq", "w"): (*lead, d, h * hd), ("wk", "w"): (*lead, src,
                                                             kh * hd),
             ("wv", "w"): (*lead, src, kh * hd), ("wo", "w"): (*lead, h * hd,
                                                               d),
             ("gate",): lead}
    want = _block_shapes(cfg, lead, xattn=xattn,
                         mlp=_mlp_shapes(d, cfg.d_ff, lead))
    want[("mlp_gate",)] = lead
    return want


def _ssm_shapes(cfg, lead: tuple) -> dict:
    """A mamba block's leaves: linears (d_in, d_out), conv weights (K, C)
    (not transposed), a_log, dt_bias and d_skip per head."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
    gn2 = 2 * cfg.ssm_n_groups * cfg.ssm_state
    m = {("in_z", "w"): (d, di), ("in_x", "w"): (d, di),
         ("in_bc", "w"): (d, gn2), ("in_dt", "w"): (d, h),
         ("conv_x", "w"): (cfg.ssm_conv, di), ("conv_x", "b"): (di,),
         ("conv_bc", "w"): (cfg.ssm_conv, gn2), ("conv_bc", "b"): (gn2,),
         ("a_log",): (h,), ("dt_bias",): (h,), ("d_skip",): (h,),
         ("norm", "scale"): (di,), ("out_proj", "w"): (di, d)}
    want = {("mamba", *k): (*lead, *v) for k, v in m.items()}
    want[("norm", "scale")] = (*lead, d)
    return want


def lm_param_shapes(cfg) -> dict:
    """{leaf path: shape} of ``transformer.init_model(cfg)``'s tree."""
    want = {("embed", "table"): (cfg.vocab_size, cfg.d_model),
            ("final_norm", "scale"): (cfg.d_model,)}

    def put(name, shapes):
        want.update({(name, *k): v for k, v in shapes.items()})

    if cfg.family in ("dense", "audio"):
        put("blocks", _dense_shapes(cfg, (cfg.n_layers,)))
    elif cfg.family == "moe":
        put("blocks", _moe_shapes(cfg, (n_moe_layers(cfg),)))
        if cfg.first_dense:
            put("block0", _dense_shapes(cfg, (), cfg.d_ff_expert * (
                cfg.top_k + cfg.n_shared_experts)))
    elif cfg.family == "vlm":
        n_super, per = vlm_shape(cfg)
        put("blocks", _dense_shapes(cfg, (n_super, per)))
        put("cross", _cross_shapes(cfg, (n_super,)))
    elif cfg.family == "ssm":
        put("blocks", _ssm_shapes(cfg, (cfg.n_layers,)))
    elif cfg.family == "hybrid":
        n_super, tail = hybrid_shape(cfg)
        put("blocks", _ssm_shapes(cfg, (n_super, cfg.attn_every)))
        if tail:
            put("tail", _ssm_shapes(cfg, (tail,)))
        put("shared", _dense_shapes(cfg, ()))
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return want


def lm_params_from_reference(tree, cfg, *, device="cuda") -> dict:
    """The reference's LM parameter tree (``transformer.init_model``, any
    family) as the port's, checked against ``cfg``'s shapes
    (``lm_param_shapes``: the q, k and v biases where ``cfg.qkv_bias``;
    conv weights (K, C) as they are). Every leaf keeps its dtype:
    ``a_log``, ``dt_bias``, ``d_skip`` and the MoE router stay
    float32."""
    params = tree_from_reference(tree, device=device)
    got, want = dict(_shapes(params)), lm_param_shapes(cfg)
    if got != want:
        raise ValueError(f"the parameter tree does not fit {cfg.name}: "
                         f"{got} against {want}")
    return params


def _shapes(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _shapes(v, (*path, k))
        else:
            yield (*path, k), tuple(v.shape)


def lm_params_to_reference(params: dict):
    return tree_to_reference(params)


def paged_cache_from_reference(pools, block_tables, *, device="cuda"):
    """A reference block pool (``paging.init_paged_cache``) and its
    block table as the port's ``(pools, block_tables)``."""
    return (tree_from_reference(pools, device=device),
            _tensor(np.asarray(block_tables, np.int32), resolve_device(device)))


def paged_cache_to_reference(pools, block_tables):
    return tree_to_reference(pools), _numpy(block_tables)


def ref_to_state(tree) -> dict:
    """A reference parameter tree as a ``state_dict`` of float32 tensors
    in the port's layouts."""
    return {k: torch.tensor(np.ascontiguousarray(_to_port(k, a)))
            for k, a in _flatten(tree)}


def state_to_ref(state: dict):
    """A ``state_dict`` as a reference tree of numpy arrays (lists where
    the path segment is an index)."""
    root: dict = {}
    for key, t in state.items():
        *path, leaf = key.split(".")
        node = root
        for seg in path:
            node = node.setdefault(seg, {})
        node[leaf] = np.ascontiguousarray(
            _to_ref(key, t.detach().cpu().numpy()))

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def load_ref(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a reference tree into a module built for the same spec."""
    target = module.net if isinstance(module, CNN) else module
    target.load_state_dict(ref_to_state(tree), strict=True)
    return module


def cnn_from_ref(tree, spec: CNNSpec, *, device="cuda") -> CNN:
    return load_ref(cnn_init(spec, device=device), tree)


def cnn_to_ref(model: CNN):
    return state_to_ref(model.net.state_dict())


def generator_from_ref(tree, *, nz: int, img_size: int, out_ch: int = 3,
                       base: int = 64, device="cuda") -> ImgGenerator:
    gen = img_generator_init(nz=nz, img_size=img_size, out_ch=out_ch,
                             base=base, device=device)
    return load_ref(gen, tree)


def generator_to_ref(gen: ImgGenerator):
    return state_to_ref(gen.state_dict())


def tok_generator_from_reference(tree, *, seq: int, d_model: int,
                                 device="cuda") -> TokGenerator:
    """The reference's token generator (``tok_generator_init``; its
    blocks a list) as a ``TokGenerator``; nz, d_g, the number of blocks
    and of classes are read off the tree."""
    nz, d_g = np.asarray(tree["z_proj"]["w"]).shape
    label = tree.get("label")
    gen = tok_generator_init(
        nz=nz, seq=seq, d_model=d_model, d_g=d_g,
        n_blocks=len(tree["blocks"]),
        n_classes=0 if label is None else np.asarray(label["table"]).shape[0],
        device=device)
    return load_ref(gen, tree)


def tok_generator_to_reference(gen: TokGenerator):
    return state_to_ref(gen.state_dict())


def _spec(spec) -> CNNSpec:
    """A reference ``CNNSpec`` (or the port's) as the port's."""
    return CNNSpec(kind=spec.kind, num_classes=spec.num_classes,
                   in_ch=spec.in_ch, width=spec.width,
                   image_size=spec.image_size)


def _stacked_to_port(key: str, a: np.ndarray) -> np.ndarray:
    if key.rsplit(".", 1)[-1] == "w":
        if a.ndim == 5:
            return a.transpose(0, 4, 3, 1, 2)   # (m,)HWIO -> (m,)OIHW
        if a.ndim == 3:
            return a.transpose(0, 2, 1)
    return a


def grouped_from_reference(gspecs, gparams, *, device="cuda"):
    """The reference's grouped representation (``stack_grouped``: specs
    with group sizes, stacked trees with a leading client axis, flat
    singletons) as the port's: stacked groups as dicts of tensors named
    as ``net.state_dict()``, singletons as ``CNN`` models."""
    dev = resolve_device(device)
    specs, params = [], []
    for (spec, size), tree in zip(gspecs, gparams):
        spec = _spec(spec)
        specs.append((spec, int(size)))
        if size == 1:
            params.append(cnn_from_ref(tree, spec, device=dev))
            continue
        params.append({k: stack_tensors([
            torch.tensor(np.ascontiguousarray(r), device=dev)
            for r in _stacked_to_port(k, a)]) for k, a in _flatten(tree)})
    return tuple(specs), params


def grouped_to_reference(gspecs, gparams):
    """The port's grouped representation as the reference's: (specs with
    group sizes, numpy trees, stacked with a leading client axis or flat
    for a singleton)."""
    params = []
    for (spec, size), p in zip(gspecs, gparams):
        if size == 1:
            params.append(cnn_to_ref(p))
            continue
        assert group_size(p) == size
        rows = [state_to_ref({k: v[j] for k, v in p.items()})
                for j in range(size)]
        params.append(_stack_trees(rows))
    return tuple(gspecs), params


def _stack_trees(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_stack_trees([t[i] for t in trees])
                for i in range(len(trees[0]))]
    return np.stack(trees)
