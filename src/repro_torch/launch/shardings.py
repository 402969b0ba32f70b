"""Parameter, activation and cache partitioning rules
(``repro/launch/shardings.py:33-198``), in the port's spec vocabulary
(``launch/mesh.PartitionSpec``).

Megatron's 2D layout on (data | pod, model):
  - embeddings and the tied readout: vocab over ``model``
  - attention QKV/O: head-sharded over ``model`` iff both n_heads and
    n_kv_heads divide the model axis (MLA: n_heads), else replicated
  - MLP up/gate column-, down row-sharded over ``model``
  - MoE experts expert-parallel over ``model``; the router replicated
  - Mamba2 z/x/dt projections head-sharded over ``model`` when the head
    count divides, else replicated; B/C group projections replicated
  - optimizer moments: the parameter's spec plus its largest
    still-replicated dim over ``data`` (ZeRO-1)
Batch dims shard over (pod, data); for a global batch of one the KV
cache's sequence dim shards over ``data`` instead.

The rules read axis names and sizes only, so they take a ``DeviceMesh``
or an object with ``axis_names`` and a ``shape`` dict, and trees of
anything with a ``.shape`` (tensors, meta tensors). Spec trees are
nested dicts of ``PartitionSpec``, entry for entry the reference's
``P(...)``; ``to_named`` turns one into DTensor placements. The port
applies them to the pod cell's stacked clients
(``core/dense_llm.pod_stack_specs``) and, at run time, to the MoE's
routed experts alone, as the reference's run time does (its trunk takes
the rules only in the dry run): ``local_params`` cuts a parameter tree's
expert leaves (``expert_parallel``) to this rank's rows of their
``model`` dim, ``gather_params`` puts them back together. The rest of
the trunk stays replicated (ROADMAP.md, Queue 1 item 16).
"""
from __future__ import annotations

import numpy as np

from repro_torch.launch.mesh import (P, PartitionSpec, axis_names,
                                     axis_sizes, placements)

MP = "model"


def _axis(mesh, name) -> int:
    return int(axis_sizes(mesh).get(name, 1))


def _map_with_path(fn, tree, keys=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, keys + (k,)) for k, v in tree.items()}
    return fn(list(keys), tree)


def _map_specs(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_specs(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def attn_sharded(cfg, mesh) -> bool:
    m = _axis(mesh, MP)
    if cfg.kv_lora_rank:
        return cfg.n_heads % m == 0
    return cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0


def ssm_sharded(cfg, mesh) -> bool:
    m = _axis(mesh, MP)
    return cfg.ssm_state > 0 and cfg.n_ssm_heads % m == 0


def param_specs(cfg, params_shape, mesh):
    """The spec tree of a params tree (``transformer.init_model``'s
    layout, or its shapes)."""
    a_sh = attn_sharded(cfg, mesh)
    s_sh = ssm_sharded(cfg, mesh)
    m = _axis(mesh, MP)

    def rule(keys, leaf):
        path = "/".join(keys)
        nd = len(leaf.shape)

        def pad(spec):
            return P(*([None] * (nd - len(spec)) + list(spec)))

        if path.endswith("embed/table"):
            return pad([MP, None]) if leaf.shape[-2] % m == 0 \
                else pad([None, None])
        # MoE experts: (E, d, f) tensors under .../moe/
        if "/moe/" in path or path.startswith("moe/"):
            if expert_parallel(keys):
                return pad([MP, None, None])
            if "router" in keys:
                return pad([None] * min(nd, 2))
            if "shared" in keys:
                if keys[-2] in ("gate", "up"):
                    return pad([None, MP])
                if keys[-2] == "down":
                    return pad([MP, None])
                return pad([None])
        if any(k in ("attn", "xattn") for k in keys):
            if not a_sh or "xattn" in keys:
                return pad([None] * min(nd, 2))
            last2 = keys[-2] if len(keys) >= 2 else ""
            if last2 in ("wq", "wk", "wv", "wq_b", "wkv_b"):
                return pad([None, MP]) if keys[-1] == "w" else pad([MP])
            if last2 == "wo":
                return pad([MP, None]) if keys[-1] == "w" else pad([None])
            return pad([None] * min(nd, 2))       # wq_a, wkv_a, norms
        if "mlp" in keys and keys[-1] == "w":
            if keys[-2] in ("gate", "up"):
                return pad([None, MP])
            if keys[-2] == "down":
                return pad([MP, None])
        if keys[-1] == "mlp_gate":
            return P()
        if "mamba" in keys:
            if not s_sh:
                return pad([None] * min(nd, 2))
            last2 = keys[-2] if len(keys) >= 2 else ""
            if last2 in ("in_z", "in_x", "in_dt") and keys[-1] == "w":
                return pad([None, MP])
            if last2 in ("in_z", "in_x", "in_dt") and keys[-1] == "b":
                return pad([MP])
            if last2 == "conv_x":
                return pad([None, MP]) if keys[-1] == "w" else pad([MP])
            if last2 == "out_proj" and keys[-1] == "w":
                return pad([MP, None])
            if keys[-1] in ("a_log", "dt_bias", "d_skip"):
                return pad([MP])
            if last2 == "norm":
                return pad([MP])
            return pad([None] * min(nd, 2))       # in_bc, conv_bc
        return pad([None] * min(nd, 2))           # norms, biases, misc

    return _map_with_path(rule, params_shape)


def zero1_specs(param_specs_tree, params_shape, mesh, *,
                min_size: int = 1 << 16):
    """Optimizer-moment specs: the parameter's spec plus its largest
    still-replicated dim over ``data`` (ZeRO-1)."""
    dp = _axis(mesh, "data")

    def rule(spec, leaf):
        shape = tuple(leaf.shape)
        if int(np.prod(shape)) < min_size or dp == 1:
            return spec
        cur = list(spec) + [None] * (len(shape) - len(spec))
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if cur[i] is None and shape[i] % dp == 0 and shape[i] >= dp:
                cur[i] = "data"
                return P(*cur)
        return spec

    return _map_specs(rule, param_specs_tree, params_shape)


def batch_specs(mesh, batch: int):
    """The token batch's axes: every data-parallel axis when their
    product divides it, else ``data`` alone when it divides, else None."""
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in names]
    size = int(np.prod([sizes[a] for a in axes])) if axes else 1
    if axes and batch % size == 0:
        return tuple(axes)
    if "data" in names and batch % sizes["data"] == 0:
        return ("data",)
    return None


def cache_specs(cfg, cache_shape, mesh, *, batch: int,
                seq_shard_replicated_attn: bool = True):
    """The spec tree of a decode cache (``init_cache``'s layout). With
    replicated attention (head counts the model axis does not divide),
    ``seq_shard_replicated_attn`` shards the cache's sequence dim over
    ``model`` instead of holding a full replica a device."""
    a_sh = attn_sharded(cfg, mesh)
    s_sh = ssm_sharded(cfg, mesh)
    bspec = batch_specs(mesh, batch)
    seq_spec = "data" if (bspec is None and "data" in axis_names(mesh)) \
        else None

    def rule(keys, leaf):
        nd = len(leaf.shape)

        def pad(base):
            return P(*([None] * (nd - len(base)) + base))

        last = keys[-1]
        if last in ("k", "v"):            # (B, S, kh, hd)
            if a_sh:
                return pad([bspec, seq_spec, MP, None])
            if seq_shard_replicated_attn:
                s_axes = (seq_spec, MP) if seq_spec else MP
                return pad([bspec, s_axes, None, None])
            return pad([bspec, seq_spec, None, None])
        if last in ("c_kv", "k_rope"):    # (B, S, r)
            return pad([bspec, seq_spec, None])
        if last == "ssm":                 # (B, H, P, N)
            return pad([bspec, MP if s_sh else None, None, None])
        if last == "conv_x":              # (B, K-1, di)
            return pad([bspec, None, MP if s_sh else None])
        if last == "conv_bc":
            return pad([bspec, None, None])
        return pad([None] * nd)

    return _map_with_path(rule, cache_shape)


def expert_parallel(keys) -> bool:
    """A MoE's routed expert tensors (``gate``, ``up``, ``down``, not the
    shared experts'): the leaves the run-time model axis shards."""
    return "moe" in keys and "shared" not in keys \
        and keys[-1] in ("gate", "up", "down")


def leaf_paths(tree, keys=()):
    """(keys, leaf) of a nested dict, in ``transformer.leaves`` order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaf_paths(v, keys + (k,))
        else:
            yield keys + (k,), v


def expert_mask(params) -> list:
    """Per leaf of ``params`` (``transformer.leaves`` order): whether it
    is an expert-parallel leaf."""
    return [expert_parallel(k) for k, _ in leaf_paths(params)]


def _expert_dim(cfg, params, mesh) -> dict:
    """{keys: the dim ``param_specs`` puts on ``model``} of the expert
    leaves."""
    specs = param_specs(cfg, params, mesh)
    out = {}
    for keys, _ in leaf_paths(params):
        if expert_parallel(keys):
            spec = specs
            for k in keys:
                spec = spec[k]
            out[keys] = list(spec).index(MP)
    return out


def _rebuild(params, fn, keys=()):
    return {k: _rebuild(v, fn, keys + (k,)) if isinstance(v, dict)
            else fn(keys + (k,), v) for k, v in params.items()}


def local_params(params, cfg, mesh):
    """``params`` as this rank holds them on ``mesh``: each expert leaf
    cut to this rank's rows of its ``model`` dim (a copy, so the full
    tensor can be freed), every other leaf as it is. Leaves already cut
    stay as they are; without experts, a mesh or more than one ``model``
    rank the tree is returned as it is."""
    n = _axis(mesh, MP) if mesh is not None else 1
    if n == 1 or not cfg.n_experts:
        return params
    if cfg.n_experts % n:
        raise ValueError(f"{cfg.n_experts} experts do not split over {n} "
                         "model ranks")
    rows = cfg.n_experts // n
    r = mesh.get_local_rank(MP)
    dims = _expert_dim(cfg, params, mesh)

    def cut(keys, leaf):
        if keys not in dims or leaf.shape[dims[keys]] == rows:
            return leaf
        if leaf.shape[dims[keys]] != cfg.n_experts:
            raise ValueError(f"{'/'.join(keys)}: {leaf.shape[dims[keys]]} "
                             f"experts, expected {cfg.n_experts}")
        return leaf.detach().narrow(dims[keys], r * rows, rows).clone()

    return _rebuild(params, cut)


def gather_params(params, cfg, mesh):
    """The inverse of ``local_params``: each expert leaf all-gathered over
    ``model`` (no gradient), every other leaf as it is."""
    import torch

    from repro_torch.launch.mesh import gather_over

    n = _axis(mesh, MP) if mesh is not None else 1
    if n == 1 or not cfg.n_experts:
        return params
    dims = _expert_dim(cfg, params, mesh)

    def gather(keys, leaf):
        if keys not in dims:
            return leaf
        d = dims[keys]
        with torch.no_grad():
            return gather_over(leaf.detach().movedim(d, 0), mesh,
                               MP).movedim(0, d).contiguous()

    return _rebuild(params, gather)


def to_named(tree, mesh):
    """A spec tree as DTensor placements on ``mesh`` (the counterpart of
    the reference's ``NamedSharding`` tree)."""
    if isinstance(tree, PartitionSpec):
        return placements(tree, mesh)
    return {k: to_named(v, mesh) for k, v in tree.items()}


__all__ = ["MP", "attn_sharded", "batch_specs", "cache_specs",
           "expert_mask", "expert_parallel", "gather_params", "leaf_paths",
           "local_params", "param_specs", "ssm_sharded", "to_named",
           "zero1_specs"]
