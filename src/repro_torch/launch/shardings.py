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
``P(...)``; ``to_named`` turns one into DTensor placements.

Two uses, as in the reference:

  * at run time (``launch/train.py``, ``serve.py``, the engine, LLM
    DENSE) only the MoE's routed experts are cut, as the reference's
    drivers replicate everything else: ``local_params(params, cfg,
    mesh)`` cuts the expert leaves (``expert_parallel``) to this rank's
    rows of their ``model`` dim, ``gather_params`` puts them back;
  * a step given the specs (``launch/steps.py``, ``core/dense_llm.
    make_pod_distill_step``, the dry run) computes on this rank's shards
    of every tree, the counterpart of the reference's ``jit(...,
    in_shardings=...)``: ``local_tree`` cuts any tree by any spec tree
    (each leaf on every dim its spec names, over every axis listed
    there, the leading axis outermost; params by ``param_specs``, Adam's
    moments by ``zero1_specs``, caches by ``cache_specs``, the pod stack
    by ``pod_stack_specs``), ``gather_tree`` puts it back, and
    ``check_tree`` refuses a tree whose shapes are not the shards of
    the full ones. ``Layout`` is what the partitioned trunk reads from
    the same rules: whether attention (``attn_sharded``), the mamba heads
    (``ssm_sharded``) and the vocabulary are cut over ``model``, and the
    axes a cache's sequence dim is cut over. PyTorch has no GSPMD, so
    the trunk writes out the collectives the reference's compiler
    inserts (``models/*``, ``launch/steps.py``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.launch.mesh import (P, PartitionSpec, _block, axis_names,
                                     axis_sizes, gather_dim, placements,
                                     replicated_over, sum_over)

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


def train_state_specs(cfg, mesh, aparams=None, *, min_size: int = 1 << 16):
    """(param specs, the train state's spec tree ``{"params", "opt":
    {"m", "v", "t"}, "step"}``) of ``cfg`` on ``mesh``, as the
    reference's dry run builds them (``aparams``: the full parameters'
    shapes, default ``launch/specs.abstract_params``)."""
    from repro_torch.launch.specs import abstract_params

    aparams = abstract_params(cfg) if aparams is None else aparams
    pspecs = param_specs(cfg, aparams, mesh)
    zspecs = zero1_specs(pspecs, aparams, mesh, min_size=min_size)
    return pspecs, {"params": pspecs, "opt": {"m": zspecs, "v": zspecs,
                                              "t": P()}, "step": P()}


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


def _expert_specs(cfg, params, mesh):
    """The run-time rule as a spec tree: ``param_specs`` of ``params``'
    own shapes (a stack's leading dims replicated) for the expert leaves,
    every other leaf replicated."""
    specs = param_specs(cfg, params, mesh)
    return map_leaves(params, lambda keys, _: spec_at(specs, keys)
                      if expert_parallel(keys) else P())


def map_leaves(tree, fn, keys=()):
    """A nested dict of ``fn(keys, leaf)``."""
    return {k: map_leaves(v, fn, keys + (k,)) if isinstance(v, dict)
            else fn(keys + (k,), v) for k, v in tree.items()}


def local_params(params, cfg, mesh, specs=None):
    """``params`` as this rank holds them on ``mesh``. With ``specs`` (a
    ``param_specs`` tree) every leaf is cut by its spec (``local_tree``
    against ``cfg``'s full shapes: leaves already cut stay as they are).
    Without, the run-time rule: each expert leaf cut to this rank's rows
    of its ``model`` dim (a copy, so the full tensor can be freed), every
    other leaf as it is; leaves already cut stay as they are; without
    experts, a mesh or more than one ``model`` rank the tree is returned
    as it is."""
    if specs is not None:
        from repro_torch.launch.specs import abstract_params

        return local_tree(params, specs, mesh, full=abstract_params(cfg))
    n = _axis(mesh, MP) if mesh is not None else 1
    if n == 1 or not cfg.n_experts:
        return params
    if cfg.n_experts % n:
        raise ValueError(f"{cfg.n_experts} experts do not split over {n} "
                         "model ranks")
    rows = cfg.n_experts // n
    especs = _expert_specs(cfg, params, mesh)

    def one(keys, leaf):
        if not expert_parallel(keys):
            return leaf
        spec = spec_at(especs, keys)
        have = leaf.shape[list(spec).index(MP)]
        if have == rows:
            return leaf
        if have != cfg.n_experts:
            raise ValueError(f"{'/'.join(keys)}: {have} experts, expected "
                             f"{cfg.n_experts}")
        return cut(leaf, spec, mesh)

    return map_leaves(params, one)


def gather_params(params, cfg, mesh, specs=None):
    """The inverse of ``local_params``: with ``specs`` every leaf
    gathered, without each expert leaf all-gathered over ``model``, every
    other leaf as it is (``gather_tree``: no gradient)."""
    if specs is not None:
        return gather_tree(params, specs, mesh)
    n = _axis(mesh, MP) if mesh is not None else 1
    if n == 1 or not cfg.n_experts:
        return params
    return gather_tree(params, _expert_specs(cfg, params, mesh), mesh)


# ------------------------------------------------ any tree by any specs --

def dim_axes(spec, nd: int) -> list:
    """Per dim of an ``nd``-dim tensor: the axes its spec entry names
    (a tuple, empty for None); a spec shorter than ``nd`` leaves the
    trailing dims replicated."""
    out = []
    for d in range(nd):
        e = spec[d] if d < len(spec) else None
        out.append(() if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return out


def _factor(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= _axis(mesh, a)
    return n


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of this rank's block of a ``shape`` tensor cut by
    ``spec``; raises where a dim does not split."""
    out = []
    for d, (size, axes) in enumerate(zip(shape, dim_axes(spec, len(shape)))):
        n = _factor(mesh, axes)
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} ({size}) does not "
                             f"split over {n} ranks of {axes}")
        out.append(size // n)
    return tuple(out)


def cut(t, spec, mesh):
    """This rank's block of ``t`` by ``spec`` (a copy where anything is
    cut, so the full tensor can be freed)."""
    want = local_shape(t.shape, spec, mesh)
    if tuple(t.shape) == want:
        return t
    out = t.detach()
    for d, axes in enumerate(dim_axes(spec, t.dim())):
        if _factor(mesh, axes) > 1:
            idx, _ = _block(mesh, axes)
            out = out.narrow(d, idx * want[d], want[d])
    return out.clone()


def gather(t, spec, mesh):
    """The inverse of ``cut``: every rank's block, all-gathered on each
    cut dim (no gradient)."""
    for d, axes in enumerate(dim_axes(spec, t.dim())):
        if _factor(mesh, axes) > 1:
            t = gather_dim(t, mesh, axes, d)
    return t


def local_tree(tree, specs, mesh, *, full=None):
    """``tree`` as this rank holds it under ``specs`` (``cut`` leaf by
    leaf). With ``full`` (a tree of the full shapes, e.g. the meta
    tensors of ``launch/specs``), a leaf already at its shard's shape
    stays as it is and one at neither shape raises."""
    if mesh is None:
        return tree

    def one(keys, leaf):
        spec = spec_at(specs, keys)
        if full is not None:
            shape = tuple(spec_at(full, keys).shape)
            if tuple(leaf.shape) == local_shape(shape, spec, mesh):
                return leaf
            if tuple(leaf.shape) != shape:
                raise ValueError(
                    f"{'/'.join(keys)}: shape {tuple(leaf.shape)} is neither "
                    f"the full {shape} nor its shard under {spec}")
        return cut(leaf, spec, mesh)

    return map_leaves(tree, one)


def gather_tree(tree, specs, mesh):
    """The inverse of ``local_tree``: each leaf gathered (no gradient)."""
    if mesh is None:
        return tree
    return map_leaves(tree, lambda keys, leaf: gather(
        leaf, spec_at(specs, keys), mesh))


def check_tree(tree, specs, mesh, full, *, what: str = "tree") -> None:
    """Raise unless every leaf of ``tree`` has the shape of its shard of
    ``full`` under ``specs``: a step never computes on the wrong
    shard."""
    for keys, leaf in leaf_paths(tree):
        spec = spec_at(specs, keys)
        want = local_shape(spec_at(full, keys).shape, spec, mesh)
        if tuple(leaf.shape) != want:
            raise ValueError(
                f"{what} {'/'.join(keys)}: shape {tuple(leaf.shape)}, but "
                f"its shard under {spec} on {axis_sizes(mesh)} is {want}")


def spec_at(tree, keys):
    """The entry of a nested dict (a spec tree, or any) at ``keys``."""
    for k in keys:
        tree = tree[k]
    return tree


def spec_axes(spec) -> tuple:
    """Every axis a spec names, in order."""
    return tuple(a for axes in dim_axes(spec, len(spec)) for a in axes)


def _first(specs, name):
    """The spec of the first leaf called ``name`` in a spec tree."""
    if isinstance(specs, PartitionSpec):
        return None
    for k, v in specs.items():
        if k == name and isinstance(v, PartitionSpec):
            return v
        got = _first(v, name)
        if got is not None:
            return got
    return None


class Layout:
    """What the partitioned trunk reads (``models/*``' ``tp=``): the
    mesh, whether attention, the mamba heads and the vocabulary are cut
    over ``model`` (``attn_sharded``, ``ssm_sharded``, ``param_specs``'
    embedding rule) and, given a cache's specs, the axes its KV (``k``,
    ``v``) and MLA latent (``c_kv``, ``k_rope``) sequence dims are cut
    over. ``enter`` and ``sum`` are the model axis's ``replicated_over``
    and ``sum_over``."""

    def __init__(self, cfg, mesh, pspecs, cspecs=None):
        self.mesh = mesh
        self.m = _axis(mesh, MP)
        self.rank = mesh.get_local_rank(MP) if self.m > 1 else 0
        self.attn = attn_sharded(cfg, mesh)
        self.ssm = ssm_sharded(cfg, mesh)
        self.vocab = pspecs["embed"]["table"][-2] == MP
        k = _first(cspecs, "k") if cspecs is not None else None
        c = _first(cspecs, "c_kv") if cspecs is not None else None
        self.kv_seq = tuple(a for a in dim_axes(k, len(k))[-3]
                            if _axis(mesh, a) > 1) if k else ()
        self.latent_seq = tuple(a for a in dim_axes(c, len(c))[-2]
                                if _axis(mesh, a) > 1) if c else ()

    def enter(self, t):
        return replicated_over(t, self.mesh, MP)

    def sum(self, t):
        return sum_over(t, self.mesh, MP)

    def local(self, n: int, what: str) -> int:
        """n / model ranks, or a ValueError naming ``what``."""
        if n % self.m:
            raise ValueError(f"{what}: {n} does not split over {self.m} "
                             "model ranks")
        return n // self.m


def to_named(tree, mesh):
    """A spec tree as DTensor placements on ``mesh`` (the counterpart of
    the reference's ``NamedSharding`` tree)."""
    if isinstance(tree, PartitionSpec):
        return placements(tree, mesh)
    return {k: to_named(v, mesh) for k, v in tree.items()}


__all__ = ["Layout", "MP", "attn_sharded", "batch_specs", "cache_specs",
           "check_tree", "cut", "dim_axes", "expert_mask",
           "expert_parallel", "gather", "gather_params", "gather_tree",
           "leaf_paths", "local_params", "local_shape", "local_tree",
           "map_leaves", "param_specs", "spec_at", "spec_axes",
           "ssm_sharded", "to_named", "train_state_specs", "zero1_specs"]
