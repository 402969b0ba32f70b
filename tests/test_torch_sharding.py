"""The port's partitioning rules (``launch/shardings.py``), the stacked
client specs (``fl.sharding.stack_specs``, ``core.dense_llm.
pod_stack_specs``) and the spec vocabulary (``launch/mesh.py``) against
the JAX package's, for every registered architecture at full size, on
the reference's production mesh shapes (16 x 16 and 2 x 16 x 16) given
as axis names and sizes alone (no devices). Spec trees must be equal
entry for entry; the inputs are the reference's abstract shapes
(``jax.eval_shape``), read through ``.shape`` only, and the port's own
parameter tree has the same paths and shapes (``interop.lm_param_shapes``).
"""
from types import SimpleNamespace

import jax
import pytest
from jax.sharding import PartitionSpec as RP
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import available_archs, get_config as r_get_config
from repro.core import dense_llm as R_DL
from repro.fl import sharding as R_FS
from repro.launch import mesh as R_mesh
from repro.launch import shardings as R_SH
from repro.launch import specs as R_SP
from repro.models import transformer as R_T

from repro_torch import interop
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.core import dense_llm as T_DL
from repro_torch.fl import sharding as T_FS
from repro_torch.launch import mesh as T_M
from repro_torch.launch import shardings as T_SH
from repro_torch.launch import specs as T_SP
from repro_torch.models import transformer as T_T

MESHES = {"pod": (("data", "model"), {"data": 16, "model": 16}),
          "multipod": (("pod", "data", "model"),
                       {"pod": 2, "data": 16, "model": 16})}


def _meshes(name):
    names, shape = MESHES[name]
    return (SimpleNamespace(axis_names=names, shape=shape),
            SimpleNamespace(axis_names=names, shape=dict(shape)))


def _shapes(tree):
    """A reference tree of abstract arrays as nested dicts of objects
    with a ``.shape``, the port's tree layout."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return SimpleNamespace(shape=tuple(tree.shape))


def _as_port(tree):
    """A reference spec tree in the port's vocabulary (nested dicts of
    tuples), to compare entry for entry."""
    if isinstance(tree, RP):
        return tuple(tree)
    return {k: _as_port(v) for k, v in tree.items()}


def _same(got, want):
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    else:
        assert isinstance(got, T_M.PartitionSpec)
        assert tuple(got) == want, (got, want)


@pytest.fixture(scope="module")
def abstract():
    out = {}
    for arch in available_archs():
        cfg = r_get_config(arch)
        out[arch] = jax.eval_shape(
            lambda c=cfg: R_T.init_model(jax.random.PRNGKey(0), c))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", available_archs())
def test_param_and_zero1_specs_match_reference(abstract, arch, mesh):
    rmesh, tmesh = _meshes(mesh)
    rcfg, tcfg = r_get_config(arch), t_get_config(arch)
    shapes = _shapes(abstract[arch])
    want = R_SH.param_specs(rcfg, abstract[arch], rmesh)
    got = T_SH.param_specs(tcfg, shapes, tmesh)
    _same(got, _as_port(want))
    _same(T_SH.zero1_specs(got, shapes, tmesh),
          _as_port(R_SH.zero1_specs(want, abstract[arch], rmesh)))
    assert T_SH.attn_sharded(tcfg, tmesh) == R_SH.attn_sharded(rcfg, rmesh)
    assert T_SH.ssm_sharded(tcfg, tmesh) == R_SH.ssm_sharded(rcfg, rmesh)
    # the port's tree is the reference's, path for path
    flat = {tuple(k.key for k in path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(abstract[arch])[0]}
    assert interop.lm_param_shapes(tcfg) == flat
    # the stacked client specs: "pod" on two pods, replicated on one
    _same(T_DL.pod_stack_specs(got, tmesh),
          _as_port(R_DL.pod_stack_specs(want, rmesh)))
    _same(T_FS.stack_specs(got, "clients"),
          _as_port(R_FS.stack_specs(want, "clients")))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", available_archs())
def test_cache_and_batch_specs_match_reference(arch, mesh):
    rmesh, tmesh = _meshes(mesh)
    rcfg, tcfg = r_get_config(arch), t_get_config(arch)
    for shape in ("decode_32k", "long_500k"):
        if shape == "long_500k" and not R_SP.long_context_ok(rcfg):
            continue
        spec = R_SP.input_specs(rcfg, shape)
        for seq_shard in (True, False):
            want = R_SH.cache_specs(rcfg, spec["cache"], rmesh,
                                    batch=spec["batch"],
                                    seq_shard_replicated_attn=seq_shard)
            got = T_SH.cache_specs(tcfg, _shapes(spec["cache"]), tmesh,
                                   batch=spec["batch"],
                                   seq_shard_replicated_attn=seq_shard)
            _same(got, _as_port(want))
    for batch in (1, 2, 16, 32, 48, 128, 256):
        assert T_SH.batch_specs(tmesh, batch) == \
            R_SH.batch_specs(rmesh, batch)


def _abstract(tree):
    """{path: (shape, dtype name)} of a tree of reference abstract arrays
    or of the port's meta tensors."""
    if isinstance(tree, dict):
        return {k: _abstract(v) for k, v in tree.items()}
    dtype = getattr(tree.dtype, "name", None) or str(tree.dtype).split(".")[-1]
    return tuple(tree.shape), dtype


@pytest.mark.parametrize("shape", sorted(R_SP.SHAPES))
@pytest.mark.parametrize("arch", available_archs())
def test_input_specs_and_abstract_params_match_reference(abstract, arch,
                                                         shape):
    """``launch/specs.py``: the meta-device inputs of every arch and
    shape, and the meta parameter tree, against the reference's
    ``jax.eval_shape`` shapes and dtypes; ``long_context_ok`` per arch."""
    rcfg, tcfg = r_get_config(arch), t_get_config(arch)
    assert T_SP.SHAPES == R_SP.SHAPES
    assert T_SP.long_context_ok(tcfg) == R_SP.long_context_ok(rcfg)
    got, want = T_SP.input_specs(tcfg, shape), R_SP.input_specs(rcfg, shape)
    assert set(got) == set(want)
    for k in want:
        if k in ("kind", "batch", "seq"):
            assert got[k] == want[k]
        else:
            assert _abstract(got[k]) == _abstract(want[k]), k
    params = T_SP.abstract_params(tcfg)
    assert all(t.device.type == "meta" for t in T_T.leaves(params))
    assert _abstract(params) == _abstract(abstract[arch])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_names_and_sizes(monkeypatch, multi_pod):
    """``make_production_mesh`` gives the names and sizes the reference's
    builds its 256- or 512-device mesh with (read off its call to
    ``jax.make_mesh``: this host has one device)."""
    monkeypatch.setattr(R_mesh.jax, "make_mesh", lambda shape, axes, **kw:
                        SimpleNamespace(axis_names=tuple(axes),
                                        shape=dict(zip(axes, shape))))
    want = R_mesh.make_production_mesh(multi_pod=multi_pod)
    got = T_M.make_production_mesh(multi_pod=multi_pod)
    assert got.axis_names == want.axis_names and got.shape == want.shape
    assert T_M.axis_sizes(got) == want.shape
    assert T_M.dp_axes_of(got) == R_mesh.dp_axes_of(want)


def test_spec_vocabulary():
    P = T_M.P
    assert P("pod", None, "model") == ("pod", None, "model")
    assert tuple(P()) == () and repr(P(None, "model")) == \
        "P(None, 'model')"
    tmesh = SimpleNamespace(axis_names=("pod", "data", "model"),
                            shape={"pod": 2, "data": 16, "model": 16})
    assert T_M.dp_axes_of(tmesh) == ("pod", "data")
    assert T_M.axis_size(tmesh, "model") == 16
    assert T_M.axis_size(tmesh, "clients") == 1
    assert P(("data",), ()) == ("data", None)
    assert T_M.placements(P(("pod", "data"), None, "model"), tmesh) == \
        (Shard(0), Shard(0), Shard(2))
    tree = T_SH.to_named({"a": P(None, "model"), "b": {"c": P()}}, tmesh)
    assert tree == {"a": (Replicate(), Replicate(), Shard(1)),
                    "b": {"c": (Replicate(),) * 3}}
    assert T_FS.stack_specs({"w": [P(None), P("model")]}, "clients") == \
        {"w": [P("clients", None), P("clients", "model")]}
    assert T_FS.client_axis_size(None) == 1
    assert not T_FS.group_shardable(None, 4)
    assert T_FS.put_grouped([(None, 2)], ["stack"], None) == ["stack"]
