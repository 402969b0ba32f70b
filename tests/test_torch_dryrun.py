"""The dry run (``repro_torch.launch.dryrun``) on a fake world of 256
ranks (16 x 16), against the JAX package's rules and formulas.

Three cells, each traced in a subprocess of its own (a pytest worker may
already hold a process group, beside which the fake world refuses to
start): llama3-2-3b ``train_4k`` and ``decode_32k``, and mamba2-130m
``long_500k``. Held:

  * status ``ok`` with the reference's keys and ``"counted_by":
    "torch"``; ``long_500k`` skipped for exactly the archs the
    reference skips, with its reason;
  * ``argument_bytes``: each leaf's bytes over its shard factor, summed
    over the parameters, Adam's moments and the batch (train) or the
    parameters, the cache and the tokens (decode), by the reference's
    own ``param_specs``/``zero1_specs``/``cache_specs``/``batch_specs``
    on ``jax.eval_shape`` of its init (no compile); the reference's
    int32 step counters and decode position, which the port keeps on
    the host, are left out;
  * ``model_flops_total``: the reference's ``model_flops``, for every
    arch and shape;
  * the collective counts: an analytic count of the partitioned step's
    collectives for the arch (below);
  * FLOPs per device within 2% of an analytic count: 2·tokens·P per
    forward pass of the P parameters a device multiplies (the model
    axis' share of the sharded ones, all of the replicated ones), 3
    passes in training plus the recomputed forward (remat), plus the
    attention products (every block of the blockwise path, masked ones
    too) and, for mamba, the state's readout product. The 2% covers
    the layer's last product, which the backward's recomputation stops
    before.
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs.base import available_archs as r_archs
from repro.configs.base import get_config as r_get_config
from repro.launch import shardings as R_SH
from repro.launch import specs as R_SP
from repro.launch import steps as R_ST

from repro_torch.configs.base import get_config as t_get_config
from repro_torch.launch import dryrun as T_DR
from repro_torch.launch import specs as T_SP

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELLS = (("llama3-2-3b", "train_4k"), ("llama3-2-3b", "decode_32k"),
         ("mamba2-130m", "long_500k"))
MESH = SimpleNamespace(axis_names=("data", "model"),
                       shape={"data": 16, "model": 16})
KEYS = ("status", "memory", "collectives", "roofline", "bottleneck",
        "model_flops_total", "useful_flops_ratio")
FLOPS_TOL = 0.02


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", s, "--out", out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for a, s in CELLS]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    recs = {}
    for a, s in CELLS:
        with open(os.path.join(out, f"{a}_{s}_16x16.json")) as f:
            recs[a, s] = json.load(f)
    return recs


def _factor(spec) -> int:
    n = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n *= MESH.shape[a]
    return n


def _sharded_bytes(tree, specs) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize // _factor(s)
               for x, s in zip(leaves, spec_leaves))


def _reference_argument_bytes(arch, shape):
    cfg = r_get_config(arch)
    sh = R_SP.SHAPES[shape]
    spec = R_SP.input_specs(cfg, shape)
    aparams = R_SP.abstract_params(cfg)
    pspecs = R_SH.param_specs(cfg, aparams, MESH)
    bspec = R_SH.batch_specs(MESH, sh["batch"])
    P = jax.sharding.PartitionSpec
    if sh["kind"] == "train":
        state = R_ST.abstract_train_state(cfg)
        zspecs = R_SH.zero1_specs(pspecs, aparams, MESH)
        batch = spec["batch_inputs"]
        return (_sharded_bytes(state["params"], pspecs)
                + _sharded_bytes(state["opt"]["m"], zspecs)
                + _sharded_bytes(state["opt"]["v"], zspecs)
                + _sharded_bytes(batch, {k: P(bspec, *([None] * (
                    len(v.shape) - 1))) for k, v in batch.items()}))
    cspecs = R_SH.cache_specs(cfg, spec["cache"], MESH, batch=sh["batch"])
    return (_sharded_bytes(aparams, pspecs)
            + _sharded_bytes(spec["cache"], cspecs)
            + _sharded_bytes(spec["tokens"], P(bspec, None)))


def _zero1_leaves(arch):
    """(ZeRO-1 leaves, the other leaves, the clip's groups as axis sets)
    by the reference's specs."""
    cfg = r_get_config(arch)
    aparams = R_SP.abstract_params(cfg)
    pspecs = R_SH.param_specs(cfg, aparams, MESH)
    zspecs = R_SH.zero1_specs(pspecs, aparams, MESH)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    ps = jax.tree.leaves(pspecs, is_leaf=is_p)
    zs = jax.tree.leaves(zspecs, is_leaf=is_p)
    zero1 = sum(tuple(p) != tuple(z) for p, z in zip(ps, zs))
    groups = set()
    for p, z in zip(ps, zs):
        axes = [a for e in z for a in ((e,) if isinstance(e, str)
                                       else (e or ()))]
        if tuple(p) == tuple(z):
            axes = [a for e in p for a in ((e,) if isinstance(e, str)
                                           else (e or ()))]
        groups.add(tuple(sorted(set(axes))))
    return zero1, len(ps) - zero1, groups - {()}


def _expected_collectives(arch, shape):
    """{c10d op: count} of one step of the cell (module doc)."""
    cfg = t_get_config(arch)
    L = cfg.n_layers
    if (arch, shape) == ("llama3-2-3b", "train_4k"):
        # attention replicated (24 / 8 heads), the vocabulary and the MLP
        # over ``model``: per layer the MLP's forward sum and its entry's
        # backward sum; the embedding's sum, the readout entry's backward
        # sum, the cross-entropy's max, sum of exponentials and label
        # logit; over ``data`` the loss and the auxiliary, each other
        # leaf's gradient, and per clip group one sum per axis; each
        # ZeRO-1 leaf one reduce-scatter and one all-gather
        zero1, other, groups = _zero1_leaves(arch)
        clip = sum(len(g) for g in groups)
        return {"c10d.allreduce_": 2 * L + 5 + 2 + other + clip,
                "c10d._reduce_scatter_base_": zero1,
                "c10d.allgather_": zero1}
    if (arch, shape) == ("llama3-2-3b", "decode_32k"):
        # the cache's sequence over ``model``: per layer the flash-decode
        # max and sum and the MLP's sum; the embedding's sum; the logits
        # gathered over the vocabulary
        return {"c10d.allreduce_": 3 * L + 1, "c10d.allgather_": 1}
    # mamba2-130m: 24 heads and a vocabulary of 50280 do not split over
    # 16: nothing is cut over ``model``, and the batch of one is not cut
    return {}


def _expected_flops(arch, shape):
    cfg = t_get_config(arch)
    sh = T_SP.SHAPES[shape]
    m = MESH.shape["model"]
    L, d = cfg.n_layers, cfg.d_model
    if cfg.family == "dense":
        B = sh["batch"] // MESH.shape["data"]
        h, kh, hd, V = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
            cfg.vocab_size
        attn_p = d * (h + 2 * kh) * hd + h * hd * d       # replicated
        layer = attn_p + 3 * d * cfg.d_ff // m
        readout = V * d // m
        if sh["kind"] == "train":
            S = sh["seq"]
            tok = B * S
            passes = 3 + (1 if cfg.remat else 0)
            scores = 4 * B * h * S * S * hd               # QKᵀ and PV
            return 2 * tok * passes * L * layer + 6 * tok * readout \
                + passes * L * scores
        T = sh["seq"] // m                  # this rank's cache slice
        return 2 * B * (L * layer + readout) + L * 4 * B * h * T * hd
    di, n, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    g = cfg.ssm_n_groups
    layer = d * (2 * di + 2 * g * n + H) + di * d
    # the state's readout C·S, 2·H·P·N a token (the update's outer
    # product is elementwise)
    return 2 * (L * layer + cfg.vocab_size * d) + L * 2 * H * P * n


@pytest.mark.parametrize("cell", CELLS, ids=["_".join(c) for c in CELLS])
def test_cell_is_ok_with_reference_keys(records, cell):
    rec = records[cell]
    assert rec["status"] == "ok", rec.get("error")
    for k in KEYS:
        assert k in rec, k
    assert rec["counted_by"] == "torch"
    assert rec["depth"] == {"counted": "full",
                            "n_layers": t_get_config(cell[0]).n_layers}
    assert set(rec["roofline"]) == {"compute_s", "memory_s",
                                    "collective_s"}
    assert rec["bottleneck"] in rec["roofline"]
    assert rec["memory"]["peak_per_device"] >= \
        rec["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("cell", CELLS, ids=["_".join(c) for c in CELLS])
def test_argument_bytes_match_reference_specs(records, cell):
    assert records[cell]["memory"]["argument_bytes"] == \
        _reference_argument_bytes(*cell)


@pytest.mark.parametrize("cell", CELLS, ids=["_".join(c) for c in CELLS])
def test_collective_counts_match_the_analytic_count(records, cell):
    got = records[cell]["collectives"]["counts_by_op"]
    assert got == _expected_collectives(*cell)
    assert records[cell]["collectives"]["count"] == sum(got.values())


@pytest.mark.parametrize("cell", CELLS, ids=["_".join(c) for c in CELLS])
def test_flops_per_device_match_the_analytic_count(records, cell):
    got = records[cell]["flops_per_device"]
    want = _expected_flops(*cell)
    assert abs(got - want) <= FLOPS_TOL * want, (got, want)


def test_model_flops_match_reference(monkeypatch):
    """The reference's ``model_flops`` for every arch and shape. Its
    module sets ``XLA_FLAGS`` to 512 host devices at import: jax's
    backend is up before, and the variable is put back after."""
    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as R_DR

    for arch in r_archs():
        for shape in R_SP.SHAPES:
            assert T_DR.model_flops(t_get_config(arch), shape) == \
                R_DR.model_flops(r_get_config(arch), shape)


def test_long_500k_skips_the_reference_set():
    """``long_500k`` is skipped, before any world starts, for exactly the
    archs the reference's dry run skips, with its reason."""
    for arch in r_archs():
        skip = not R_SP.long_context_ok(r_get_config(arch))
        assert (not T_SP.long_context_ok(t_get_config(arch))) == skip
        if skip:
            rec = T_DR.run_cell(arch, "long_500k")
            assert rec["status"] == "skipped"
            assert rec["reason"].startswith("pure full-attention arch")
