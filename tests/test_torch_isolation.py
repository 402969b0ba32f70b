"""The port stands alone: it imports neither JAX nor anything of the JAX
package, and its entry points never fall back to the CPU."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
CUDA_SOURCES = sorted(PKG.rglob("*.cu")) + sorted(PKG.rglob("*.cuh"))
# the CUDA C++ sources stand alone: the toolkit's headers, the port's own
# (csrc/*.cuh) and nothing of PyTorch, JAX or either package (a plain C
# interface bound with ctypes)
# cuda.h for the TMA tensor-map types only: the kernels reach the driver's
# cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, not -lcuda
CUDA_HEADERS = {"cuda.h", "cuda_runtime.h", "cuda_bf16.h", "cuda_fp16.h",
                "stdint.h"} | {p.name for p in PKG.rglob("*.cuh")}

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
for m in ("repro_torch.models.ssm", "repro_torch.kernels.ssd_scan",
          "repro_torch.configs.mamba2_130m", "repro_torch.configs.zamba2_7b",
          "repro_torch.fl.baselines", "repro_torch.fl.multiround",
          "repro_torch.fl.federation", "repro_torch.fl.faults",
          "repro_torch.checkpoint.io", "repro_torch.core.graph",
          "repro_torch.optim.ldam", "repro_torch.optim.schedules",
          "repro_torch.launch.quickstart",
          "repro_torch.launch.hetero_oneshot", "repro_torch.models.moe",
          "repro_torch.configs.gemma3_4b",
          "repro_torch.configs.deepseek_v2_lite_16b",
          "repro_torch.configs.deepseek_v2_236b",
          "repro_torch.configs.llama3_2_vision_11b",
          "repro_torch.launch.mesh", "repro_torch.launch.shardings",
          "repro_torch.fl.sharding", "repro_torch.launch.specs"):
    assert m in names, m
assert "triton" not in sys.modules
"""


def test_importing_every_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_imports_jax_or_repro(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, name)


@pytest.mark.parametrize("path", CUDA_SOURCES, ids=lambda p: p.name)
def test_cuda_sources_include_only_the_toolkit(path):
    text = path.read_text()
    includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', text,
                          re.MULTILINE)
    assert includes and set(includes) <= CUDA_HEADERS, (path, includes)
    # a library's source exports its C interface; a header only helpers
    assert ('extern "C"' in text) == (path.suffix == ".cu"), path


def test_there_are_cuda_sources():
    assert [p.name for p in CUDA_SOURCES] == ["flash_attention.cu",
                                              "flash_attention_sm90.cu",
                                              "paged_attention.cu",
                                              "ssd_scan.cu",
                                              "ssd_scan_sm90.cu",
                                              "sm90_common.cuh"]


def _entry_points():
    from repro_torch.configs import backend, smoke
    from repro_torch.core import img_generator_init, train_dense_server
    from repro_torch.fl import build_federation
    from repro_torch.models import CNNSpec, cnn_init
    from repro_torch import interop
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import paging
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    from repro_torch.core.dense_llm import make_llm_dense_steps
    from repro_torch.core.generator import tok_generator_init
    from repro_torch.launch.dense_llm_oneshot import (SMOKE_MOE,
                                                      dense_llm_oneshot)
    from repro_torch.launch.steps import make_train_state
    from repro_torch.launch.train import train

    scfg = smoke()
    lm = get_smoke_config("llama3.2-3b")
    mamba = get_smoke_config("mamba2-130m")
    zamba = get_smoke_config("zamba2-7b")
    data = {"train": (np.zeros((8, 16, 16, 3), np.float32),
                      np.zeros(8, np.int32))}
    return {
        "cnn_init": lambda: cnn_init(CNNSpec()),
        "img_generator_init": lambda: img_generator_init(),
        "build_federation": lambda: build_federation(scfg, data),
        "train_dense_server": lambda: train_dense_server([], scfg),
        "resolve_exec_policy": lambda: backend.resolve_exec_policy(scfg),
        "cnn_from_ref": lambda: interop.cnn_from_ref({}, CNNSpec()),
        "init_model": lambda: transformer.init_model(lm),
        "init_cache": lambda: transformer.init_cache(lm, 1, 4),
        "init_paged_cache": lambda: paging.init_paged_cache(
            lm, max_reqs=1, n_blocks=2, page=4),
        "ServeEngine": lambda: ServeEngine(lm),
        "serve": lambda: serve("llama3.2-3b", batch=1, prompt_len=2, gen=1),
        "lm_params_from_reference": lambda: interop.lm_params_from_reference(
            {}, lm),
        "tok_generator_init": lambda: tok_generator_init(d_model=8),
        "tok_generator_from_reference": lambda:
            interop.tok_generator_from_reference(
                {"z_proj": {"w": np.zeros((2, 4))}, "blocks": []}, seq=4,
                d_model=8),
        "make_train_state": lambda: make_train_state(lm),
        "train": lambda: train("llama3.2-3b", steps=1, batch=1, seq=4,
                               smoke=True),
        "make_llm_dense_steps": lambda: make_llm_dense_steps(lm, [lm]),
        "dense_llm_oneshot": lambda: dense_llm_oneshot(),
        "init_model_ssm": lambda: transformer.init_model(mamba),
        "init_cache_hybrid": lambda: transformer.init_cache(zamba, 1, 4),
        "init_paged_cache_hybrid": lambda: paging.init_paged_cache(
            zamba, max_reqs=1, n_blocks=2, page=4),
        "ServeEngine_ssm": lambda: ServeEngine(mamba),
        "train_ssm": lambda: train("mamba2-130m", steps=1, batch=1, seq=4,
                                   smoke=True),
        "train_moe": lambda: train("deepseek-v2-lite-16b", steps=1, batch=1,
                                   seq=4, smoke=True),
        "train_vlm": lambda: train("llama3.2-vision-11b", steps=1, batch=1,
                                   seq=4, smoke=True),
        "dense_llm_oneshot_moe": lambda: dense_llm_oneshot(SMOKE_MOE),
    }


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


@pytest.mark.parametrize("name", ["cnn_init", "img_generator_init",
                                  "build_federation", "train_dense_server",
                                  "resolve_exec_policy", "cnn_from_ref",
                                  "init_model", "init_cache",
                                  "init_paged_cache", "ServeEngine", "serve",
                                  "lm_params_from_reference",
                                  "tok_generator_init",
                                  "tok_generator_from_reference",
                                  "make_train_state", "train",
                                  "make_llm_dense_steps",
                                  "dense_llm_oneshot", "init_model_ssm",
                                  "init_cache_hybrid",
                                  "init_paged_cache_hybrid",
                                  "ServeEngine_ssm", "train_ssm",
                                  "train_moe", "train_vlm",
                                  "dense_llm_oneshot_moe"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_gpu, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_unported_paths_are_refused():
    """What the port refuses, it refuses as the reference does: the paged
    engine under a model axis of more than one rank (model parallelism,
    ROADMAP.md Queue 1 item 16, serves in dense mode there:
    tests/test_torch_model_axis.py). The fused epoch driver (7), the scaling
    layers (11) and the client mesh (``ensemble_shard_mode="clients"``,
    tests/test_torch_mesh_spmd.py) resolve and run
    (tests/test_torch_fused.py, tests/test_torch_scale.py); fault
    tolerance and checkpoints (item 6) run: an unknown nan_policy is a
    ValueError, as in the reference, and so is an unknown shard mode."""
    import dataclasses

    from repro_torch.configs import backend, smoke
    from repro_torch.core import train_dense_server

    for knob, field, want in (({"loop_mode": "fused"}, "loop", "fused"),
                              ({"teacher_chunk": 4}, "teacher_chunk", 4),
                              ({"ensemble_shard_mode": "clients"},
                               "ensemble_shard", "clients")):
        pol = backend.resolve_exec_policy(
            dataclasses.replace(smoke(), **knob), device="cpu")
        assert getattr(pol, field) == want
    assert backend.resolve_exec_policy(smoke(),
                                       device="cpu").ensemble_shard == "none"
    with pytest.raises(ValueError, match="ensemble_shard_mode"):
        backend.resolve_exec_policy(
            dataclasses.replace(smoke(), ensemble_shard_mode="pods"),
            device="cpu")
    with pytest.raises(ValueError, match="nan_policy"):
        train_dense_server([], dataclasses.replace(smoke(),
                                                   nan_policy="ostrich"),
                           device="cpu")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(ValueError, match="model_parallel=True"):
        ServeEngine(get_smoke_config("llama3.2-3b"), mode="paged",
                    mesh=make_production_mesh(), device="cpu")
