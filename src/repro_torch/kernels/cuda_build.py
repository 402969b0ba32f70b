"""Build the port's CUDA C++ kernels and load them with ``ctypes``.

Each source ``csrc/<name>.cu`` exports a plain C interface (pointers, the
stream and ints; it returns ``cudaGetLastError()``), so ``nvcc`` builds
it into a shared library in seconds, without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/cuda/lib<name>-<hash>.so

The library goes to ``build/cuda/`` at the root of the checkout, named by
a hash of its source, the port's headers it includes and the flags, so an
edited source or header is rebuilt and concurrent builds never see a
half-written file (each writes a private temporary and renames it). ``build_logs[name]`` keeps ``nvcc``'s output
(``-Xptxas -v``: registers, shared memory and spills per kernel). A
missing ``nvcc`` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parents[3] / "build" / "cuda"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on the PATH, else under PyTorch's
    ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(cand):
        raise RuntimeError("nvcc not found (not on PATH, no CUDA_HOME): the "
                           "CUDA kernels are built at first use and need "
                           "the CUDA toolkit")
    return cand


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    # the port's own headers the source includes ("sm90_common.cuh")
    headers = b"".join((CSRC / h.decode()).read_bytes() for h in
                       re.findall(rb'^\s*#\s*include\s*"([^"]+)"', text,
                                  re.MULTILINE))
    digest = hashlib.sha256(text + headers
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return src, BUILD / f"lib{name}-{digest}.so"


def build(names) -> None:
    """Build every library of ``names`` not built yet, one ``nvcc`` each,
    all started together."""
    jobs = []
    for name in names:
        src, so = _target(name)
        if so.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(src)]
        jobs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("building the CUDA kernels failed: "
                           + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at first use."""
    if name not in _libs:
        build([name])
        _libs[name] = ctypes.CDLL(str(_target(name)[1]))
    return _libs[name]
