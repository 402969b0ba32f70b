"""K4 on Hopper: paged decode attention, written in CUDA C++.

Replaces the Pallas kernel ``paged_attention`` (``_paged_kernel``) in
``repro/kernels/paged_attention.py``: one query token per request slot
against a block-pool KV cache, gathered through the block table, online
softmax under an unconditional live mask, zero mass from dead slots and
exact zeros where ``seq_lens == 0``. Forward only: decoding never
differentiates, so there is no backward kernel.

Why CUDA C++ and not Triton: the work is a gather through a table
followed by two small products per block (G×page scores and a G×D
output), neither an elementwise pass nor a plain reduction. The source,
``csrc/paged_attention.cu``, says how it is laid out: one CTA per
(KV head, request), a loop over the request's live blocks only, each
block's live K and V rows staged in shared memory, the (m, l, acc) sums
in float32.

Bound: memory. A call reads every live K and V row once,
2·Σseq_lens·Hkv·D elements, plus q and writes out, at 3.35 TB/s on an
H100 SXM; its ~4·Σseq_lens·Hq·D flops are far below the float32 peak.

``paged_attention`` checks its inputs, then on a CPU tensor runs the
plain version (``paged_attention_plain``, the gather-then-softmax of
``kernels/ref.py``), and on a CUDA tensor launches the kernel, built with
``nvcc`` at first use (``kernels/cuda_build.py``), on the current
stream, or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ref import paged_attention as paged_attention_plain

launches = {"paged_attention": 0}

# torch dtype -> the C interface's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (32, 64, 112, 128)     # the kernel's template instances
_SMEM_LIMIT = 48 * 1024            # static launch limit of dynamic smem
_fn: list = []


def _launcher():
    if not _fn:
        lib = cuda_build.load("paged_attention")
        fn = lib.paged_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.paged_attention_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn.extend([fn, err])
    return _fn


def _check(q, k_pool, v_pool, block_tables, seq_lens) -> None:
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"paged_attention takes q (R, Hq, D) and two pools (P, page, "
            f"Hkv, D) of one shape, got {tuple(q.shape)}, "
            f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    R, hq, d = q.shape
    _, _, hkv, dk = k_pool.shape
    if dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"head dims {d} and {dk}, or {hq} query heads not "
                         f"a multiple of {hkv} KV heads")
    if block_tables.dim() != 2 or block_tables.shape[0] != R \
            or seq_lens.shape != (R,):
        raise ValueError(f"block_tables must be ({R}, M) and seq_lens "
                         f"({R},), got {tuple(block_tables.shape)}, "
                         f"{tuple(seq_lens.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q and the pools must share one of float32, "
                        f"bfloat16, float16; got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    tensors = (q, k_pool, v_pool, block_tables, seq_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention's tensors lie on different "
                         "devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"paged_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention takes contiguous tensors")


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, *,
                    scale=None) -> torch.Tensor:
    """Decode attention through a block table.

    q: (R, Hq, D); k/v_pool: (P, page, Hkv, D), one layer; block_tables:
    (R, M) int32 pool-block ids (entries past a request's live blocks
    are not read); seq_lens: (R,) int32 live cached tokens, the incoming
    token included. Returns (R, Hq, D) in q's dtype; rows with
    ``seq_lens == 0`` are zero."""
    _check(q, k_pool, v_pool, block_tables, seq_lens)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     seq_lens, scale=scale)
    R, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    g = hq // hkv
    if d not in HEAD_DIMS:
        raise ValueError(f"the K4 kernel takes head dims {HEAD_DIMS}, "
                         f"not {d}")
    if 4 * (2 * g * d + g * page + 3 * g + 2 * page * d) > _SMEM_LIMIT:
        raise ValueError(f"{g} query heads per KV head, D={d} and page="
                         f"{page} need more shared memory than "
                         f"{_SMEM_LIMIT} bytes")
    out = torch.empty_like(q)
    if R == 0:
        return out
    launch, err_str = _launcher()
    with torch.cuda.device(q.device):
        err = launch(_DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                     v_pool.data_ptr(), block_tables.data_ptr(),
                     seq_lens.data_ptr(), out.data_ptr(), R, hq, hkv, d,
                     page, block_tables.shape[1], float(scale),
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"the K4 paged_attention launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    launches["paged_attention"] += 1
    return out
