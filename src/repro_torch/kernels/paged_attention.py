"""K4 on Hopper: paged decode attention, written in CUDA C++.

Replaces the Pallas kernel ``paged_attention`` (``_paged_kernel``) in
``repro/kernels/paged_attention.py``: one query token per request slot
against a block-pool KV cache, gathered through the block table, online
softmax under an unconditional live mask, zero mass from dead slots and
exact zeros where ``seq_lens == 0``. Forward only: decoding never
differentiates, so there is no backward kernel.

Why CUDA C++ and not Triton: the work is a gather through a table
followed by two small products per block (G×page scores and a G×D
output), neither an elementwise pass nor a plain reduction.

Bound: memory. A call reads every live K and V row once,
2·Σseq_lens·Hkv·D elements, plus q and writes out, at 3.35 TB/s on an
H100 SXM; its ~4·Σseq_lens·Hq·D flops are G = Hq/Hkv flops a byte of
K/V, so neither CUDA cores nor tensor cores limit it.

Two routes, both in ``csrc/paged_attention.cu``, which says how each is
laid out:

* ``sm90``, every CUDA call's: the context split over CTAs (``split_plan``
  picks the splits from shapes alone), each warp staging whole pages with
  16-byte ``cp.async`` into its own two-chunk ring in the pool's dtype,
  (m, l, acc) in float32 registers, one merge of the splits (a second
  small kernel, launched from the same C entry) in a fixed order.
  ``paged_attention_split_plain`` is its arithmetic in PyTorch.
* ``simt``, the first version (one CTA per (KV head, request) walking
  its live pages), reached only by ``route="simt"`` on a direct call so a
  measurement can time it beside ``sm90``.

``paged_attention`` checks its inputs, then on a CPU tensor runs the
plain version (``paged_attention_plain``, the gather-then-softmax of
``kernels/ref.py``), and on a CUDA tensor launches a route's kernel,
built with ``nvcc`` at first use (``kernels/cuda_build.py``), on the
current stream, or raises. ``launches`` counts calls that launched a
route (its merge included), ``routes`` the same calls by route.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ref import NEG_INF
from repro_torch.kernels.ref import paged_attention as paged_attention_plain

launches = {"paged_attention": 0}
# K4's launches by route (each also counts in launches["paged_attention"])
routes = {"sm90": 0, "simt": 0}

# torch dtype -> the C interface's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (32, 64, 112, 128)     # the kernels' template instances
_SIMT_SMEM_LIMIT = 48 * 1024       # the first version's static launch cap
# a split holds at least this many tokens, so every warp has a page at
# page 16 and a split's fixed cost is spread over a few pages
MIN_SPLIT_TOKENS = 64
_fn: dict = {}
_n_sm: dict = {}


def _launchers() -> dict:
    if not _fn:
        lib = cuda_build.load("paged_attention")
        simt = lib.paged_attention_launch
        simt.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                         + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                 ctypes.c_void_p])
        sm90 = lib.paged_attention_sm90_launch
        sm90.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                         + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                 ctypes.c_void_p])
        for fn in (simt, sm90):
            fn.restype = ctypes.c_int
        err = lib.paged_attention_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn.update(simt=simt, sm90=sm90, err=err)
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


def split_plan(R: int, hkv: int, m_slots: int, page: int,
               n_sm: int) -> tuple[int, int]:
    """(splits, table slots a split) for the sm90 route, from shapes
    alone: no device value, so a call needs no host sync.

    One split when the R·Hkv (KV head, request) pairs fill two waves of
    SMs by themselves; otherwise about four CTAs an SM, each split at
    least ``MIN_SPLIT_TOKENS`` tokens. The splits cover all ``m_slots``
    slots, the last one possibly short."""
    pairs = R * hkv
    if m_slots <= 1 or pairs >= 2 * n_sm:
        return 1, max(m_slots, 1)
    want = -(-4 * n_sm // pairs)
    pps = min(m_slots, max(-(-m_slots // want),
                           -(-MIN_SPLIT_TOKENS // page)))
    return -(-m_slots // pps), pps


def paged_attention_split_plain(q, k_pool, v_pool, block_tables, seq_lens,
                                *, pps: int, scale=None) -> torch.Tensor:
    """The sm90 route's arithmetic in PyTorch: split s takes table slots
    [s·pps, (s+1)·pps), forms its (acc, m, l) under the live mask, and
    the splits that hold a live token merge as Σ e^(m_s−m*)·acc_s /
    Σ e^(m_s−m*)·l_s. Lengths past the table are cut to it; rows with
    ``seq_lens == 0`` give exact zeros. (R, Hq, D) in q's dtype."""
    R, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    m_slots = block_tables.shape[1]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    n_split = max(1, -(-m_slots // pps))
    span = pps * page
    idx = block_tables.long()
    k = k_pool[idx].reshape(R, m_slots * page, hkv, d).float()
    v = v_pool[idx].reshape(R, m_slots * page, hkv, d).float()
    pad = n_split * span - m_slots * page
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    k, v = (t.reshape(R, n_split, span, hkv, d) for t in (k, v))
    qg = q.reshape(R, hkv, g, d).float()
    s = torch.einsum("rkgd,rntkd->rkgnt", qg, k) * scale
    length = seq_lens.clamp(0, m_slots * page).long()
    pos = torch.arange(n_split * span, device=q.device).reshape(n_split, span)
    live = (pos[None] < length[:, None, None])[:, None, None]  # R,1,1,n,t
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1)                                          # R,k,g,n
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("rkgnt,rntkd->rkgnd", p, v)
    split_live = (torch.arange(n_split, device=q.device)[None] * span
                  < length[:, None])[:, None, None]             # R,1,1,n
    m_star = torch.where(split_live, m, NEG_INF).amax(dim=-1, keepdim=True)
    w = torch.where(split_live, torch.exp(m - m_star), 0.0)
    num = (w[..., None] * acc).sum(dim=-2)
    den = (w * l).sum(dim=-1)
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(R, hq, d).to(q.dtype)


def _sm_count(device) -> int:
    """The card's SM count, read once a device."""
    i = device.index if device.index is not None \
        else torch.cuda.current_device()
    if i not in _n_sm:
        _n_sm[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _n_sm[i]


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, *,
                    scale=None, route=None) -> torch.Tensor:
    """Decode attention through a block table.

    q: (R, Hq, D); k/v_pool: (P, page, Hkv, D), one layer; block_tables:
    (R, M) int32 pool-block ids (entries past a request's live blocks
    are not read); seq_lens: (R,) int32 live cached tokens, the incoming
    token included. Returns (R, Hq, D) in q's dtype; rows with
    ``seq_lens == 0`` are zero. ``route`` (CUDA only): None or ``"sm90"``
    for the split-context kernel, ``"simt"`` for the first version."""
    _check(q, k_pool, v_pool, block_tables, seq_lens)
    route = "sm90" if route is None else route
    if route not in routes:
        raise ValueError(f"unknown K4 route {route!r}: take one of "
                         f"{tuple(routes)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     seq_lens, scale=scale)
    R, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    m_slots = block_tables.shape[1]
    g = hq // hkv
    if d not in HEAD_DIMS:
        raise ValueError(f"the K4 kernel takes head dims {HEAD_DIMS}, "
                         f"not {d}")
    # the sm90 layout does not grow with the page or G (rings of 16-row
    # chunks, at most 4 query heads a CTA): 72 KB at D 128; the first
    # version stages whole pages in float32
    if route == "simt" and 4 * (2 * g * d + g * page + 3 * g
                                + 2 * page * d) > _SIMT_SMEM_LIMIT:
        raise ValueError(f"{g} query heads per KV head, D={d} and page="
                         f"{page} need more shared memory than "
                         f"{_SIMT_SMEM_LIMIT} bytes on the simt route")
    out = torch.empty_like(q)
    if R == 0:
        return out
    fns = _launchers()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "sm90":
        # every HEAD_DIMS row is whole 16-byte vectors in every dtype
        if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
            raise ValueError("the K4 sm90 route reads q and the pools in "
                             "16-byte vectors: their data must be 16-byte "
                             "aligned")
        n_split, pps = split_plan(R, hkv, m_slots, page, _sm_count(q.device))
        part_acc = part_ml = None
        if n_split > 1:     # (acc (n_split, R, Hq, D), then (m, l) pairs)
            n = n_split * R * hq
            part = torch.empty(n * (d + 2), dtype=torch.float32,
                               device=q.device)
            part_acc = part.data_ptr()
            part_ml = part_acc + 4 * n * d
        with torch.cuda.device(q.device):
            err = fns["sm90"](
                _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                v_pool.data_ptr(), block_tables.data_ptr(),
                seq_lens.data_ptr(), out.data_ptr(), part_acc, part_ml, R,
                hq, hkv, d, page, m_slots, pps, n_split, float(scale), stream)
    else:
        with torch.cuda.device(q.device):
            err = fns["simt"](_DTYPES[q.dtype], q.data_ptr(),
                              k_pool.data_ptr(), v_pool.data_ptr(),
                              block_tables.data_ptr(), seq_lens.data_ptr(),
                              out.data_ptr(), R, hq, hkv, d, page, m_slots,
                              float(scale), stream)
    if err:
        raise RuntimeError(f"the K4 paged_attention launch ({route}) "
                           f"failed: CUDA error {err} "
                           f"({fns['err'](err).decode()})")
    launches["paged_attention"] += 1
    routes[route] += 1
    return out
