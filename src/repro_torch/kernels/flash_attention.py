"""K2 on Hopper: flash attention, forward and backward, in CUDA C++.

Replaces the Pallas kernels of ``repro/kernels/flash_attention.py``:

  * K2f, ``flash_attention`` (``_fwd_flat``/``_flash_kernel``): causal or
    windowed GQA attention with an online softmax; it saves the float32
    output ``o_f32`` and the per-row ``lse = m + log l``, NEG_INF for a
    row with no live key;
  * K2q, ``flash_attention_bwd``'s dq pass: p recomputed from lse,
    ds = p·(dO·Vᵀ − delta), dq = ds·K·scale, streaming k-blocks;
  * K2kv, its dk/dv pass: dv = Pᵀ·dO and dk = dSᵀ·Q·scale per k-block,
    streaming the g query heads of the KV head and their q-blocks.

Why CUDA C++ and not Triton: each kernel is a pair of blocked matrix
products per tile with an online softmax between them, neither an
elementwise pass nor a plain reduction. The sources say how the tiles and
threads are laid out and what bounds them: the operations (a causal call
does ~2·Sq·Sk·D flops a head per matrix product).

Each kernel has two routes, chosen from the dtype and head dim alone
(``route``): bfloat16 and float16 at D 64, 112 and 128
(``SM90_HEAD_DIMS``) take ``sm90``, the tensor-core kernels of
``csrc/flash_attention_sm90.cu`` (wgmma for every tile product, TMA tile
loads into a two-stage ring); float32 takes ``sm90`` at every head dim
for all three kernels, the same file's float32 kernels for Hopper's CUDA
cores (exact float32, ``cp.async`` tile rings, register micro-tiles);
16-bit calls at D 32 take ``simt``, ``csrc/flash_attention.cu``'s first
version, which a measurement may also name to time it beside sm90.
``fwd_routes`` and ``bwd_routes`` count the launches of each route,
``dq_routes`` and ``dkv_routes`` each backward kernel's apart. K2q and
K2kv always share a route; they read dO in float32 on simt and in the
input's type on sm90 (16 bits, as wgmma takes it, or float32).

The residual contract is the reference's (``flash_attention.py:396-440``):
the forward keeps q, k, v, ``o_f32`` (B·Hq, Sq, D) and ``lse`` (B·Hq, Sq);
the backward computes delta = Σ_d dO·o_f32 from the float32 residual (a
torch reduction, as the reference computes it in XLA) and re-streams the
tiles, so neither direction materializes the (Sq, Sk) probabilities.
Layout: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), contiguous; the q
tokens are the last Sq of the Sk keys.

Each wrapper checks its inputs, then on a CPU tensor runs the plain
version beside it (the materialized softmax over the whole (Sq, Sk), the
same arithmetic in torch ops), and on a CUDA tensor launches the kernel,
built with ``nvcc`` at first use (``kernels/cuda_build.py``), on the
current stream, or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import cuda_build

NEG_INF = -2.0 ** 30

launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
# K2f's launches by route (each also counts in launches["flash_attention_fwd"])
fwd_routes = {"sm90": 0, "simt": 0}
# K2q's and K2kv's launches by route: a backward counts once per kernel
bwd_routes = {"sm90": 0, "simt": 0}
# and each kernel's apart (each launch also counts in bwd_routes)
dq_routes = {"sm90": 0, "simt": 0}
dkv_routes = {"sm90": 0, "simt": 0}

# torch dtype -> the C interface's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (32, 64, 112, 128)     # the kernels' template instances
# the head dims the sm90 route takes in 16 bits (D 112 stored padded to
# 128); in float32 it takes every head dim
SM90_HEAD_DIMS = (64, 112, 128)
_fn: dict = {}


def _launchers() -> dict:
    if not _fn:
        lib = cuda_build.load("flash_attention")
        ints = [ctypes.c_int] * 8
        for name, n_ptrs in (("fwd", 5), ("bwd_dq", 7), ("bwd_dkv", 8)):
            fn = getattr(lib, f"flash_attention_{name}_launch")
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + ints
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fn[name] = fn
        sm90 = cuda_build.load("flash_attention_sm90")
        for name, symbol in (("fwd", "flash_attention_fwd_sm90_launch"),
                             ("bwd_dq", "flash_attention_sm90_bwd_dq_launch"),
                             ("bwd_dkv",
                              "flash_attention_sm90_bwd_dkv_launch")):
            fn = getattr(sm90, symbol)
            fn.argtypes = _fn[name].argtypes
            fn.restype = ctypes.c_int
            _fn[f"{name}_sm90"] = fn
        err = lib.flash_attention_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn["error"] = err
    return _fn


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention takes q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, "
            f"D) of one shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    B, hq, _, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or k.shape[1] == 0 \
            or hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: "
                         "batch and head dim must agree and Hq must be a "
                         "multiple of Hkv")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of float32, bfloat16, "
                        f"float16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention's tensors lie on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _check_cuda(d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"the K2 kernels take head dims {HEAD_DIMS}, not {d}")


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _check_aligned(which: str, *tensors) -> None:
    """The sm90 route reads these tensors by TMA (16 bits) or 16-byte
    ``cp.async`` (float32), which need 16-byte aligned bases: anything
    else is refused before a launch."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"K2's sm90 {which} loads its tiles by TMA or "
                         "cp.async, which need 16-byte aligned tensors")


def _raise_on(err: int, which: str) -> None:
    if err:
        raise RuntimeError(f"the K2 {which} launch failed: CUDA error {err} "
                           f"({_launchers()['error'](err).decode()})")


def mask(sq: int, sk: int, *, causal: bool, window: int, device):
    """(Sq, Sk) validity: the q tokens are the last Sq of the Sk keys."""
    q_pos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    k_idx = torch.arange(sk, device=device)[None, :]
    live = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        live &= k_idx <= q_pos
    if window:
        live &= q_pos - k_idx < window
    return live


# ---------------------------------------------------------------- K2f --

def route(which: str, dtype, d: int) -> str:
    """The route the kernel ``which`` (``"fwd"``, ``"dq"`` or ``"dkv"``)
    takes for a CUDA call: ``"sm90"`` for bfloat16 and float16 at
    ``SM90_HEAD_DIMS`` (tensor cores) and for float32 at every head dim
    (CUDA cores), ``"simt"`` otherwise (16 bits at D 32); the three
    kernels take one route at every dtype and head dim."""
    return "sm90" if dtype == torch.float32 or d in SM90_HEAD_DIMS \
        else "simt"


def flash_attention_fwd_plain(q, k, v, *, causal=True, window=0, scale=None):
    """The forward's arithmetic over the whole (Sq, Sk): (o_f32 (B·Hq, Sq,
    D), lse (B·Hq, Sq)), float32; rows with no live key give o = 0 and
    lse = NEG_INF."""
    B, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = _scale(q, scale)
    qg = q.float().reshape(B, hkv, hq // hkv, sq, d)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    live = mask(sq, sk, causal=causal, window=window, device=q.device)
    s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True) if sk else \
        torch.full((*s.shape[:-1], 1), NEG_INF, device=q.device)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)
    denom = torch.clamp(l, min=1e-30)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float()) / denom[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(denom), NEG_INF)
    return o.reshape(B * hq, sq, d), lse.reshape(B * hq, sq)


def flash_attention_fwd(q, k, v, *, causal=True, window=0, scale=None):
    """q (B, Hq, Sq, D), k, v (B, Hkv, Sk, D) -> (o_f32 (B·Hq, Sq, D),
    lse (B·Hq, Sq)), float32."""
    _check(q, k, v, window)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, scale=scale)
    return _fwd_launch(q, k, v, causal, window, scale,
                       route("fwd", q.dtype, q.shape[-1]))


def _fwd_launch(q, k, v, causal, window, scale, kernel):
    """K2f on CUDA tensors that ``_check`` passed, by the given route
    ``kernel`` (``flash_attention_fwd`` takes ``route("fwd", ...)``'s; a
    measurement may time the simt kernel at a shape the sm90 route
    takes)."""
    B, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    _check_cuda(d)
    if q.numel() == 0 or sk == 0:       # no key: every row is dead
        return (torch.zeros((B * hq, sq, d), device=q.device),
                torch.full((B * hq, sq), NEG_INF, device=q.device))
    if kernel == "sm90":
        _check_aligned("forward", q, k, v)
    o = torch.empty((B * hq, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((B * hq, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _launchers()["fwd_sm90" if kernel == "sm90" else "fwd"](
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, hq, hkv, sq, sk, d, int(causal),
            int(window), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, f"forward (K2f, {kernel})")
    launches["flash_attention_fwd"] += 1
    fwd_routes[kernel] += 1
    return o, lse


# --------------------------------------------------------- K2q, K2kv --

def flash_attention_bwd_plain(q, k, v, o_f32, lse, do, *, causal=True,
                              window=0, scale=None):
    """The backward's arithmetic with p recomputed over the whole (Sq, Sk)
    from lse: (dq, dk, dv) in the input dtypes."""
    B, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = _scale(q, scale)
    qf = q.float().reshape(B, hkv, g, sq, d)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, hkv, g, sq, d)
    delta = (dof * o_f32.reshape(B, hkv, g, sq, d)).sum(dim=-1)
    s = torch.einsum("bkgsd,bktd->bkgst", qf, kf) * scale
    live = mask(sq, sk, causal=causal, window=window, device=q.device)
    p = torch.where(live, torch.exp(s - lse.reshape(B, hkv, g, sq, 1)), 0.0)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dof)
    dp = torch.einsum("bkgsd,bktd->bkgst", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qf) * scale
    return (dq.reshape(B, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def bwd_operands(q, o_f32, do):
    """What the backward kernels read beside q, k, v and lse: delta =
    Σ_d dO·o_f32 (B·Hq, Sq) in float32, and dO (B·Hq, Sq, D), contiguous,
    in their route's type: float32 for simt, q's type for sm90 (16 bits,
    or float32 for a float32 q)."""
    B, hq, sq, d = q.shape
    dof = do.float().contiguous().reshape(B * hq, sq, d)
    delta = (dof * o_f32).sum(dim=-1)
    if q.dtype == torch.float32 or route("dq", q.dtype, d) == "simt":
        return delta, dof
    return delta, do.to(q.dtype).contiguous().reshape(B * hq, sq, d)


def flash_attention_bwd(q, k, v, o_f32, lse, do, *, causal=True, window=0,
                        scale=None):
    """Gradients of the attention under the output cotangent ``do``
    (B, Hq, Sq, D), from the forward's residuals: (dq, dk, dv) in the
    input dtypes. ``do`` may be strided. delta = Σ_d dO·o_f32 is taken in
    float32; both kernels read dO in their route's type (``bwd_operands``):
    on simt in float32, on sm90 in q's dtype (float32 for a float32 q;
    exact in 16 bits on the autograd path, where the cotangent arrives in
    q's dtype; a float32 ``do`` beside a 16-bit q is rounded once)."""
    _check(q, k, v, window)
    B, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    for name, t, shape in (("o_f32", o_f32, (B * hq, sq, d)),
                           ("lse", lse, (B * hq, sq))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} float32 "
                             f"tensor on {q.device}")
    if tuple(do.shape) != tuple(q.shape) or do.device != q.device:
        raise ValueError(f"do must be {tuple(q.shape)} on {q.device}, got "
                         f"{tuple(do.shape)} on {do.device}")
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o_f32, lse, do,
                                         causal=causal, window=window,
                                         scale=scale)
    _check_cuda(d)
    delta, do_k = bwd_operands(q, o_f32, do)
    kw = {"causal": causal, "window": window, "scale": scale}
    return (flash_attention_bwd_dq(q, k, v, do_k, lse, delta, **kw),
            *flash_attention_bwd_dkv(q, k, v, do_k, lse, delta, **kw))


def _bwd_launch(which, q, k, v, do, lse, delta, outs, causal, window,
                scale, kernel):
    B, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"the K2 {which} kernel takes CUDA tensors; "
                         "flash_attention_bwd runs the plain version on the "
                         "CPU")
    _check_cuda(d)
    if kernel is None:
        kernel = route(which, q.dtype, d)
    if q.numel() == 0 or sk == 0:       # no key: no gradient
        for t in outs:
            t.zero_()
        return
    do = do.to(torch.float32 if kernel == "simt" else q.dtype)
    if kernel == "sm90":
        _check_aligned(which, q, k, v, do)
    with torch.cuda.device(q.device):
        err = _launchers()[f"bwd_{which}" + ("_sm90" if kernel == "sm90"
                                             else "")](
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outs), B, hq, hkv, sq, sk, d,
            int(causal), int(window), _scale(q, scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, f"{which} (K2{'q' if which == 'dq' else 'kv'}, {kernel})")
    launches[f"flash_attention_bwd_{which}"] += 1
    bwd_routes[kernel] += 1
    (dq_routes if which == "dq" else dkv_routes)[kernel] += 1


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True,
                           window=0, scale=None, route=None):
    """K2q alone on CUDA tensors: dq in q's dtype from dO (B·Hq, Sq, D),
    lse and delta (B·Hq, Sq) float32, all contiguous (as
    ``flash_attention_bwd`` prepares them). ``route`` None takes
    ``route("dq", ...)``'s (a measurement may name ``"simt"`` to time the
    first version). dO is converted to the route's dtype if it is not in
    it: float32 for simt (exact), q's dtype for sm90 (exact for a float32
    q; beside a 16-bit q a float32 dO rounds once)."""
    dq = torch.empty_like(q)
    _bwd_launch("dq", q, k, v, do, lse, delta, (dq,), causal, window, scale,
                route)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True,
                            window=0, scale=None, route=None):
    """K2kv alone on CUDA tensors: (dk, dv) in k's dtype, from the same
    inputs as ``flash_attention_bwd_dq``; ``route`` None takes
    ``route("dkv", ...)``'s."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("dkv", q, k, v, do, lse, delta, (dk, dv), causal, window,
                scale, route)
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the K2 backward (the reference's
    ``flash_attention_vjp``). Saves q, k, v, ``o_f32`` and ``lse`` only;
    the backward re-streams the tiles."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, window: int = 0,
                scale=None):
        o_f32, lse = flash_attention_fwd(q, k, v, causal=causal,
                                         window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o_f32, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        # a copy even in float32: the output must not alias the residual
        return o_f32.reshape(q.shape).to(q.dtype, copy=True)

    @staticmethod
    def backward(ctx, g):
        q, k, v, o_f32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o_f32, lse, g,
                                         causal=ctx.causal,
                                         window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None, None
