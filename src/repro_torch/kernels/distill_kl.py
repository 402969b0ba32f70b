"""K1 on Hopper: the distill-KL kernel pair, written in Triton.

Replaces the Pallas pair in ``repro/kernels/distill_kl.py``:

  * K1f, ``distill_kl`` (``_kl_fwd_kernel``): per-row
    KL(softmax(t) ‖ softmax(s)) over (R, V) logits with online
    log-sum-exp accumulators for both distributions and
    S = Σ_v e^{t_v − m_t}(t_v − s_v), so that
    KL = S / Z_t − lse_t + lse_s;
  * K1b, ``distill_kl_bwd`` (``_kl_bwd_kernel``): from the per-row
    statistics alone,
    dL/ds = g·(softmax(s) − softmax(t)) and, with the teacher gradient on,
    dL/dt = g·p·((t − lse_t) − (s − lse_s) − KL), p = softmax(t).

Why Triton and not CUDA C++: K1f is a row-wise online-softmax reduction
over vocab tiles and K1b an elementwise pass given per-row statistics.
Neither has a matrix product, so neither can use ``wgmma`` or gain from
TMA; both are bound by memory traffic. A program over a block of rows
with a loop over ``BLOCK_V``-wide vocab tiles, masked at the tail, is
what Triton expresses directly.

Design. On the TPU the forward's vocab axis is a sequential grid axis
whose accumulators live in revisited output blocks. Blocks of a GPU grid
run in no order, so here one program owns a block of rows and walks the
whole vocab in a loop, keeping m_t, Z_t, S, m_s and Z_s in registers; it
writes kl, lse_t and lse_s (the (m, Z) pairs folded once). The backward
is elementwise, so its grid is 2-D over (row block, vocab block). Loads
are in the input dtype (float32, bfloat16 or float16), arithmetic in
float32, gradients are stored in the input dtype. The ragged vocab tail
and ragged rows are masked on load, to ``NEG_INF`` before any
arithmetic, and on store. Neither pass writes an (R, V) softmax.

Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32):
  * the main path (R = 128 synthetic rows, V = 10 classes) moves about
    12 KB a pass, a few nanoseconds of bandwidth: K1 is bound there by
    launch latency, not by the card;
  * at vocabulary scale the forward reads 2·R·V·bytes (1.07 GB for
    R = 4096, V = 32768 in float32, 0.32 ms) and the backward reads as
    much and writes R·V·bytes per gradient; about 11 float32 operations
    per logit pair keep both far below the operation bound.

Beside each kernel is its plain PyTorch version: the same arithmetic in
torch ops (the analytic backward, not autograd). A wrapper runs the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30

launches = {"distill_kl_fwd": 0, "distill_kl_bwd": 0}

# ``triton.language``, bound by ``_kernels()`` on the first launch:
# triton is imported only where a kernel is launched.
tl = None
_jit: dict = {}

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _kl_fwd_kernel(t_ptr, s_ptr, kl_ptr, lse_t_ptr, lse_s_ptr, R, V,
                   BLOCK_R: tl.constexpr, BLOCK_V: tl.constexpr,
                   NEG: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    row_ok = rows < R
    base = rows.to(tl.int64)[:, None] * V
    m_t = tl.full((BLOCK_R,), NEG, tl.float32)
    z_t = tl.zeros((BLOCK_R,), tl.float32)
    acc = tl.zeros((BLOCK_R,), tl.float32)
    m_s = tl.full((BLOCK_R,), NEG, tl.float32)
    z_s = tl.zeros((BLOCK_R,), tl.float32)
    for v0 in range(0, V, BLOCK_V):
        cols = v0 + tl.arange(0, BLOCK_V)
        mask = row_ok[:, None] & (cols < V)[None, :]
        offs = base + cols[None, :]
        t = tl.load(t_ptr + offs, mask=mask, other=NEG).to(tl.float32)
        s = tl.load(s_ptr + offs, mask=mask, other=NEG).to(tl.float32)
        # online lse and weighted difference for the teacher
        mt_new = tl.maximum(m_t, tl.max(t, axis=1))
        a_t = tl.exp(m_t - mt_new)
        p = tl.exp(t - mt_new[:, None])
        z_t = z_t * a_t + tl.sum(p, axis=1)
        acc = acc * a_t + tl.sum(p * (t - s), axis=1)
        m_t = mt_new
        # online lse for the student
        ms_new = tl.maximum(m_s, tl.max(s, axis=1))
        z_s = z_s * tl.exp(m_s - ms_new) \
            + tl.sum(tl.exp(s - ms_new[:, None]), axis=1)
        m_s = ms_new
    lse_t = m_t + tl.log(z_t)
    lse_s = m_s + tl.log(z_s)
    tl.store(kl_ptr + rows, acc / z_t - lse_t + lse_s, mask=row_ok)
    tl.store(lse_t_ptr + rows, lse_t, mask=row_ok)
    tl.store(lse_s_ptr + rows, lse_s, mask=row_ok)


def _kl_bwd_kernel(t_ptr, s_ptr, lse_t_ptr, lse_s_ptr, kl_ptr, g_ptr,
                   dt_ptr, ds_ptr, R, V, BLOCK_R: tl.constexpr,
                   BLOCK_V: tl.constexpr, WITH_DT: tl.constexpr,
                   NEG: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
    row_ok = rows < R
    mask = row_ok[:, None] & (cols < V)[None, :]
    offs = rows.to(tl.int64)[:, None] * V + cols[None, :]
    t = tl.load(t_ptr + offs, mask=mask, other=NEG).to(tl.float32)
    s = tl.load(s_ptr + offs, mask=mask, other=NEG).to(tl.float32)
    lt = tl.load(lse_t_ptr + rows, mask=row_ok, other=0.0)[:, None]
    ls = tl.load(lse_s_ptr + rows, mask=row_ok, other=0.0)[:, None]
    g = tl.load(g_ptr + rows, mask=row_ok, other=0.0)[:, None]
    p = tl.exp(t - lt)
    q = tl.exp(s - ls)
    tl.store(ds_ptr + offs, (g * (q - p)).to(ds_ptr.dtype.element_ty),
             mask=mask)
    if WITH_DT:
        kl = tl.load(kl_ptr + rows, mask=row_ok, other=0.0)[:, None]
        dt = g * p * ((t - lt) - (s - ls) - kl)
        tl.store(dt_ptr + offs, dt.to(dt_ptr.dtype.element_ty), mask=mask)


def _kernels() -> dict:
    """JIT-wrap the kernel bodies on first use (imports triton)."""
    if not _jit:
        import triton
        import triton.language

        global tl
        tl = triton.language
        _jit["triton"] = triton
        _jit["fwd"] = triton.jit(_kl_fwd_kernel)
        _jit["bwd"] = triton.jit(_kl_bwd_kernel)
    return _jit


def _blocks(R: int, V: int) -> tuple[int, int]:
    """(BLOCK_R, BLOCK_V): vocab tiles of up to 1024 columns and about
    4096 elements a tile; powers of two, as ``tl.arange`` needs."""
    bv = min(1 << max(V - 1, 0).bit_length(), 1024)
    br = min(1 << max(R - 1, 0).bit_length(), max(1, 4096 // bv))
    return br, bv


def _check(t: torch.Tensor, s: torch.Tensor) -> None:
    if t.dim() != 2 or t.shape != s.shape:
        raise ValueError(f"distill_kl takes two (R, V) tensors of one "
                         f"shape, got {tuple(t.shape)} and {tuple(s.shape)}")
    if t.dtype != s.dtype or t.dtype not in _DTYPES:
        raise TypeError(f"distill_kl takes float32/bfloat16/float16 "
                        f"tensors of one dtype, got {t.dtype}, {s.dtype}")
    if t.device != s.device:
        raise ValueError(f"t on {t.device}, s on {s.device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"distill_kl runs on cpu or cuda, not {t.device}")
    if not (t.is_contiguous() and s.is_contiguous()):
        raise ValueError("distill_kl takes contiguous (R, V) tensors")


# ---------------------------------------------------------------- K1f --

def distill_kl_fwd_plain(t: torch.Tensor, s: torch.Tensor):
    """The forward's arithmetic in torch ops: (kl, lse_t, lse_s), float32."""
    t, s = t.float(), s.float()
    m_t = t.amax(dim=1, keepdim=True)
    p = torch.exp(t - m_t)
    z_t = p.sum(dim=1)
    acc = (p * (t - s)).sum(dim=1)
    m_s = s.amax(dim=1, keepdim=True)
    z_s = torch.exp(s - m_s).sum(dim=1)
    lse_t = m_t[:, 0] + torch.log(z_t)
    lse_s = m_s[:, 0] + torch.log(z_s)
    return acc / z_t - lse_t + lse_s, lse_t, lse_s


def distill_kl_fwd(t: torch.Tensor, s: torch.Tensor):
    """(R, V) × (R, V) -> (kl, lse_t, lse_s), each (R,) float32."""
    _check(t, s)
    if t.device.type == "cpu":
        return distill_kl_fwd_plain(t, s)
    k = _kernels()
    R, V = t.shape
    kl, lse_t, lse_s = (torch.empty(R, device=t.device, dtype=torch.float32)
                        for _ in range(3))
    br, bv = _blocks(R, V)
    k["fwd"][(k["triton"].cdiv(R, br),)](
        t, s, kl, lse_t, lse_s, R, V, BLOCK_R=br, BLOCK_V=bv, NEG=NEG_INF,
        num_warps=4)
    launches["distill_kl_fwd"] += 1
    return kl, lse_t, lse_s


# ---------------------------------------------------------------- K1b --

def distill_kl_bwd_plain(t, s, lse_t, lse_s, kl, g, *,
                         with_teacher_grad: bool = True):
    """The backward's arithmetic in torch ops: (dt or None, ds) in the
    input dtype."""
    tf, sf = t.float(), s.float()
    lt, ls, g = lse_t[:, None], lse_s[:, None], g[:, None]
    p = torch.exp(tf - lt)
    q = torch.exp(sf - ls)
    ds = (g * (q - p)).to(s.dtype)
    if not with_teacher_grad:
        return None, ds
    dt = g * p * ((tf - lt) - (sf - ls) - kl[:, None])
    return dt.to(t.dtype), ds


def distill_kl_bwd(t, s, lse_t, lse_s, kl, g, *,
                   with_teacher_grad: bool = True):
    """Gradients of the per-row KL under the per-row cotangent ``g``
    ((R,) float32) from the forward's statistics: (dt or None, ds).
    ``with_teacher_grad=False`` skips the dL/dt stream."""
    _check(t, s)
    R, V = t.shape
    for name, v in (("lse_t", lse_t), ("lse_s", lse_s), ("kl", kl),
                    ("g", g)):
        if v.shape != (R,) or v.dtype != torch.float32 \
                or v.device != t.device or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({R},) float32 "
                             f"tensor on {t.device}")
    if t.device.type == "cpu":
        return distill_kl_bwd_plain(t, s, lse_t, lse_s, kl, g,
                                    with_teacher_grad=with_teacher_grad)
    k = _kernels()
    ds = torch.empty_like(s)
    dt = torch.empty_like(t) if with_teacher_grad else None
    br, bv = _blocks(R, V)
    grid = (k["triton"].cdiv(R, br), k["triton"].cdiv(V, bv))
    k["bwd"][grid](
        t, s, lse_t, lse_s, kl, g, ds if dt is None else dt, ds, R, V,
        BLOCK_R=br, BLOCK_V=bv, WITH_DT=with_teacher_grad, NEG=NEG_INF,
        num_warps=4)
    launches["distill_kl_bwd"] += 1
    return dt, ds


class DistillKL(torch.autograd.Function):
    """Per-row KL(softmax(t) ‖ softmax(s)) with the K1 backward.

    The forward saves only t, s and the per-row lse_t, lse_s and kl; the
    backward re-reads the logits. ``with_teacher_grad=False`` declares
    the teacher constant: no dL/dt is computed and its gradient is None.
    """

    @staticmethod
    def forward(ctx, t, s, with_teacher_grad: bool = True):
        kl, lse_t, lse_s = distill_kl_fwd(t, s)
        ctx.save_for_backward(t, s, lse_t, lse_s, kl)
        ctx.with_teacher_grad = with_teacher_grad
        return kl

    @staticmethod
    def backward(ctx, g):
        t, s, lse_t, lse_s, kl = ctx.saved_tensors
        dt, ds = distill_kl_bwd(t, s, lse_t, lse_s, kl,
                                g.float().contiguous(),
                                with_teacher_grad=ctx.with_teacher_grad)
        return dt, ds, None
