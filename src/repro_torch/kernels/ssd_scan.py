"""K3 on Hopper: the Mamba-2 SSD chunked scan, forward and backward, in
CUDA C++.

Replaces the Pallas kernels of ``repro/kernels/ssd_scan.py``:

  * K3f, ``ssd_scan`` (``_ssd_kernel``): within each chunk of ``cl``
    positions a masked (cl, cl) product, across chunks the (P, N) state
    carried in float32; it returns y, the final state and, on request, the
    state entering each chunk (B, H, nc, P, N), the backward's only
    residual;
  * K3b, ``ssd_scan_bwd`` (``_ssd_bwd_kernel``): the chunks walked
    last-first carrying dS, each chunk's quantities recomputed from the
    inputs; dx, ddt, per-head db and dc, per-(b, h) partials of da and
    d(initial_state), float32. db and dc are reduced over each group and
    da over the batch outside the kernel, as in the reference
    (``ssd_scan.py:315-317``).

Why CUDA C++ and not Triton: the work is a chunked recurrence with matrix
products in it, neither an elementwise pass nor a reduction. The source,
``csrc/ssd_scan.cu``, says how it is laid out (one CTA per (b, h) looping
over the chunks, the intra-chunk products tiled over the tiles on or
below the diagonal) and what bounds it: the operations, ~cl²(N + P)/2 +
2·cl·P·N multiply-adds a chunk and head forward, computed in this first
version on the CUDA cores in float32.

Layout, as the reference's: x (B, S, H, P), dt (B, S, H), a (H,), b and c
(B, S, G, N), initial_state (B, H, P, N); head h reads group h·G // H.
Any S: the ragged tail of the last chunk is masked inside the kernel (dt,
x, b, c and dy read as zeros past S), so it deposits nothing in the state.

Beside each kernel, its plain version: the forward is the chunked formula
in PyTorch with the same tail masking (``ssd_scan_fwd_plain``), the
backward torch autograd through it (``ssd_scan_bwd_plain``). Each wrapper
checks its inputs, then on a CPU tensor runs the plain version, and on a
CUDA tensor launches the kernel, built with ``nvcc`` at first use
(``kernels/cuda_build.py``), on the current stream, or raises.
``launches`` counts kernel launches. ``SSDScan`` is the pair behind one
``torch.autograd.Function`` (the reference's ``ssd_scan_vjp``).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_build

launches = {"ssd_scan_fwd": 0, "ssd_scan_bwd": 0}

# torch dtype -> the C interface's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS, _FT, _BT = 256, 64, 32        # csrc/ssd_scan.cu's constants
SMEM_LIMIT = 232_448                    # bytes a block may opt in to
_fn: dict = {}


def _launchers() -> dict:
    if not _fn:
        lib = cuda_build.load("ssd_scan")
        ints = [ctypes.c_int] * 7
        for name, n_ptrs in (("fwd", 9), ("bwd", 14)):
            fn = getattr(lib, f"ssd_scan_{name}_launch")
            fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * n_ptrs
                           + ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fn[name] = fn
        err = lib.ssd_scan_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn["error"] = err
    return _fn


def smem_bytes(which: str, P: int, N: int, cl: int) -> int:
    """Dynamic shared memory of one K3f (``"fwd"``) or K3b (``"bwd"``)
    CTA, as ``csrc/ssd_scan.cu`` sizes it."""
    if which == "fwd":
        floats = (P * (N + 1) + 2 * _FT * (N + 1) + _FT * (P + 1)
                  + _FT * (_FT + 1) + _FT * P + 2 * cl)
    else:
        floats = (2 * P * (N + 1) + 2 * _BT * (N + 1) + 2 * _BT * (P + 1)
                  + 3 * _BT * (_BT + 1) + _THREADS + 8 * cl)
    return 4 * floats


def _check(x, dt, a, b, c) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 4 \
            or b.shape != c.shape:
        raise ValueError(
            f"ssd_scan takes x (B, S, H, P), dt (B, S, H), a (H,) and b, c "
            f"(B, S, G, N) of one shape; got {tuple(x.shape)}, "
            f"{tuple(dt.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, "
            f"{tuple(c.shape)}")
    B, S, H, _ = x.shape
    G = b.shape[2]
    if tuple(dt.shape) != (B, S, H) or tuple(a.shape) != (H,) \
            or tuple(b.shape[:2]) != (B, S) or G == 0 or H % G:
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)} and b {tuple(b.shape)} do not "
                         "agree (H must be a multiple of G)")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c must share one of float32, bfloat16, "
                        f"float16; got {x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"dt must be float32 or x's dtype, not {dt.dtype}")
    if any(t.device != x.device for t in (dt, a, b, c)):
        raise ValueError("ssd_scan's tensors lie on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")


def _check_state(t, shape, name, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name} must be {tuple(shape)} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")


def _check_cuda(which: str, P: int, N: int, cl: int) -> None:
    need = smem_bytes(which, P, N, cl)
    if need > SMEM_LIMIT:
        raise ValueError(f"K3{which[0]} at P={P}, N={N}, chunk {cl} needs "
                         f"{need} bytes of shared memory, more than the "
                         f"{SMEM_LIMIT} a block can have")


def _raise_on(err: int, which: str) -> None:
    if err:
        raise RuntimeError(f"the K3 {which} launch failed: CUDA error {err} "
                           f"({_launchers()['error'](err).decode()})")


def _chunk(chunk: int, S: int) -> int:
    cl = min(int(chunk), int(S))
    if cl <= 0:
        raise ValueError(f"ssd_scan needs chunk >= 1 and S >= 1, got chunk "
                         f"{chunk}, S {S}")
    return cl


# ----------------------------------------------------------------- K3f --

def ssd_scan_fwd_plain(x, dt, a, b, c, initial_state=None, *, chunk: int):
    """The forward's arithmetic in PyTorch, chunk by chunk: (y in x's
    dtype, final_state, chunk_states (B, H, nc, P, N)), the states
    float32. The tail past S is zeroed in dt, x, b and c, as the kernel
    masks it; the exponential is taken only under the causal mask, so
    autograd through it sees no inf."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    cl = _chunk(chunk, S)
    nc = -(-S // cl)
    pad = nc * cl - S
    rep = H // G
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nc, cl, H, P)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(B, nc, cl, H)
    bf, cf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nc, cl, G, N)
              .repeat_interleave(rep, dim=3) for t in (b, c))
    cs = torch.cumsum(dtf * a.float(), dim=2)             # (B, nc, cl, H)
    csh = cs.permute(0, 1, 3, 2)                          # (B, nc, H, cl)
    tril = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    seg = (csh[..., :, None] - csh[..., None, :]).masked_fill(
        ~tril, float("-inf"))
    decay = torch.exp(seg)                                # (B, nc, H, l, s)
    cb = torch.einsum("bclhn,bcshn->bchls", cf, bf)
    att = cb * decay * dtf.permute(0, 1, 3, 2)[..., None, :]
    y = torch.einsum("bchls,bcshp->bclhp", att, xf)
    w = dtf * torch.exp(cs[:, :, -1:] - cs)               # (B, nc, cl, H)
    deposit = torch.einsum("bclh,bclhp,bclhn->bchpn", w, xf, bf)
    s = torch.zeros((B, H, P, N), device=x.device) if initial_state is None \
        else initial_state.float()
    entering = []
    for ci in range(nc):
        entering.append(s)
        s = torch.exp(cs[:, ci, -1])[..., None, None] * s + deposit[:, ci]
    states = torch.stack(entering, dim=2)                 # (B, H, nc, P, N)
    y = y + torch.exp(cs)[..., None] * torch.einsum(
        "bclhn,bhcpn->bclhp", cf, states)
    y = y.reshape(B, nc * cl, H, P)[:, :S]
    return y.to(x.dtype), s, states


def ssd_scan_fwd(x, dt, a, b, c, initial_state=None, *, chunk: int,
                 return_chunk_states: bool = False):
    """SSD forward. Returns (y (B, S, H, P) in x's dtype, final_state
    (B, H, P, N) float32), and the chunk states (B, H, nc, P, N) when
    ``return_chunk_states``. ``chunk`` is clamped into S."""
    _check(x, dt, a, b, c)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if initial_state is not None:
        _check_state(initial_state, (B, H, P, N), "initial_state", x.device)
    if x.device.type == "cpu":
        y, final, states = ssd_scan_fwd_plain(x, dt, a, b, c, initial_state,
                                              chunk=chunk)
        return (y, final, states) if return_chunk_states else (y, final)
    cl = _chunk(chunk, S)
    nc = -(-S // cl)
    _check_cuda("fwd", P, N, cl)
    x, dt, b, c = (t.contiguous() for t in (x, dt, b, c))
    a = a.float().contiguous()
    init = torch.zeros((B, H, P, N), device=x.device) \
        if initial_state is None else initial_state.float().contiguous()
    y = torch.empty_like(x)
    final = torch.empty((B, H, P, N), device=x.device)
    states = torch.empty((B, H, nc, P, N), device=x.device) \
        if return_chunk_states else None
    with torch.cuda.device(x.device):
        err = _launchers()["fwd"](
            _DTYPES[x.dtype], _DTYPES[dt.dtype], x.data_ptr(), dt.data_ptr(),
            a.data_ptr(), b.data_ptr(), c.data_ptr(), init.data_ptr(),
            y.data_ptr(), final.data_ptr(),
            None if states is None else states.data_ptr(),
            B, S, H, P, G, N, cl,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "forward (K3f)")
    launches["ssd_scan_fwd"] += 1
    return (y, final, states) if return_chunk_states else (y, final)


# ----------------------------------------------------------------- K3b --

def ssd_scan_bwd_plain(x, dt, a, b, c, chunk_states, dy, dfinal, *,
                       chunk: int):
    """The backward by torch autograd through ``ssd_scan_fwd_plain`` from
    the state entering the first chunk: (dx, ddt, da, db, dc,
    dinitial_state), float32."""
    leaves = [t.detach().float().requires_grad_(True)
              for t in (x, dt, a, b, c, chunk_states[:, :, 0])]
    with torch.enable_grad():
        y, final, _ = ssd_scan_fwd_plain(*leaves[:5], leaves[5], chunk=chunk)
        return torch.autograd.grad((y, final), leaves,
                                   (dy.float(), dfinal.float()))


def ssd_scan_bwd(x, dt, a, b, c, chunk_states, dy, dfinal, *, chunk: int):
    """Gradients of the scan under the cotangents (dy (B, S, H, P), dfinal
    (B, H, P, N)) from the forward's chunk states: (dx, ddt, da, db, dc,
    dinitial_state), float32, db and dc per group and da summed over the
    batch, as the reference's ``ssd_scan_bwd`` returns them."""
    _check(x, dt, a, b, c)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    cl = _chunk(chunk, S)
    nc = -(-S // cl)
    _check_state(chunk_states, (B, H, nc, P, N), "chunk_states", x.device)
    _check_state(dy, (B, S, H, P), "dy", x.device)
    _check_state(dfinal, (B, H, P, N), "dfinal", x.device)
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, a, b, c, chunk_states, dy, dfinal,
                                  chunk=chunk)
    _check_cuda("bwd", P, N, cl)
    x, dt, b, c = (t.contiguous() for t in (x, dt, b, c))
    a = a.float().contiguous()
    states = chunk_states.float().contiguous()
    dyf, dfin = dy.float().contiguous(), dfinal.float().contiguous()
    dev = x.device
    dx = torch.empty((B, S, H, P), device=dev)
    ddt = torch.empty((B, S, H), device=dev)
    dbh = torch.empty((B, S, H, N), device=dev)
    dch = torch.empty((B, S, H, N), device=dev)
    dap = torch.empty((B, H), device=dev)
    dinit = torch.empty((B, H, P, N), device=dev)
    with torch.cuda.device(dev):
        err = _launchers()["bwd"](
            _DTYPES[x.dtype], _DTYPES[dt.dtype], x.data_ptr(), dt.data_ptr(),
            a.data_ptr(), b.data_ptr(), c.data_ptr(), states.data_ptr(),
            dyf.data_ptr(), dfin.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dbh.data_ptr(), dch.data_ptr(), dap.data_ptr(), dinit.data_ptr(),
            B, S, H, P, G, N, cl,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "backward (K3b)")
    launches["ssd_scan_bwd"] += 1
    rep = H // G
    db = dbh.reshape(B, S, G, rep, N).sum(dim=3)          # group-reduce
    dc = dch.reshape(B, S, G, rep, N).sum(dim=3)
    return dx, ddt, dap.sum(dim=0), db, dc, dinit


class SSDScan(torch.autograd.Function):
    """The scan with the K3b backward (the reference's ``ssd_scan_vjp``):
    ``SSDScan.apply(x, dt, a, b, c, initial_state, chunk) -> (y,
    final_state)``, initial_state a (B, H, P, N) tensor (zeros where the
    caller has none). Saves the inputs and the per-chunk states only
    (none when no input needs a gradient); the backward re-streams the
    chunks in reverse. Gradients come back in the inputs' dtypes,
    d(initial_state) in float32."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, initial_state, chunk: int):
        train = any(ctx.needs_input_grad[:6])
        out = ssd_scan_fwd(x, dt, a, b, c, initial_state, chunk=chunk,
                           return_chunk_states=train)
        if train:
            ctx.save_for_backward(x, dt, a, b, c, out[2])
        ctx.chunk = chunk
        ctx.dtypes = (x.dtype, dt.dtype, a.dtype, b.dtype, c.dtype)
        return out[0], out[1]

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, b, c, states = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, a, b, c, states, dy, dfinal,
                             chunk=ctx.chunk)
        return (*(g.to(t) for g, t in zip(grads[:5], ctx.dtypes)), grads[5],
                None)
