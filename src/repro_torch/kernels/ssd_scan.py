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
    inputs; dx, ddt, per-head db and dc, partials of da (per (b, h), or
    per (b, h, chunk) on the sm90 route) and d(initial_state), float32. db
    and dc are reduced over each group and the da partials summed outside
    the kernels, as in the reference (``ssd_scan.py:315-317``).

Why CUDA C++ and not Triton: the work is a chunked recurrence with matrix
products in it, neither an elementwise pass nor a reduction. K3f and K3b
each have two routes, chosen from the widths alone, one rule for every
dtype (``fwd_route``, ``bwd_route``): ``sm90``, at P 64 and N 64 or 128
(mamba2-130m's and zamba2-7b's widths), the chunk-parallel kernels of
``csrc/ssd_scan_sm90.cu`` (K3f: chunk states, a pass over them, the chunk
scan, three launches; K3b: the dS deposits, a reverse pass over them, the
column and row kernels of the chunk gradients and their finish, five
launches; in bfloat16 and float16 every product on wgmma, in float32 on
the CUDA cores, exact); ``simt``, every other P or N, the first versions
in ``csrc/ssd_scan.cu`` (one CTA per (b, h) looping over the chunks on
the CUDA cores), which a direct call may also name to time them.
``fwd_routes`` and ``bwd_routes`` count the calls of each. Each source
says what bounds it.

Layout, as the reference's: x (B, S, H, P), dt (B, S, H), a (H,), b and c
(B, S, G, N), initial_state (B, H, P, N); head h reads group h·G // H.
Any S: the ragged tail of the last chunk is masked inside the kernel (dt,
x, b, c and dy read as zeros past S), so it deposits nothing in the state.

Beside each kernel, its plain version: the forward is the chunked formula
in PyTorch with the same tail masking, in the sm90 route's three phases
(``ssd_scan_fwd_plain``; with that route's 16-bit roundings when the
tests ask), the backward torch autograd through it
(``ssd_scan_bwd_plain``, the float32 oracle) and the sm90 route's phases
written out (``ssd_scan_bwd_chunked_plain``, with its roundings when the
tests ask). Each wrapper checks its inputs, then on a CPU tensor runs the
plain version, and on a CUDA tensor launches the kernels, built with
``nvcc`` at first use (``kernels/cuda_build.py``), on the current stream,
or raises. ``launches`` counts calls that launch. ``SSDScan`` is the pair
behind one ``torch.autograd.Function`` (the reference's
``ssd_scan_vjp``).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_build

launches = {"ssd_scan_fwd": 0, "ssd_scan_bwd": 0}
# K3f's launches by route (each also counts in launches["ssd_scan_fwd"];
# an sm90 call's three kernels count once)
fwd_routes = {"sm90": 0, "simt": 0}
# K3b's by route (each also counts in launches["ssd_scan_bwd"]; an sm90
# call's five kernels count once)
bwd_routes = {"sm90": 0, "simt": 0}

# torch dtype -> the C interface's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS, _FT, _BT = 256, 64, 32        # csrc/ssd_scan.cu's constants
_TILE = 64 * 128                        # csrc/ssd_scan_sm90.cu's tile bytes
SM90_P, SM90_N = 64, (64, 128)
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
        sm90 = cuda_build.load("ssd_scan_sm90")
        for name, n_int, n_ptrs in (("fwd", 2, 11), ("bwd", 3, 14)):
            fn = getattr(sm90, f"ssd_scan_{name}_sm90_launch")
            fn.argtypes = ([ctypes.c_int] * n_int + [ctypes.c_void_p] * n_ptrs
                           + ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fn[f"{name}_sm90"] = fn
        err = lib.ssd_scan_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fn["error"] = err
    return _fn


def smem_bytes(which: str, P: int, N: int, cl: int, route: str = "simt",
               dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one K3f (``"fwd"``) or K3b (``"bwd"``)
    CTA, as ``csrc/ssd_scan.cu`` sizes it, or on the ``"sm90"`` route
    the largest of the route's CTAs (``csrc/ssd_scan_sm90.cu``) in
    ``dtype`` (16 bits, or float32's kernels): K3f's chunk-state and
    chunk-scan kernels, K3b's deposit kernel (the chunk-state kernel's
    size) and its column and row kernels."""
    cl_pad = -(-cl // 64) * 64
    if route == "sm90" and dtype == torch.float32:
        # floats: a 64-row slot of N- and P-wide rows at stride width + 4,
        # a 64 x 80 score tile, the chunk's vectors
        slot, score = 64 * (N + 4 + P + 4), 64 * 80
        rest = (64 * (N + 4) + slot if which == "fwd" else 3 * slot)
        return 4 * max(2 * slot + 3 * cl_pad, rest + score + 2 * cl_pad)
    if route == "sm90":
        nh = N // 64
        tiles = 4 * nh + (2 if which == "fwd" else 3)
        return max(1024 + (2 + nh) * _TILE + 3 * 4 * cl,
                   1024 + tiles * _TILE + 2 * 4 * cl_pad)
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


def _check_cuda(which: str, P: int, N: int, cl: int, route: str = "simt",
                dtype=torch.bfloat16) -> None:
    need = smem_bytes(which, P, N, cl, route, dtype)
    if need > SMEM_LIMIT:
        raise ValueError(f"K3{which[0]} ({route}) at P={P}, N={N}, chunk "
                         f"{cl} needs {need} bytes of shared memory, more "
                         f"than the {SMEM_LIMIT} a block can have")


def _check_aligned(*tensors) -> None:
    """The sm90 routes move 16 bytes at a time: their tensors' bases must
    be 16-byte aligned, or the call is refused before a launch."""
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError("K3's sm90 route loads 16 bytes at a time, which "
                         "needs 16-byte aligned tensors")


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

def _chunked(x, dt, a, b, c, chunk: int):
    """The plain versions' operands by chunk, float32, zero past S: (cl,
    nc, x (B, nc, cl, H, P), dt (B, nc, cl, H), b and c (B, nc, cl, H, N)
    with each head's group, cs (B, nc, cl, H) the within-chunk cumsum of
    dt a)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    cl = _chunk(chunk, S)
    nc = -(-S // cl)
    pad = nc * cl - S
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nc, cl, H, P)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(B, nc, cl, H)
    bf, cf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nc, cl, G, N)
              .repeat_interleave(H // G, dim=3) for t in (b, c))
    return cl, nc, xf, dtf, bf, cf, torch.cumsum(dtf * a.float(), dim=2)


def ssd_scan_fwd_plain(x, dt, a, b, c, initial_state=None, *, chunk: int,
                       emulate=None):
    """The forward's arithmetic in PyTorch, chunk by chunk, in the sm90
    route's three phases: (A) each chunk's cs, decay e^{cs_end} and
    deposit X^T (w . B), w_l = dt_l e^{cs_end - cs_l}; (B) the pass over
    the chunks, S_in[c] = S, S = decay_c S + deposit_c; (C) each chunk's y
    from the masked (C B^T) e^{cs_l - cs_s} dt_s against X and
    e^{cs_l} C S_in^T. Returns (y in x's dtype, final_state,
    chunk_states (B, H, nc, P, N)), the states float32. The tail past S
    is zeroed in dt, x, b and c, as the kernels mask it; the exponential
    is taken only under the causal mask, so autograd through it sees no
    inf. ``emulate`` (bfloat16 or float16) takes the sm90 kernels'
    rounding points in that dtype: w . X split into hi = rn(w x) and
    lo = rn(w x - hi), each against B; att and S_in rounded before their
    products. The tests use it; no main path does."""
    B, S, H, P = x.shape
    N = b.shape[3]
    r16 = (lambda t: t) if emulate is None \
        else (lambda t: t.to(emulate).float())
    cl, nc, xf, dtf, bf, cf, cs = _chunked(x, dt, a, b, c, chunk)
    # A: chunk states
    decay = torch.exp(cs[:, :, -1])                       # (B, nc, H)
    xw = xf * (dtf * torch.exp(cs[:, :, -1:] - cs))[..., None]
    hi = r16(xw)
    deposit = torch.einsum("bclhp,bclhn->bchpn", hi, bf)
    if emulate is not None:
        deposit = deposit + torch.einsum("bclhp,bclhn->bchpn", r16(xw - hi),
                                         bf)
    # B: the pass over the chunks
    s = torch.zeros((B, H, P, N), device=x.device) if initial_state is None \
        else initial_state.float()
    entering = []
    for ci in range(nc):
        entering.append(s)
        s = decay[:, ci][..., None, None] * s + deposit[:, ci]
    states = torch.stack(entering, dim=2)                 # (B, H, nc, P, N)
    # C: the chunk scan
    csh = cs.permute(0, 1, 3, 2)                          # (B, nc, H, cl)
    tril = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    seg = (csh[..., :, None] - csh[..., None, :]).masked_fill(
        ~tril, float("-inf"))
    att = r16(torch.einsum("bclhn,bcshn->bchls", cf, bf) * torch.exp(seg)
              * dtf.permute(0, 1, 3, 2)[..., None, :])
    y = torch.einsum("bchls,bcshp->bclhp", att, xf) \
        + torch.exp(cs)[..., None] * torch.einsum("bclhn,bhcpn->bclhp", cf,
                                                  r16(states))
    y = y.reshape(B, nc * cl, H, P)[:, :S]
    return y.to(x.dtype), s, states


def fwd_route(dtype, P: int, N: int) -> str:
    """K3f's kernels for a CUDA call, by one rule for float32, bfloat16
    and float16: ``"sm90"`` (the chunk-parallel kernels) at P 64 and N 64
    or 128, ``"simt"`` (the first version) at every other width."""
    return "sm90" if dtype in _DTYPES and P == SM90_P and N in SM90_N \
        else "simt"


def ssd_scan_fwd(x, dt, a, b, c, initial_state=None, *, chunk: int,
                 return_chunk_states: bool = False, route=None):
    """SSD forward. Returns (y (B, S, H, P) in x's dtype, final_state
    (B, H, P, N) float32), and the chunk states (B, H, nc, P, N) when
    ``return_chunk_states``. ``chunk`` is clamped into S. On a CUDA
    tensor ``route`` None takes ``fwd_route``'s kernel; a measurement may
    name ``"simt"`` to time the first version where sm90 is the route. A
    named route is a kernel's: on the CPU it raises."""
    _check(x, dt, a, b, c)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if initial_state is not None:
        _check_state(initial_state, (B, H, P, N), "initial_state", x.device)
    if x.device.type == "cpu":
        if route is not None:
            raise ValueError(f"route {route!r} names a CUDA kernel; on the "
                             "CPU ssd_scan_fwd runs the plain version")
        y, final, states = ssd_scan_fwd_plain(x, dt, a, b, c, initial_state,
                                              chunk=chunk)
        return (y, final, states) if return_chunk_states else (y, final)
    own = fwd_route(x.dtype, P, N)
    route = own if route is None else route
    if route not in ("sm90", "simt") or (route == "sm90" and own != "sm90"):
        raise ValueError(f"K3f has no route {route!r} for {x.dtype} at "
                         f"P={P}, N={N} (sm90 takes P {SM90_P}, N "
                         f"{SM90_N})")
    cl = _chunk(chunk, S)
    nc = -(-S // cl)
    _check_cuda("fwd", P, N, cl, route, x.dtype)
    x, dt, b, c = (t.contiguous() for t in (x, dt, b, c))
    a = a.float().contiguous()
    dev = x.device
    y = torch.empty_like(x)
    final = torch.empty((B, H, P, N), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "sm90":
        init = None if initial_state is None \
            else initial_state.float().contiguous()
        _check_aligned(x, b, c, init)
        # one scratch a call, sized by shapes alone: the chunk states when
        # the caller keeps none, cs (B, H, nc, cl), the decays (B, H, nc)
        n_st = 0 if return_chunk_states else B * H * nc * P * N
        n_cs = B * H * nc * cl
        scratch = torch.empty(n_st + n_cs + B * H * nc, device=dev)
        states = torch.empty((B, H, nc, P, N), device=dev) \
            if return_chunk_states else scratch[:n_st].view(B, H, nc, P, N)
        with torch.cuda.device(dev):
            err = _launchers()["fwd_sm90"](
                _DTYPES[x.dtype], _DTYPES[dt.dtype], x.data_ptr(),
                dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                None if init is None else init.data_ptr(), y.data_ptr(),
                final.data_ptr(), states.data_ptr(),
                scratch[n_st:].data_ptr(), scratch[n_st + n_cs:].data_ptr(),
                B, S, H, P, G, N, cl, stream)
    else:
        init = torch.zeros((B, H, P, N), device=dev) \
            if initial_state is None else initial_state.float().contiguous()
        states = torch.empty((B, H, nc, P, N), device=dev) \
            if return_chunk_states else None
        with torch.cuda.device(dev):
            err = _launchers()["fwd"](
                _DTYPES[x.dtype], _DTYPES[dt.dtype], x.data_ptr(),
                dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                init.data_ptr(), y.data_ptr(), final.data_ptr(),
                None if states is None else states.data_ptr(),
                B, S, H, P, G, N, cl, stream)
    _raise_on(err, f"forward (K3f, {route})")
    launches["ssd_scan_fwd"] += 1
    fwd_routes[route] += 1
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


def ssd_scan_bwd_chunked_plain(x, dt, a, b, c, chunk_states, dy, dfinal, *,
                               chunk: int, emulate=None):
    """The backward's arithmetic in PyTorch, in the sm90 route's phases,
    explicit formulas and no autograd. Per chunk, with cs the cumsum of
    dt a, ecs = e^{cs}, w_l = dt_l e^{cs_end - cs_l}, S_in the forward's
    entering state and dS_out the cotangent of the state leaving the
    chunk: (A') each chunk's deposit D_c = (ecs . dY)^T C; (B') the
    chunks last-first, dS_out[nc-1] = dfinal, dS_out[c-1] = e^{cs_end,c}
    dS_out[c] + D_c, d(initial_state) = e^{cs_end,0} dS_out[0] + D_0;
    (C') the chunk gradients: the column terms dx = att^T dY + w . (B
    dS_out^T), db = dcb^T C + w . (X dS_out), the column sums of
    datt CB decay (ddt_att) and dw = sum_n (X dS_out) . b; the row terms
    dc = dcb B + ecs . (dY S_in), the row sums of dseg and sum_p dY . y_off;
    then the finish: dcs, its reverse cumsum dda, ddt = ddt_att + dw
    e^{cs_end - cs} + dda a and da = sum dda dt. Returns (dx, ddt, da, db,
    dc, dinitial_state) as ``ssd_scan_bwd`` does. ``emulate`` (bfloat16
    or float16) takes the sm90 kernels' rounding points: a float32 dy
    rounded once, ecs . dY split into hi + lo for the deposit, S_in,
    dS_out, att and dcb rounded before their products. The tests and
    chip_smoke.py use it; no main path does."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    r16 = (lambda t: t) if emulate is None \
        else (lambda t: t.to(emulate).float())
    cl, nc, xf, dtf, bf, cf, cs = _chunked(x, dt, a, b, c, chunk)
    pad = nc * cl - S
    dyf = r16(F.pad(dy.float(), (0, 0, 0, 0, 0, pad))).reshape(
        B, nc, cl, H, P)
    cs_end = cs[:, :, -1]                                 # (B, nc, H)
    decay, ecs = torch.exp(cs_end), torch.exp(cs)
    e_end = torch.exp(cs_end[:, :, None] - cs)            # (B, nc, cl, H)
    w = dtf * e_end
    # A': the deposits
    ed = dyf * ecs[..., None]
    hi = r16(ed)
    dep = torch.einsum("bclhp,bclhn->bchpn", hi, cf)
    if emulate is not None:
        dep = dep + torch.einsum("bclhp,bclhn->bchpn", r16(ed - hi), cf)
    # B': the chunks last-first
    g = dfinal.float()
    ds_out = [None] * nc
    for ci in reversed(range(nc)):
        ds_out[ci] = g
        g = decay[:, ci][..., None, None] * g + dep[:, ci]
    dso = torch.stack(ds_out, dim=1)                      # (B, nc, H, P, N)
    s_in = chunk_states.float().transpose(1, 2)           # (B, nc, H, P, N)
    # C': the intra-chunk terms
    csh = cs.permute(0, 1, 3, 2)                          # (B, nc, H, cl)
    tril = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    dec = torch.exp((csh[..., :, None] - csh[..., None, :]).masked_fill(
        ~tril, float("-inf")))                            # (.., l, s)
    dts = dtf.permute(0, 1, 3, 2)[..., None, :]           # dt_s
    cb = torch.einsum("bclhn,bcshn->bchls", cf, bf)
    datt = torch.einsum("bclhp,bcshp->bchls", dyf, xf)
    q = datt * cb * dec
    ddt_att = q.sum(dim=-2).permute(0, 1, 3, 2)           # column sums
    rows = (q * dts).sum(dim=-1).permute(0, 1, 3, 2)      # dseg row sums
    att, dcb = r16(cb * dec * dts), r16(datt * dec * dts)
    dx = torch.einsum("bchls,bclhp->bcshp", att, dyf)
    db = torch.einsum("bchls,bclhn->bcshn", dcb, cf)
    dc = torch.einsum("bchls,bcshn->bclhn", dcb, bf)
    # the y_off terms and the state-update terms
    si, ds16 = r16(s_in), r16(dso)
    y_off = ecs[..., None] * torch.einsum("bclhn,bchpn->bclhp", cf, si)
    dc = dc + ecs[..., None] * torch.einsum("bclhp,bchpn->bclhn", dyf, si)
    dsx = torch.einsum("bclhp,bchpn->bclhn", xf, ds16)
    dx = dx + w[..., None] * torch.einsum("bclhn,bchpn->bclhp", bf, ds16)
    db = db + w[..., None] * dsx
    dw = (dsx * bf).sum(dim=-1)                           # (B, nc, cl, H)
    # the finish
    dcs = rows - ddt_att * dtf + (dyf * y_off).sum(dim=-1) - dw * w
    dcs_end = (dw * w).sum(dim=2) + decay * (dso * s_in).sum(dim=(-2, -1))
    dcs = torch.cat([dcs[:, :, :-1], dcs[:, :, -1:] + dcs_end[:, :, None]],
                    dim=2)
    dda = torch.flip(torch.cumsum(torch.flip(dcs, (2,)), dim=2), (2,))
    ddt = ddt_att + dw * e_end + dda * a.float()
    da = (dda * dtf).sum(dim=(0, 1, 2))
    cut = lambda t: t.reshape(B, nc * cl, *t.shape[3:])[:, :S]
    rep = H // G
    db, dc = (cut(t).reshape(B, S, G, rep, N).sum(dim=3) for t in (db, dc))
    return cut(dx), cut(ddt), da, db, dc, g


def bwd_route(dtype, P: int, N: int) -> str:
    """K3b's kernels for a CUDA call, by ``fwd_route``'s rule: ``"sm90"``
    (the chunk-parallel kernels) at P 64 and N 64 or 128 in every dtype,
    ``"simt"`` (the first version) at every other width."""
    return fwd_route(dtype, P, N)


def ssd_scan_bwd(x, dt, a, b, c, chunk_states, dy, dfinal, *, chunk: int,
                 route=None):
    """Gradients of the scan under the cotangents (dy (B, S, H, P) in
    float32 or x's dtype, dfinal (B, H, P, N)) from the forward's chunk
    states: (dx, ddt, da, db, dc, dinitial_state), float32, db and dc per
    group and da summed over the batch, as the reference's
    ``ssd_scan_bwd`` returns them. On a CUDA tensor ``route`` None takes
    ``bwd_route``'s kernels; a measurement may name ``"simt"`` to time
    the first version where sm90 is the route. A named route is a
    kernel's: on the CPU it raises."""
    _check(x, dt, a, b, c)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    cl = _chunk(chunk, S)
    nc = -(-S // cl)
    _check_state(chunk_states, (B, H, nc, P, N), "chunk_states", x.device)
    _check_state(dy, (B, S, H, P), "dy", x.device)
    _check_state(dfinal, (B, H, P, N), "dfinal", x.device)
    if x.device.type == "cpu":
        if route is not None:
            raise ValueError(f"route {route!r} names a CUDA kernel; on the "
                             "CPU ssd_scan_bwd runs the plain version")
        return ssd_scan_bwd_plain(x, dt, a, b, c, chunk_states, dy, dfinal,
                                  chunk=chunk)
    own = bwd_route(x.dtype, P, N)
    route = own if route is None else route
    if route not in ("sm90", "simt") or (route == "sm90" and own != "sm90"):
        raise ValueError(f"K3b has no route {route!r} for {x.dtype} at "
                         f"P={P}, N={N} (sm90 takes P {SM90_P}, N "
                         f"{SM90_N})")
    _check_cuda("bwd", P, N, cl, route, x.dtype)
    x, dt, b, c, dy = (t.contiguous() for t in (x, dt, b, c, dy))
    a = a.float().contiguous()
    states = chunk_states.float().contiguous()
    dfin = dfinal.float().contiguous()
    dev = x.device
    dx = torch.empty((B, S, H, P), device=dev)
    ddt = torch.empty((B, S, H), device=dev)
    dbh = torch.empty((B, S, H, N), device=dev)
    dch = torch.empty((B, S, H, N), device=dev)
    dinit = torch.empty((B, H, P, N), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "sm90":
        if dy.dtype not in (torch.float32, x.dtype):
            raise TypeError(f"K3b's sm90 route reads dy in float32 or x's "
                            f"dtype, not {dy.dtype}")
        _check_aligned(x, b, c, dy)
        # one scratch a call, sized by shapes alone: the dS buffer (B, H,
        # nc, P, N), then cs, dt, and C''s per-position vectors ddt_att,
        # dw and the row terms (B, H, nc, cl) each, then the decays and
        # the da partials (B, H, nc) each
        n_ds, n_v, n_c = B * H * nc * P * N, B * H * nc * cl, B * H * nc
        scratch = torch.empty(n_ds + 5 * n_v + 2 * n_c, device=dev)
        dap = scratch[n_ds + 5 * n_v + n_c:].view(B, H, nc)
        with torch.cuda.device(dev):
            err = _launchers()["bwd_sm90"](
                _DTYPES[x.dtype], _DTYPES[dt.dtype], _DTYPES[dy.dtype],
                x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), states.data_ptr(), dy.data_ptr(),
                dfin.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
                dbh.data_ptr(), dch.data_ptr(), dinit.data_ptr(),
                scratch.data_ptr(), B, S, H, P, G, N, cl, stream)
        da = dap.sum(dim=(0, 2))
    else:
        dyf = dy.float()
        dap = torch.empty((B, H), device=dev)
        with torch.cuda.device(dev):
            err = _launchers()["bwd"](
                _DTYPES[x.dtype], _DTYPES[dt.dtype], x.data_ptr(),
                dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                states.data_ptr(), dyf.data_ptr(), dfin.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), dbh.data_ptr(),
                dch.data_ptr(), dap.data_ptr(), dinit.data_ptr(),
                B, S, H, P, G, N, cl, stream)
        da = dap.sum(dim=0)
    _raise_on(err, f"backward (K3b, {route})")
    launches["ssd_scan_bwd"] += 1
    bwd_routes[route] += 1
    rep = H // G
    db = dbh.reshape(B, S, G, rep, N).sum(dim=3)          # group-reduce
    dc = dch.reshape(B, S, G, rep, N).sum(dim=3)
    return dx, ddt, da, db, dc, dinit


class SSDScan(torch.autograd.Function):
    """The scan with the K3b backward (the reference's ``ssd_scan_vjp``;
    K3f and K3b by ``fwd_route``'s and ``bwd_route``'s kernels; K3b reads
    dy in y's dtype as autograd hands it):
    ``SSDScan.apply(x, dt, a, b, c, initial_state, chunk) -> (y,
    final_state)``, initial_state a (B, H, P, N) tensor or None (zeros,
    which the sm90 route then never reads). Saves the inputs and the
    per-chunk states only (none when no input needs a gradient); the
    backward re-streams the chunks in reverse. Gradients come back in
    the inputs' dtypes, d(initial_state) in float32."""

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
        return (*(g.to(t) for g, t in zip(grads[:5], ctx.dtypes)),
                grads[5] if ctx.needs_input_grad[5] else None, None)
