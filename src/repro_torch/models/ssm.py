"""The Mamba-2 block (SSD, state-space duality, arXiv:2405.21060) of the
ssm and hybrid families (``repro/models/ssm.py``).

Heads H = d_inner / P (P = ``ssm_head_dim``), state N = ``ssm_state``, B
and C shared across ``ssm_n_groups`` groups. The projections are kept
split (``in_z``, ``in_x``, ``in_bc``, ``in_dt`` and two depthwise causal
convs), as the reference keeps them, so ``interop`` carries a tree across
key by key: linear weights (d_in, d_out), conv weights (K, C).
``a_log``, ``dt_bias`` and ``d_skip`` are float32 whatever the parameter
dtype.

``mamba2_apply`` has the reference's three routes:

  * decode (``decode=True``, one token against the state): the O(1)
    recurrence step in float32;
  * the kernel route (``kernel_vjp != "ref"``, the cuda default):
    ``kernels.ops.ssd_scan``, K3 behind ``SSDScan`` on the card, seeded
    with the state's ``ssm`` when there is one (the prefill→decode
    handoff); any S;
  * ``"ref"``: ``ssd_chunked``, the chunked formula in plain PyTorch,
    whose contract (``ssm.py:86``) is S % chunk == 0 once S exceeds the
    chunk.

States are dicts ``{"ssm" (B, H, P, N) float32, "conv_x" (B, K-1,
d_inner), "conv_bc" (B, K-1, 2·G·N)}`` in ``cfg.dtype``; ``mamba2_apply``
returns the new one and leaves the given one as it is.

Partitioned where ``ssm_sharded`` (``tp``, a ``launch/shardings.Layout``):
this rank holds H/m heads, ``in_z``/``in_x``/``in_dt`` column-sharded,
``conv_x``, ``a_log``/``dt_bias``/``d_skip`` and the gated norm's scale
cut by head, ``out_proj`` row-sharded and its output summed over
``model``; ``in_bc``/``conv_bc`` replicated, and B and C enter this
rank's heads through ``tp.enter`` (their gradient sums every rank's
share). The gated RMSNorm normalizes over the whole d_inner, so its sum
of squares is summed over ``model`` (and, feeding rank-local outputs,
its gradient too). The state's ``ssm`` and ``conv_x`` hold this rank's
heads and channels (``cache_specs``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.backend import resolve_exec_policy
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def mamba2_init(cfg, *, generator, dtype, lead: tuple = ()) -> dict:
    """Random parameters as the reference draws them: linears N(0, 1/d_in),
    conv weights N(0, 0.01), biases zero, a_log = log(linspace(1, 16, H)),
    dt_bias 0 and d_skip 1 (float32), the gated norm's scale 1."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, h, k = cfg.ssm_n_groups, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_conv
    dev = generator.device
    kw = {"generator": generator, "dtype": dtype, "lead": lead}

    def conv(width):
        return {"w": L._normal((*lead, k, width), 0.1, generator, dtype),
                "b": torch.zeros((*lead, width), dtype=dtype, device=dev)}

    def per_head(values):
        return values.to(dev).expand(*lead, h).clone()

    return {
        "in_z": L.linear_init(d, di, **kw),
        "in_x": L.linear_init(d, di, **kw),
        "in_bc": L.linear_init(d, 2 * g * n, **kw),
        "in_dt": L.linear_init(d, h, **kw),
        "conv_x": conv(di),
        "conv_bc": conv(2 * g * n),
        "a_log": per_head(torch.log(torch.linspace(1.0, 16.0, h))),
        "dt_bias": per_head(torch.zeros(h)),
        "d_skip": per_head(torch.ones(h)),
        "norm": L.rmsnorm_init(di, dtype=dtype, device=dev, lead=lead),
        "out_proj": L.linear_init(di, d, **kw),
    }


def mamba2_state_init(cfg, batch: int, dtype, device, lead: tuple = ()) -> dict:
    h, p, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    k1 = cfg.ssm_conv - 1
    return {"ssm": torch.zeros((*lead, batch, h, p, n), device=device),
            "conv_x": torch.zeros((*lead, batch, k1, cfg.d_inner),
                                  dtype=dtype, device=device),
            "conv_bc": torch.zeros((*lead, batch, k1,
                                    2 * cfg.ssm_n_groups * cfg.ssm_state),
                                   dtype=dtype, device=device)}


def _causal_conv(x, w, b, pad=None):
    """Depthwise causal conv as the reference's shifted sum. x: (B, S, C),
    w: (K, C); pad: the (B, K-1, C) history, or None for zeros. Returns
    (y, the new history)."""
    K, S = w.shape[0], x.shape[1]
    if pad is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([pad.to(x.dtype), x], dim=1)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return y + b, xp[:, xp.shape[1] - (K - 1):]


def segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j<k<=i} a[..., k]; -inf above the diagonal."""
    T = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, a, b, c, *, chunk: int, initial_state=None):
    """The SSD forward as the chunked formula (``ssm.py:80-127``), the
    model's "ref" route. x: (B, S, H, P), dt: (B, S, H), a: (H,), b/c:
    (B, S, G, N); S must be a multiple of ``chunk``. Returns (y in x's
    dtype, final_state (B, H, P, N) float32)."""
    B, S, H, Pd = x.shape
    G, N = b.shape[2], b.shape[3]
    assert S % chunk == 0, (S, chunk)
    nc, cl = S // chunk, chunk
    rep = H // G
    xb = x.reshape(B, nc, cl, H, Pd).float()
    dtb = dt.reshape(B, nc, cl, H).float()
    bb = b.reshape(B, nc, cl, G, N).repeat_interleave(rep, dim=3).float()
    cb = c.reshape(B, nc, cl, G, N).repeat_interleave(rep, dim=3).float()

    da = dtb * a[None, None, None, :]
    da_cs = torch.cumsum(da, dim=2)
    decay = torch.exp(segsum(da.transpose(-1, -2)))       # (B, nc, H, l, s)
    cb_ls = torch.einsum("bclhn,bcshn->bchls", cb, bb)
    att = cb_ls * decay * dtb.transpose(-1, -2)[..., None, :]
    y_diag = torch.einsum("bchls,bcshp->bclhp", att, xb)

    decay_to_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)
    states = torch.einsum("bclhn,bclh,bclh,bclhp->bchpn", bb, decay_to_end,
                          dtb, xb)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])           # (B, nc, H)
    s = torch.zeros((B, H, Pd, N), device=x.device) if initial_state is None \
        else initial_state.float()
    prev = []
    for ci in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                # (B, nc, H, P, N)
    y_off = torch.einsum("bclhn,bclh,bchpn->bclhp", cb, torch.exp(da_cs),
                         prev_states)
    y = (y_diag + y_off).reshape(B, S, H, Pd)
    return y.to(x.dtype), s


def _local_groups(bmat, cmat, h: int, h_local: int, rank: int):
    """B and C (B, S, G, N) of the groups this rank's heads [rank·h_local,
    (rank + 1)·h_local) read (head j reads group j // (h / G))."""
    rep = h // bmat.shape[2]
    lo = rank * h_local // rep
    hi = ((rank + 1) * h_local - 1) // rep + 1
    return bmat[:, :, lo:hi], cmat[:, :, lo:hi]


def _gated_norm(p, y, z, tp, d_inner: int, eps: float = 1e-6):
    """``rmsnorm(p["norm"], y) * silu(z)`` with the mean of squares over
    the whole d_inner: this rank's sum summed over ``model``."""
    yf = y.float()
    ss = tp.enter(tp.sum((yf * yf).sum(dim=-1, keepdim=True)))
    yn = (yf * torch.rsqrt(ss / d_inner + eps)).to(y.dtype)
    return yn * p["norm"]["scale"].to(y.dtype) * F.silu(z)


def mamba2_apply(p: dict, x: torch.Tensor, cfg, *, state: dict | None = None,
                 decode: bool = False, tp=None):
    """The full Mamba-2 block over x (B, S, D); ``tp``: partitioned
    (module doc). Returns (y (B, S, D), the new state or None)."""
    B, S, _ = x.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, cfg.n_ssm_heads
    pd = cfg.ssm_head_dim
    sharded = tp is not None and tp.ssm
    xr = x
    if sharded:
        h_full, h = h, tp.local(h, "n_ssm_heads")
        di = h * pd
        xr = tp.enter(x)

    z = L.linear(p["in_z"], xr)
    xi = L.linear(p["in_x"], xr)
    bc = L.linear(p["in_bc"], x)
    dt_raw = L.linear(p["in_dt"], xr)

    pad_x = state["conv_x"] if state is not None else None
    pad_bc = state["conv_bc"] if state is not None else None
    xi, new_conv_x = _causal_conv(xi, p["conv_x"]["w"].to(xi.dtype),
                                  p["conv_x"]["b"].to(xi.dtype), pad_x)
    bc, new_conv_bc = _causal_conv(bc, p["conv_bc"]["w"].to(bc.dtype),
                                   p["conv_bc"]["b"].to(bc.dtype), pad_bc)
    xi = F.silu(xi)
    bc = F.silu(bc)
    if sharded:
        bc = tp.enter(bc)

    xs = xi.reshape(B, S, h, pd)
    bmat = bc[..., :g * n].reshape(B, S, g, n)
    cmat = bc[..., g * n:].reshape(B, S, g, n)
    if sharded:
        bmat, cmat = _local_groups(bmat, cmat, h_full, h, tp.rank)
        g = bmat.shape[2]
    v = dt_raw.float() + p["dt_bias"]
    dt = torch.logaddexp(v, torch.zeros_like(v))          # softplus
    a = -torch.exp(p["a_log"])                            # (H,) < 0

    if decode:
        assert state is not None and S == 1
        rep = h // g
        b1 = bmat[:, 0].repeat_interleave(rep, dim=1).float()
        c1 = cmat[:, 0].repeat_interleave(rep, dim=1).float()
        dt1 = dt[:, 0]
        da = torch.exp(dt1 * a[None, :])
        new_ssm = state["ssm"] * da[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt1, xs[:, 0].float(), b1)
        y = torch.einsum("bhpn,bhn->bhp", new_ssm, c1)[:, None].to(x.dtype)
    elif (pol := resolve_exec_policy(cfg, device=x.device)).kernel_vjp \
            != "ref":
        y, new_ssm = ops.ssd_scan(
            xs, dt, a, bmat, cmat, None if state is None else state["ssm"],
            chunk=cfg.ssm_chunk, policy=pol)
    else:
        y, new_ssm = ssd_chunked(
            xs, dt, a, bmat, cmat, chunk=min(cfg.ssm_chunk, S),
            initial_state=None if state is None else state["ssm"])

    y = y + p["d_skip"].to(x.dtype)[None, None, :, None] * xs
    y = y.reshape(B, S, di)
    if sharded:
        out = tp.sum(L.linear(p["out_proj"],
                              _gated_norm(p, y, z, tp, cfg.d_inner)))
    else:
        y = L.rmsnorm(p["norm"], y) * F.silu(z)           # gated norm
        out = L.linear(p["out_proj"], y)
    new_state = None
    if state is not None:
        new_state = {"ssm": new_ssm, "conv_x": new_conv_x,
                     "conv_bc": new_conv_bc}
    return out, new_state
