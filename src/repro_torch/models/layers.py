"""Convolution, linear and BatchNorm layers for the CNN zoo and the
generator (``repro/models/layers.py:22-40,137-196``), and the LM layers
of the transformer trunk (``:22-135``).

Layers work on NCHW tensors (the port permutes the public NHWC images
once, at the model's edge). Two places where torch's defaults differ
from the reference are written out by hand:

  * ``conv2d`` pads as XLA's ``SAME`` does: out = ceil(in / stride) and
    the odd pixel of padding goes last. For a stride-2 3x3 conv on an
    even input that is (0, 1), where torch's ``padding=1`` would pad
    (1, 1).
  * ``batchnorm`` normalizes with the biased batch variance and keeps
    running statistics as ``0.9·old + 0.1·batch`` of the biased
    variance; ``nn.BatchNorm2d`` would store the unbiased one.

The LM layers are functions over dicts of tensors named as the
reference's parameter tree, so ``interop`` carries a tree across key by
key with no change of layout: ``linear`` weights stay (d_in, d_out).
``lead`` on an init prepends axes, so one draw makes a stack of layers
(the reference vmaps its inits over a layer axis). Their hazards:

  * ``rmsnorm`` normalizes in float32, casts back, and only then
    multiplies by the scale, in the activation dtype;
  * RoPE rotates halves (x[:h], x[h:]), not interleaved pairs;
  * ``layernorm`` (the token generator's) uses the biased variance and
    eps 1e-5; ``gelu_mlp`` the tanh form of gelu, ``jax.nn.gelu``'s
    default.

Given ``tp`` (a ``launch/shardings.Layout``) the layers hold this rank's
shards, as ``param_specs`` cuts them, and write out the collectives the
reference's compiler inserts: ``embed`` looks up the rows of this rank's
vocabulary slice, zero elsewhere, summed over ``model``; ``unembed``
gives this rank's vocabulary columns; the MLPs take ``gate``/``up``
column- and ``down`` row-sharded, their output summed over ``model``.
A replicated activation that feeds a rank-local product enters it
through ``tp.enter`` (``replicated_over``), so that its gradient sums
every rank's share.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           groups: int = 1, bias: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, C, H, W); w: (O, C / groups, k, k). XLA ``SAME`` padding."""
    k = w.shape[-1]
    ph, pw = _same_pads(x.shape[-2], k, stride), _same_pads(x.shape[-1], k,
                                                           stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, bias, stride=stride, padding=(ph[0], pw[0]),
                        groups=groups)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, bias, stride=stride, groups=groups)


def batch_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased variance) of a (B, C, H, W) tensor."""
    var, mu = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
    return mu, var


def masked_batch_moments(x: torch.Tensor, sample_mask: torch.Tensor):
    """Per-channel (mean, biased variance) of a (B, C, H, W) tensor over
    the rows where ``sample_mask`` is True: the moments of the valid
    sub-batch of a padded ragged minibatch
    (``repro/models/layers.py:158-171``).

    ``sample_mask`` (B,) bool gives (C,) moments. (m, B) takes x as m
    clients' activations side by side, client-major over the C channels
    (the grouped forwards' layout), each client's channels over its own
    rows, and gives (m, C / m) moments."""
    b, c, h, w = x.shape
    mask = sample_mask.reshape(-1, b)
    m = mask.shape[0]
    x5 = x.float().view(b, m, c // m, h, w)
    wt = mask.float().t().reshape(b, m, 1, 1, 1)
    count = torch.clamp(wt.sum(dim=(0, 2, 3, 4)) * (h * w), min=1.0)[:, None]
    mu = (x5 * wt).sum(dim=(0, 3, 4)) / count
    var = ((x5 - mu[None, :, :, None, None]).square() * wt).sum(
        dim=(0, 3, 4)) / count
    if sample_mask.dim() == 1:
        return mu[0], var[0]
    return mu, var


def normalize(x, mu, var, scale, bias, eps: float = 1e-5):
    """(x − μ)·rsqrt(σ² + eps)·scale + bias over the channel axis 1."""
    c = (1, -1, 1, 1)
    y = (x.float() - mu.view(c)) * torch.rsqrt(var.view(c) + eps)
    return y.to(x.dtype) * scale.view(c) + bias.view(c)


class Conv(nn.Module):
    """A bias-free conv weight, (O, I, k, k), He-normal at init."""

    def __init__(self, c_in: int, c_out: int, ksize: int, *, generator):
        super().__init__()
        w = torch.randn((c_out, c_in, ksize, ksize), generator=generator)
        self.w = nn.Parameter(w * math.sqrt(2.0 / (c_in * ksize * ksize)))

    def forward(self, x, stride: int = 1):
        return conv2d(x, self.w, stride=stride)


class Linear(nn.Module):
    """y = x @ w.T + b with w of shape (d_out, d_in), N(0, 1/d_in) at
    init, b zero (the reference keeps w as (d_in, d_out); interop
    transposes). Every linear layer of the slice has a bias."""

    def __init__(self, d_in: int, d_out: int, *, generator):
        super().__init__()
        w = torch.randn((d_out, d_in), generator=generator) / math.sqrt(d_in)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        return F.linear(x, self.w, self.b)

    def as_dict(self) -> dict:
        """The weights as the functional LM layers take them: w as
        (d_in, d_out) (a view), b."""
        return {"w": self.w.T, "b": self.b}


class BatchNorm(nn.Module):
    """BatchNorm over axis 1 with scale/bias parameters and running
    mean/var buffers (``layers.batchnorm``)."""

    def __init__(self, c: int, *, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.momentum, self.eps = momentum, eps

    def forward(self, x, *, train: bool, stats: list | None = None,
                sample_mask: torch.Tensor | None = None):
        """Train mode normalizes with the batch moments and updates the
        running buffers in place; eval mode uses the running ones.
        ``stats``, when given, gets this layer's batch moments and the
        running statistics they are held against (L_BN). ``sample_mask``
        ((B,) bool) takes the moments over the valid rows only, so that
        padded rows neither shift the normalization nor reach the
        running statistics."""
        if train or stats is not None:
            mu, var = batch_moments(x) if sample_mask is None \
                else masked_batch_moments(x, sample_mask)
        if stats is not None:
            # train mode updates the buffers below: record them as they
            # were before this batch, as the reference does
            stats.append({"mean": mu, "var": var,
                          "running_mean": self.mean.clone() if train
                          else self.mean,
                          "running_var": self.var.clone() if train
                          else self.var})
        if train:
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mu)
                self.var.copy_(m * self.var + (1 - m) * var)
            return normalize(x, mu, var, self.scale, self.bias, self.eps)
        return normalize(x, self.mean, self.var, self.scale, self.bias,
                         self.eps)


# ------------------------------------------------------------ LM layers --

class MetaDraws:
    """Stands in for a ``torch.Generator`` where nothing is drawn: the
    initializers then build meta tensors of the right shapes and dtypes
    (``transformer.init_model(cfg, device="meta")``)."""
    device = torch.device("meta")


def _normal(shape, std: float, generator, dtype) -> torch.Tensor:
    """N(0, std²) drawn in float32 on the generator's device, then cast
    (scaled in place: a full-width expert stack is ~19 GB in float32); an
    empty meta tensor for ``MetaDraws``."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w.mul_(std).to(dtype)


def linear_init(d_in: int, d_out: int, *, generator, dtype,
                lead: tuple = (), bias: bool = False) -> dict:
    p = {"w": _normal((*lead, d_in, d_out), 1.0 / math.sqrt(d_in),
                      generator, dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype,
                             device=generator.device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b) with w of shape (d_in, d_out), in the activation
    dtype."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(d: int, *, dtype, device, lead: tuple = ()) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * p["scale"].to(x.dtype)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalizes in float32 with the biased variance, casts back, then
    scales and shifts in the activation dtype."""
    xf = x.float()
    var, mu = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def embed_init(vocab: int, d: int, *, generator, dtype) -> dict:
    return {"table": _normal((vocab, d), 1.0 / math.sqrt(d), generator,
                             dtype)}


def embed(p: dict, ids: torch.Tensor, compute_dtype=None,
          tp=None) -> torch.Tensor:
    """Rows of the table, cast after the gather (the same values as the
    reference's cast-then-take). Vocabulary-parallel under ``tp``: the
    table holds this rank's rows."""
    table = p["table"]
    if tp is not None and tp.vocab:
        n = table.shape[0]
        local = ids.long() - tp.rank * n
        inside = ((local >= 0) & (local < n))[..., None]
        x = tp.sum(torch.where(inside, table[local.clamp(0, n - 1)],
                               torch.zeros((), dtype=table.dtype,
                                           device=table.device)))
    else:
        x = table[ids]
    return x if compute_dtype is None else x.to(compute_dtype)


def unembed(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Tied-weights readout: (..., d) @ (d, vocab); under a
    vocabulary-parallel ``tp``, this rank's vocabulary columns."""
    if tp is not None and tp.vocab:
        x = tp.enter(x)
    return x @ p["table"].to(x.dtype).T


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0):
    """positions: (...,) int -> cos, sin of shape (..., head_dim // 2),
    float32."""
    half = head_dim // 2
    exps = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    ang = positions[..., None].float() * torch.pow(theta, exps)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (S, Dh//2) or (B, S, Dh//2). Rotates
    the halves in float32 and casts back."""
    half = x.shape[-1] // 2
    if cos.dim() == x.dim() - 2:            # (S, half) -> over B and H
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif cos.dim() == x.dim() - 1:          # (B, S, half) -> over H
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def swiglu_init(d: int, d_ff: int, *, generator, dtype,
                lead: tuple = ()) -> dict:
    kw = {"generator": generator, "dtype": dtype, "lead": lead}
    return {"gate": linear_init(d, d_ff, **kw),
            "up": linear_init(d, d_ff, **kw),
            "down": linear_init(d_ff, d, **kw)}


def swiglu_partial(p: dict, x: torch.Tensor) -> torch.Tensor:
    """down(silu(gate(x))·up(x)) over the columns ``p`` holds: the whole
    MLP, or under a layout this rank's share of it (to be summed over
    ``model``)."""
    return linear(p["down"], F.silu(linear(p["gate"], x))
                  * linear(p["up"], x))


def swiglu(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    if tp is None:
        return swiglu_partial(p, x)
    return tp.sum(swiglu_partial(p, tp.enter(x)))


def gelu_mlp(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """down(gelu(up(x))) with the tanh form of gelu, as ``jax.nn.gelu``
    computes it by default."""
    if tp is not None:
        x = tp.enter(x)
    y = linear(p["down"], F.gelu(linear(p["up"], x), approximate="tanh"))
    return y if tp is None else tp.sum(y)
