"""Convolution, linear and BatchNorm layers for the CNN zoo and the
generator (``repro/models/layers.py:22-40,137-196``).

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


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """x: (B, C, H, W); w: (O, C, k, k). XLA ``SAME`` padding."""
    k = w.shape[-1]
    ph, pw = _same_pads(x.shape[-2], k, stride), _same_pads(x.shape[-1], k,
                                                           stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride)


def batch_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased variance) of a (B, C, H, W) tensor."""
    var, mu = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
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

    def forward(self, x, *, train: bool, stats: list | None = None):
        """Train mode normalizes with the batch moments and updates the
        running buffers in place; eval mode uses the running ones.
        ``stats``, when given, gets this layer's batch moments and the
        running statistics they are held against (L_BN)."""
        if train or stats is not None:
            mu, var = batch_moments(x)
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
