"""The DENSE generators (``repro/core/generator.py``).

``ImgGenerator`` (``:23-64``), the image path, is DCGAN-style, as DAFL and the paper use it: fc → BN → 2×(nearest 2×
upsample, 3x3 conv, BN, leaky relu 0.2) → 3x3 conv → tanh. The
generator's BatchNorms always normalize with batch statistics and keep
no running ones. The fc output is read as an NHWC (B, s0, s0, 2·base)
tensor, as in the reference, so its weights carry over unchanged; the
convs work on its NCHW view.

``TokGenerator`` (``:67-103``), the LM path, maps (z, y) to a sequence
of soft embeddings that decoder LMs take through ``forward(...,
embeds=)``: z projected and added to a learned position table (and to a
label embedding, indexed by one label a sequence), then blocks of a
token mixer (a linear over the sequence axis) and a gelu MLP, each
after a LayerNorm with a residual, and a readout to d_model. Parameters
are named as the reference's tree (``blocks.<i>.mix.w``), so
``interop`` carries it across.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.backend import resolve_device
from repro_torch.models import layers as L


class GenBN(nn.Module):
    """Batch-statistics-only BatchNorm with scale and bias."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x, eps: float = 1e-5):
        mu, var = L.batch_moments(x)
        return L.normalize(x, mu, var, self.scale, self.bias, eps)


class ImgGenerator(nn.Module):
    def __init__(self, *, nz: int, img_size: int, out_ch: int, base: int,
                 generator: torch.Generator):
        super().__init__()
        self.img_size, self.base = img_size, base
        s0 = img_size // 4
        self.fc = L.Linear(nz, 2 * base * s0 * s0, generator=generator)
        self.bn0 = GenBN(2 * base)
        self.c1 = L.Conv(2 * base, 2 * base, 3, generator=generator)
        self.bn1 = GenBN(2 * base)
        self.c2 = L.Conv(2 * base, base, 3, generator=generator)
        self.bn2 = GenBN(base)
        self.c3 = L.Conv(base, out_ch, 3, generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, nz) -> images (B, H, W, C) in (-1, 1)."""
        s0 = self.img_size // 4
        x = self.fc(z).reshape(z.shape[0], s0, s0, 2 * self.base)
        x = self.bn0(x.permute(0, 3, 1, 2))
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = F.leaky_relu(self.bn1(self.c1(x)), 0.2)
        # half-pixel nearest, as jax.image.resize; the same as
        # scale_factor=2 when img_size is a multiple of 4
        x = F.interpolate(x, size=(self.img_size, self.img_size),
                          mode="nearest-exact")
        x = F.leaky_relu(self.bn2(self.c2(x)), 0.2)
        return torch.tanh(self.c3(x)).permute(0, 2, 3, 1)


def img_generator_init(*, nz: int = 100, img_size: int = 32, out_ch: int = 3,
                       base: int = 64, generator: torch.Generator | None = None,
                       device="cuda") -> ImgGenerator:
    """A new generator; weights drawn from ``generator`` (a CPU
    ``torch.Generator``, seeded 0 when None) and moved to ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    gen = ImgGenerator(nz=nz, img_size=img_size, out_ch=out_ch, base=base,
                       generator=generator).to(dev)
    return gen.to(memory_format=torch.channels_last)


def img_generator(gen: ImgGenerator, z: torch.Tensor) -> torch.Tensor:
    """z: (B, nz) -> images (B, H, W, C) in (-1, 1)."""
    return gen(z)


# ---------------------------------------------------------------- LM path --

class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return L.layernorm({"scale": self.scale, "bias": self.bias}, x)


class GeluMLP(nn.Module):
    def __init__(self, d: int, d_ff: int, *, generator):
        super().__init__()
        self.up = L.Linear(d, d_ff, generator=generator)
        self.down = L.Linear(d_ff, d, generator=generator)

    def forward(self, x):
        return L.gelu_mlp({"up": self.up.as_dict(),
                           "down": self.down.as_dict()}, x)


class TokBlock(nn.Module):
    def __init__(self, seq: int, d_g: int, *, generator):
        super().__init__()
        self.norm1 = LayerNorm(d_g)
        self.mix = L.Linear(seq, seq, generator=generator)   # token mixer
        self.norm2 = LayerNorm(d_g)
        self.mlp = GeluMLP(d_g, 4 * d_g, generator=generator)

    def forward(self, h):
        h = h + self.mix(self.norm1(h).transpose(1, 2)).transpose(1, 2)
        return h + self.mlp(self.norm2(h))


class Embedding(nn.Module):
    def __init__(self, n: int, d: int, *, generator):
        super().__init__()
        self.table = nn.Parameter(torch.randn((n, d), generator=generator)
                                  / math.sqrt(d))


class TokGenerator(nn.Module):
    def __init__(self, *, nz: int, seq: int, d_model: int, d_g: int,
                 n_blocks: int, n_classes: int, generator: torch.Generator):
        super().__init__()
        self.pos = nn.Parameter(torch.randn((seq, d_g), generator=generator)
                                * 0.02)
        self.z_proj = L.Linear(nz, d_g, generator=generator)
        self.out = L.Linear(d_g, d_model, generator=generator)
        self.blocks = nn.ModuleList(TokBlock(seq, d_g, generator=generator)
                                    for _ in range(n_blocks))
        self.label = Embedding(n_classes, d_g, generator=generator) \
            if n_classes else None

    def forward(self, z: torch.Tensor, labels: torch.Tensor | None = None):
        """z: (B, nz); labels: (B,) int or None -> (B, seq, d_model)."""
        h = self.z_proj(z)[:, None, :] + self.pos[None]
        if labels is not None and self.label is not None:
            h = h + self.label.table[labels.long()][:, None, :]
        for blk in self.blocks:
            h = blk(h)
        return self.out(h)


def tok_generator_init(*, nz: int = 64, seq: int = 64, d_model: int,
                       d_g: int = 256, n_blocks: int = 2, n_classes: int = 0,
                       generator: torch.Generator | None = None,
                       device="cuda") -> TokGenerator:
    """A new token generator in float32; ``n_classes > 0`` adds the label
    table (class-conditional synthesis). Weights are drawn from
    ``generator`` (a CPU ``torch.Generator``, seeded 0 when None) and
    moved to ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return TokGenerator(nz=nz, seq=seq, d_model=d_model, d_g=d_g,
                        n_blocks=n_blocks, n_classes=n_classes,
                        generator=generator).to(dev)


def tok_generator(gen: TokGenerator, z: torch.Tensor,
                  labels: torch.Tensor | None = None) -> torch.Tensor:
    """z: (B, nz) -> soft embeddings (B, seq, d_model)."""
    return gen(z, labels)
