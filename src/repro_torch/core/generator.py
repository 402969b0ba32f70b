"""The DENSE image generator (``repro/core/generator.py:23-64``).

DCGAN-style, as DAFL and the paper use it: fc → BN → 2×(nearest 2×
upsample, 3x3 conv, BN, leaky relu 0.2) → 3x3 conv → tanh. The
generator's BatchNorms always normalize with batch statistics and keep
no running ones. The fc output is read as an NHWC (B, s0, s0, 2·base)
tensor, as in the reference, so its weights carry over unchanged; the
convs work on its NCHW view.
"""
from __future__ import annotations

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
