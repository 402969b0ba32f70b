"""The CNN client zoo (``repro/models/cnn.py``): cnn1, cnn2, lenet,
resnet18, wrn16_1 and wrn40_1, one ``nn.Module`` per client.

API (images are NHWC at the public functions, as in the reference):

  spec = CNNSpec(kind=..., num_classes=..., width=...)
  model = cnn_init(spec, generator=g, device="cuda")
  logits, bn_stats = cnn_apply(model, x, train=...)

``bn_stats`` is the list of {"mean", "var", "running_mean",
"running_var"} per BatchNorm, in the reference's order, which L_BN
reads. Train mode updates the running statistics in place on the
module's buffers; the reference instead returns new params that
``core/dense.py:merge_bn_stats`` writes back after the optimizer step.
The values are the same: the optimizer never touches the buffers.

Inside, the model works on the NCHW view of the images
(``x.permute(0, 3, 1, 2)``, channels_last in memory). The fc after the
flatten of the conv-stack kinds reads features in H, W, C order, as the
reference's reshape of an NHWC tensor does, so its weights carry over
unchanged. The grouped and stacked fast paths of the reference are not
ported; every client runs its own forward.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.backend import resolve_device
from repro_torch.models import layers as L

KINDS = ("cnn1", "cnn2", "resnet18", "wrn16_1", "wrn40_1", "lenet")

_RESNET_LAYOUT = {
    "resnet18": ([2, 2, 2, 2], [64, 128, 256, 512]),
    "wrn16_1": ([2, 2, 2], [16, 32, 64]),
    "wrn40_1": ([6, 6, 6], [16, 32, 64]),
}
_CNN_LAYOUT = {
    "cnn1": [32, 64, 128],
    "cnn2": [16, 32, 64, 128],
    "lenet": [6, 16],
}


@dataclass(frozen=True)
class CNNSpec:
    kind: str = "cnn1"
    num_classes: int = 10
    in_ch: int = 3
    width: float = 1.0          # channel multiplier (tests shrink it)
    image_size: int = 32

    def ch(self, c: int) -> int:
        return max(4, int(round(c * self.width)))


class ConvBN(nn.Module):
    """conv → BatchNorm (→ relu): the reference's ``_cbr``."""

    def __init__(self, c_in, c_out, ksize=3, *, generator):
        super().__init__()
        self.conv = L.Conv(c_in, c_out, ksize, generator=generator)
        self.bn = L.BatchNorm(c_out)

    def forward(self, x, stats, train, stride=1, relu=True):
        y = self.bn(self.conv(x, stride), train=train, stats=stats)
        return F.relu(y) if relu else y


class ConvStack(nn.Module):
    """cnn1 / cnn2 / lenet: (conv, BN, relu, pool) per layer, then fc."""

    def __init__(self, spec: CNNSpec, *, generator):
        super().__init__()
        chans = _CNN_LAYOUT[spec.kind]
        layers, c_prev = [], spec.in_ch
        for c in chans:
            layers.append(ConvBN(c_prev, spec.ch(c), generator=generator))
            c_prev = spec.ch(c)
        self.layers = nn.ModuleList(layers)
        feat = max(1, spec.image_size // (2 ** len(chans)))
        self.fc = L.Linear(c_prev * feat * feat, spec.num_classes,
                           generator=generator)

    def forward(self, x, stats, train):
        for layer in self.layers:
            x = layer(x, stats, train)
            if x.shape[-2] > 1:      # stop pooling at 1x1 (tiny images)
                # drops an odd last row/column, as the reference's crop
                x = F.max_pool2d(x, 2)
        # flatten in H, W, C order, as the reference's NHWC reshape
        return self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


class BasicBlock(nn.Module):
    def __init__(self, c_in, c_out, stride, *, generator):
        super().__init__()
        self.stride = stride
        self.c1 = ConvBN(c_in, c_out, generator=generator)
        self.c2 = ConvBN(c_out, c_out, generator=generator)
        self.proj = ConvBN(c_in, c_out, 1, generator=generator) \
            if stride != 1 or c_in != c_out else None

    def forward(self, x, stats, train):
        y = self.c1(x, stats, train, stride=self.stride)
        y = self.c2(y, stats, train, relu=False)
        sc = x if self.proj is None else \
            self.proj(x, stats, train, stride=self.stride, relu=False)
        return F.relu(y + sc)


class ResNet(nn.Module):
    """resnet18 / wrn16_1 / wrn40_1: stem, stages of basic blocks (the
    first block of every stage after the first has stride 2), global
    mean pool, fc."""

    def __init__(self, spec: CNNSpec, *, generator):
        super().__init__()
        bps, widths = _RESNET_LAYOUT[spec.kind]
        self.stem = ConvBN(spec.in_ch, spec.ch(widths[0]),
                           generator=generator)
        stages, c_prev = [], spec.ch(widths[0])
        for s, w in enumerate(widths):
            blocks = []
            for b in range(bps[s]):
                stride = 2 if (b == 0 and s > 0) else 1
                blocks.append(BasicBlock(c_prev, spec.ch(w), stride,
                                         generator=generator))
                c_prev = spec.ch(w)
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.fc = L.Linear(c_prev, spec.num_classes, generator=generator)

    def forward(self, x, stats, train):
        x = self.stem(x, stats, train)
        for blocks in self.stages:
            for block in blocks:
                x = block(x, stats, train)
        return self.fc(x.mean(dim=(2, 3)))


class CNN(nn.Module):
    """One client model: a spec and its network."""

    def __init__(self, spec: CNNSpec, *, generator):
        super().__init__()
        if spec.kind in _RESNET_LAYOUT:
            net = ResNet
        elif spec.kind in _CNN_LAYOUT:
            net = ConvStack
        else:
            raise ValueError(f"unknown CNN kind {spec.kind!r}")
        self.spec = spec
        self.net = net(spec, generator=generator)

    def forward(self, x_nhwc, *, train: bool, with_stats: bool = False):
        stats = [] if with_stats else None
        logits = self.net(x_nhwc.permute(0, 3, 1, 2), stats, train)
        return logits, stats


def cnn_init(spec: CNNSpec, *, generator: torch.Generator | None = None,
             device="cuda") -> CNN:
    """A new client model. Weights are drawn from ``generator`` (a CPU
    ``torch.Generator``; seeded 0 when None) and moved to ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = CNN(spec, generator=generator).to(dev)
    return model.to(memory_format=torch.channels_last)


def cnn_apply(model: CNN, x: torch.Tensor, *, train: bool,
              with_stats: bool = True):
    """x: (B, H, W, C). Returns (logits, bn_stats); bn_stats is None with
    ``with_stats=False``. Train mode uses batch statistics and updates
    the running statistics in place."""
    return model(x, train=train, with_stats=with_stats)


def cnn_logits(model: CNN, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode logits only."""
    return model(x, train=False)[0]
