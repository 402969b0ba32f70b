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
unchanged.

The grouped forwards (``cnn_stack_apply_grouped`` in eval mode,
``cnn_stack_train_grouped`` in train mode) run m same-spec clients as one
network over a stacked group of weights: see the section below.
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

    def forward(self, x, stats, train, stride=1, relu=True, mask=None):
        y = self.bn(self.conv(x, stride), train=train, stats=stats,
                    sample_mask=mask)
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

    def forward(self, x, stats, train, mask=None):
        for layer in self.layers:
            x = layer(x, stats, train, mask=mask)
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

    def forward(self, x, stats, train, mask=None):
        y = self.c1(x, stats, train, stride=self.stride, mask=mask)
        y = self.c2(y, stats, train, relu=False, mask=mask)
        sc = x if self.proj is None else self.proj(
            x, stats, train, stride=self.stride, relu=False, mask=mask)
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

    def forward(self, x, stats, train, mask=None):
        x = self.stem(x, stats, train, mask=mask)
        for blocks in self.stages:
            for block in blocks:
                x = block(x, stats, train, mask=mask)
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

    def forward(self, x_nhwc, *, train: bool, with_stats: bool = False,
                sample_mask: torch.Tensor | None = None):
        stats = [] if with_stats else None
        logits = self.net(x_nhwc.permute(0, 3, 1, 2), stats, train,
                          mask=sample_mask)
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
              with_stats: bool = True,
              sample_mask: torch.Tensor | None = None):
    """x: (B, H, W, C). Returns (logits, bn_stats); bn_stats is None with
    ``with_stats=False``. Train mode uses batch statistics and updates
    the running statistics in place. ``sample_mask`` ((B,) bool) marks
    the valid rows of a padded batch: the batch statistics (the
    normalization, the running-statistic update and bn_stats) count
    those rows only; padded rows still get logits, which the loss must
    mask out."""
    return model(x, train=train, with_stats=with_stats,
                 sample_mask=sample_mask)


def cnn_logits(model: CNN, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode logits only."""
    return model(x, train=False)[0]


# ------------------------------------------- grouped (m-client) forwards --
#
# m clients of one spec run as ONE network whose every activation holds
# the m clients' channels side by side, client-major: (B, m·C, H, W),
# channels_last in memory. A stacked group is a dict of tensors named as
# a client's ``net.state_dict()``, each with a leading client axis of m
# (``stack_models``); a conv weight (m, O, I, k, k) is laid out as
# (m, O, k, k, I), so its (m·O, I, k, k) view is channels_last too.
#
#   * The conv reading a shared input (the eval forward's images) is one
#     conv with m·O output channels; every other conv is one cuDNN
#     grouped conv (groups = m), SAME-padded as ``layers.conv2d`` pads.
#   * BatchNorm is per channel, so it is already per client; its batch
#     moments are reduced over (B, H, W) and read as (m, C), masked per
#     client in train mode.
#   * The fc is one ``torch.baddbmm`` over the client axis, on features
#     flattened in each client's own H, W, C order.
#
# The reference builds its grouped forwards from im2col einsums, because
# XLA on the CPU lowers grouped-conv gradients badly
# (``repro/models/cnn.py:404-411``); cuDNN has grouped convs of its own.
# Of the batched designs timed on an H100 (``scripts/grouped_layouts.py``)
# channels_last grouped convs were the fastest: NCHW took 1.4x their
# time, ``torch.func.vmap`` lowers to the same grouped convs.

def _stack_chunked(ts, chunk: int = 0) -> torch.Tensor:
    if chunk and 0 < chunk < len(ts):
        return torch.cat([torch.stack(ts[i:i + chunk])
                          for i in range(0, len(ts), chunk)])
    return torch.stack(ts)


def stack_tensors(ts, chunk: int = 0) -> torch.Tensor:
    """Per-client tensors as a new (m, ...) tensor; conv weights (4-D)
    keep their input channels innermost. ``chunk`` > 0 stacks in slices
    of that many clients, concatenated: the same values, bit for bit
    (DESIGN.md §13)."""
    if ts[0].dim() == 4:
        return _stack_chunked([t.permute(0, 2, 3, 1) for t in ts],
                              chunk).permute(0, 1, 4, 2, 3)
    return _stack_chunked(list(ts), chunk)


@torch.no_grad()
def stack_models(models, chunk: int = 0) -> dict:
    """Same-spec client models as one stacked group: a new tensor a
    ``net.state_dict()`` entry, with a leading client axis (``chunk``:
    ``stack_tensors``)."""
    states = [m.net.state_dict() for m in models]
    return {k: stack_tensors([s[k].detach() for s in states], chunk)
            for k in states[0]}


def _inner_last(v: torch.Tensor) -> torch.Tensor:
    """A stacked conv weight (m, O, I, k, k) as the (m, O, k, k, I) tensor
    it is stored as; any other leaf as it is."""
    return v.permute(0, 1, 3, 4, 2) if v.dim() == 5 else v


def _inner_first(v: torch.Tensor) -> torch.Tensor:
    return v.permute(0, 1, 4, 2, 3) if v.dim() == 5 else v


@torch.no_grad()
def cat_stacked(stacks) -> dict:
    """Stacked groups of one spec concatenated on the client axis, in the
    layout ``stack_tensors`` gives: new tensors."""
    return {k: _inner_first(torch.cat([_inner_last(st[k]) for st in stacks]))
            for k in stacks[0]}


@torch.no_grad()
def take_stacked(stacked: dict, rows) -> dict:
    """The clients ``rows`` (a sequence of indices) of a stacked group,
    in that order, in ``stack_tensors``' layout: new tensors."""
    out = {}
    for k, v in stacked.items():
        idx = torch.as_tensor(rows, dtype=torch.long, device=v.device)
        out[k] = _inner_first(_inner_last(v).index_select(0, idx)
                              .contiguous())
    return out


def cnn_view(spec: CNNSpec, tensors: dict) -> CNN:
    """A ``CNN`` whose parameters and buffers are ``tensors`` themselves
    (named as its ``net.state_dict()``; no copy): ``cnn_view(spec,
    {k: v[j] ...})`` is client j of a stacked group, and sees every
    in-place update of the stack."""
    with torch.device("meta"):
        model = CNN(spec, generator=None)
    model.net.load_state_dict(tensors, strict=True, assign=True)
    return model


def client_views(spec: CNNSpec, stacked: dict) -> list:
    """One ``cnn_view`` per client of a stacked group."""
    m = group_size(stacked)
    return [cnn_view(spec, {k: v[j] for k, v in stacked.items()})
            for j in range(m)]


def group_size(stacked: dict) -> int:
    return next(iter(stacked.values())).shape[0]


def is_running_stat(name: str) -> bool:
    """A BatchNorm running statistic: trained by no optimizer."""
    return name.endswith((".bn.mean", ".bn.var"))


def is_conv_stack(kind: str) -> bool:
    """The plain conv-stack kinds (cnn1, cnn2, lenet)."""
    return kind in _CNN_LAYOUT


def is_groupable(kind: str) -> bool:
    """Kinds the grouped forwards take: every kind of the zoo."""
    return kind in _CNN_LAYOUT or kind in _RESNET_LAYOUT


class _Grouped:
    """One grouped forward's settings and what it records."""

    def __init__(self, stacked, m, mode, sample_mask=None, momentum=0.9,
                 eps=1e-5, with_stats=True):
        self.p, self.m, self.mode = stacked, m, mode
        self.mask, self.momentum, self.eps = sample_mask, momentum, eps
        self.stats = [] if with_stats else None
        self.new_stats = {}

    def moments(self, pre):
        """Per-client per-channel (mean, biased var), each (m, C), of a
        (B, m·C, H, W) activation; in train mode over the rows that
        ``sample_mask`` ((m, B)) keeps."""
        if self.mode != "train" or self.mask is None:
            mu, var = L.batch_moments(pre)
            return mu.view(self.m, -1), var.view(self.m, -1)
        return L.masked_batch_moments(pre, self.mask)

    def cbr(self, name, h, *, groups, stride=1, relu=True):
        """conv → BN (→ relu) of client layer ``name`` for all m."""
        p, m, eps = self.p, self.m, self.eps
        w = p[f"{name}.conv.w"]
        o = w.shape[1]
        scale, bias = p[f"{name}.bn.scale"], p[f"{name}.bn.bias"]
        r_mean, r_var = p[f"{name}.bn.mean"], p[f"{name}.bn.var"]
        if self.mode == "fold":
            # eval BN folded into the conv: conv(x, w·s) + t
            s = scale * torch.rsqrt(r_var + eps)
            t = bias - r_mean * s
            wf = (w * s[:, :, None, None, None]).reshape(m * o, *w.shape[2:])
            y = L.conv2d(h, wf, stride=stride, groups=groups,
                         bias=t.reshape(-1))
            return F.relu(y) if relu else y
        pre = L.conv2d(h, w.reshape(m * o, *w.shape[2:]), stride=stride,
                       groups=groups)
        if self.mode == "train" or self.stats is not None:
            mu, var = self.moments(pre)
        if self.stats is not None:
            self.stats.append({"mean": mu, "var": var, "running_mean": r_mean,
                               "running_var": r_var})
        if self.mode == "train":
            mo = self.momentum
            self.new_stats[f"{name}.bn.mean"] = \
                (mo * r_mean + (1 - mo) * mu).detach()
            self.new_stats[f"{name}.bn.var"] = \
                (mo * r_var + (1 - mo) * var).detach()
        else:
            mu, var = r_mean, r_var
        y = L.normalize(pre, mu.reshape(-1), var.reshape(-1),
                        scale.reshape(-1), bias.reshape(-1), eps)
        return F.relu(y) if relu else y

    def fc(self, feat):
        """feat (m, B, F) -> logits (m, B, K)."""
        w, b = self.p["fc.w"], self.p["fc.b"]
        return torch.baddbmm(b[:, None, :].to(feat.dtype), feat,
                             w.transpose(1, 2).to(feat.dtype))

    def net(self, spec: CNNSpec, h, first_groups: int):
        m = self.m
        if spec.kind in _CNN_LAYOUT:
            for i in range(len(_CNN_LAYOUT[spec.kind])):
                h = self.cbr(f"layers.{i}", h,
                             groups=first_groups if i == 0 else m)
                if h.shape[-2] > 1:          # stop pooling at 1x1
                    h = F.max_pool2d(h, 2)
            b, mc, hh, ww = h.shape
            # each client's features in H, W, C order, as its fc reads them
            feat = h.view(b, m, mc // m, hh, ww).permute(1, 0, 3, 4, 2)
            return self.fc(feat.reshape(m, b, -1))
        bps, _ = _RESNET_LAYOUT[spec.kind]
        h = self.cbr("stem", h, groups=first_groups)
        for s, n_blocks in enumerate(bps):
            for b in range(n_blocks):
                name = f"stages.{s}.{b}"
                stride = 2 if (b == 0 and s > 0) else 1
                y = self.cbr(f"{name}.c1", h, groups=m, stride=stride)
                y = self.cbr(f"{name}.c2", y, groups=m, relu=False)
                sc = self.cbr(f"{name}.proj", h, groups=m, stride=stride,
                              relu=False) \
                    if f"{name}.proj.conv.w" in self.p else h
                h = F.relu(y + sc)
        feat = h.mean(dim=(2, 3))
        return self.fc(feat.view(feat.shape[0], m, -1).transpose(0, 1))


def cnn_stack_apply_grouped(stacked: dict, spec: CNNSpec, x: torch.Tensor,
                            m: int, *, with_stats: bool = False):
    """Eval-mode forward of a stacked group of m same-spec clients on
    shared images x (B, H, W, C) (``repro/models/cnn.py:347-366``).

    Returns (logits (m, B, K), bn_stats): one dict a BatchNorm, in the
    per-client forward's order, of {"mean", "var", "running_mean",
    "running_var"} each (m, C). Without stats the list is empty, and the
    forward folds eval BN into the conv kernels (the reference's
    ``_fold_bn``), which sums in another order than BN after the conv."""
    g = _Grouped(stacked, m, "eval" if with_stats else "fold",
                 with_stats=with_stats)
    logits = g.net(spec, x.permute(0, 3, 1, 2), first_groups=1)
    return logits, (g.stats if with_stats else [])


def cnn_stack_train_grouped(stacked: dict, spec: CNNSpec, x: torch.Tensor,
                            sample_mask: torch.Tensor | None = None,
                            momentum: float = 0.9, eps: float = 1e-5):
    """Train-mode forward of a stacked group of m same-spec clients, each
    on its own batch: x (m, B, H, W, C), ``sample_mask`` (m, B) the valid
    rows of a padded batch (None: all) (``repro/models/cnn.py:394-443``,
    for every kind, resnet18 included).

    BN normalizes with each client's (masked) batch moments. Returns
    (logits (m, B, K), new_stats, bn_stats): new_stats maps each
    ``*.bn.mean`` / ``*.bn.var`` name to the updated running statistics
    (m, C), as ``layers.BatchNorm`` computes them, detached, for the
    caller to write back after its optimizer step; the stack itself is
    not changed."""
    m, b, hh, ww, c = x.shape
    g = _Grouped(stacked, m, "train", sample_mask=sample_mask,
                 momentum=momentum, eps=eps)
    h = x.permute(1, 2, 3, 0, 4).reshape(b, hh, ww, m * c).permute(0, 3, 1, 2)
    logits = g.net(spec, h, first_groups=m)
    return logits, g.new_stats, g.stats
