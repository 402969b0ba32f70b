"""Time the grouped teacher's batched designs against each other and
against the looped ensemble, on one card, in turns.

    python3 scripts/grouped_layouts.py [--clients 5] [--rounds 2]
        [--designs channels_last,split_dgrad,looped] [--cudnn-benchmark]

Five resnet18 clients at full width (``paper_cifar.CONFIG``'s), running
statistics moved off their init by one train-mode batch, on a generator
batch of (128, 32, 32, 3), float32 without TF32. Each design runs the
teacher's part of a generator step (the ensemble with BN stats, L_CE +
L_BN, their gradient with respect to the images) and the student step's
teacher (no stats, no autograd):

  * ``channels_last``: ``models/cnn.cnn_stack_apply_grouped`` as the
    port runs it (activations and conv weights channels_last);
  * ``nchw``: the same function on contiguous NCHW images and weights;
  * ``vmap``: ``torch.func.vmap`` over ``torch.func.functional_call`` of
    one client's network on the stacked weights (no folded BN);
  * ``split_dgrad``: the ``channels_last`` forward, with the image
    gradient of every grouped conv taken client by client (m dense
    cuDNN dgrads in place of one grouped one);
  * ``looped``: ``core/ensemble.ensemble_logits``, one forward a client.

``--cudnn-benchmark`` lets cuDNN time its algorithms for every conv
(``torch.backends.cudnn.benchmark``). Its choice is cached per conv shape
for the whole process, whatever the flag is later, so a run with it and
one without are two processes.

In the order of ``--rounds`` passes over the designs (each pass in turn
forward and backward), each gives its device time a call
(``torch.profiler`` over 5 calls after a warm-up: every kernel summed,
and the time at least one device record ran, ``busy_ms``) and its time a
call from CUDA events. Prints one JSON line a pass and
design, then the card's name and power limit. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--designs", default="channels_last,nchw,vmap,"
                    "split_dgrad,looped")
    ap.add_argument("--cudnn-benchmark", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as CS

    torch, smi = CS.setup()
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.configs import CONFIG
    from repro_torch.core import bn_loss, ce_loss, ensemble_logits
    from repro_torch.models import (CNNSpec, cnn_apply, cnn_init,
                                    cnn_stack_apply_grouped, stack_models)

    spec = CNNSpec(kind=CONFIG.global_kind, num_classes=CONFIG.num_classes,
                   in_ch=CONFIG.in_ch, width=CONFIG.width,
                   image_size=CONFIG.image_size)
    m, b, s = args.clients, CONFIG.synth_batch, CONFIG.image_size
    init = torch.Generator().manual_seed(0)
    draws = torch.Generator(device="cuda").manual_seed(1)
    models = [cnn_init(spec, generator=init, device="cuda")
              for _ in range(m)]
    warm = torch.rand((b, s, s, 3), generator=draws, device="cuda") * 2 - 1
    with torch.no_grad():
        for model in models:
            cnn_apply(model, warm, train=True)
    x0 = torch.rand((b, s, s, 3), generator=draws, device="cuda") * 2 - 1
    labels = torch.randint(0, spec.num_classes, (b,), generator=draws,
                           device="cuda")
    stacked = stack_models(models)
    contig = {k: v.contiguous() for k, v in stacked.items()}

    def grouped(params, nchw):
        def fn(x, with_bn_stats=False):
            if nchw:          # an NHWC view of contiguous NCHW images
                x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            lgs, st = cnn_stack_apply_grouped(params, spec, x, m,
                                              with_stats=with_bn_stats)
            avg = lgs.float().mean(dim=0)
            if not with_bn_stats:
                return avg
            return avg, [[{k: v[j] for k, v in d.items()} for d in st]
                         for j in range(m)]
        return fn

    net = models[0].net

    def vmapped(x, with_bn_stats=False):
        xc = x.permute(0, 3, 1, 2)

        def one(p):
            st = [] if with_bn_stats else None
            lg = torch.func.functional_call(net, p, (xc, st, False))
            return (lg, st) if with_bn_stats else lg

        if not with_bn_stats:
            return torch.func.vmap(one)(stacked).float().mean(dim=0)
        lgs, st = torch.func.vmap(one)(stacked)
        avg = lgs.float().mean(dim=0)
        return avg, [[{k: v[j] for k, v in d.items()} for d in st]
                     for j in range(m)]

    class SplitDgrad(torch.autograd.Function):
        """A grouped conv (frozen weights) whose image gradient is taken
        one group at a time."""

        @staticmethod
        def forward(ctx, x, w, bias, stride, padding, groups):
            ctx.save_for_backward(w)
            ctx.conf = (x.shape, stride, padding, groups)
            return F.conv2d(x, w, bias, stride=stride, padding=padding,
                            groups=groups)

        @staticmethod
        def backward(ctx, g):
            assert not any(ctx.needs_input_grad[1:3])
            (w,) = ctx.saved_tensors
            shape, stride, padding, groups = ctx.conf
            ci, o = shape[1] // groups, w.shape[0] // groups
            dx = [torch.nn.grad.conv2d_input(
                (shape[0], ci, *shape[2:]), w[j * o:(j + 1) * o],
                g[:, j * o:(j + 1) * o], stride=stride, padding=padding)
                for j in range(groups)]
            return torch.cat(dx, 1), None, None, None, None, None

    conv2d = L.conv2d

    def split_conv2d(x, w, *, stride=1, groups=1, bias=None):
        if groups == 1:
            return conv2d(x, w, stride=stride, bias=bias)
        k = w.shape[-1]
        ph = L._same_pads(x.shape[-2], k, stride)
        pw = L._same_pads(x.shape[-1], k, stride)
        if ph[0] != ph[1] or pw[0] != pw[1]:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            ph, pw = (0, 0), (0, 0)
        return SplitDgrad.apply(x, w, bias, stride, (ph[0], pw[0]), groups)

    def split_dgrad(x, with_bn_stats=False):
        L.conv2d = split_conv2d
        try:
            return grouped(stacked, False)(x, with_bn_stats=with_bn_stats)
        finally:
            L.conv2d = conv2d

    every = {"channels_last": grouped(stacked, False),
             "nchw": grouped(contig, True), "vmap": vmapped,
             "split_dgrad": split_dgrad,
             "looped": functools.partial(ensemble_logits, models)}
    designs = {name: every[name] for name in args.designs.split(",")}

    def teacher_step(fn):
        x = x0.clone().requires_grad_(True)
        avg, st = fn(x, with_bn_stats=True)
        (grad,) = torch.autograd.grad(ce_loss(avg, labels) + bn_loss(st),
                                      [x])
        return grad

    def teacher_eval(fn):
        with torch.no_grad():
            return fn(x0)

    want = teacher_step(every["looped"])
    for r in range(args.rounds):
        order = list(designs) if r % 2 == 0 else list(designs)[::-1]
        for name in order:
            fn = designs[name]
            err = float((teacher_step(fn) - want).abs().max()
                        / want.abs().max())
            row = {"pass": r, "design": name, "clients": m,
                   "cudnn_benchmark": args.cudnn_benchmark,
                   "image_grad_rel_to_max": err}
            for part, call in (("gen_step_teacher", teacher_step),
                               ("student_step_teacher", teacher_eval)):
                ms, records = CS.device_ms_total(
                    torch, lambda: call(fn), calls=5)
                row[part] = {"device_ms": ms, "kernel_records": records,
                             **CS.device_busy_ms(torch, lambda: call(fn)),
                             "ms": CS.cuda_ms(torch, lambda: call(fn),
                                              samples=5)}
            print(json.dumps(row), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
