"""How far the chunked and unchunked teachers' image gradients lie from
each other with and without cuDNN, on one card.

    python3 scripts/teacher_grad_cudnn.py [--clients 200] [--chunk 64]

m cnn1 clients at ``paper_cifar``'s widths (32x32x3, width 1.0), drawn
from seeded inits, their BN running statistics set to seeded values
(means in [0, 0.5), variances in [0.1, 2.1)), on one generator batch of
128 images, float32 without TF32. For each loss, ``ce`` (L_CE of the
ensemble's average) and ``both`` (L_CE + L_BN, a generator step's
teacher part), it takes the gradient with respect to the images four
ways: the teacher unchunked and in slices of ``--chunk`` clients
(``grouped_ensemble_logits(chunk=)``), each with cuDNN and without
(``chip_smoke.without_cudnn``: PyTorch's own convolutions), and prints one JSON line a loss with every pair's
max |a − b| / max |b|.

Without cuDNN the chunked and unchunked gradients differ by summation
order alone; the pairs across cuDNN on and off show how far cuDNN's
float32 algorithms at these shapes move the image gradient.
``chip_smoke.py``'s ``scale_round`` holds its check to what this shows
(``SCALE_TEACHER_TOL``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=64)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as C
    from repro_torch.core import (Client, bn_loss, ce_loss,
                                  grouped_ensemble_logits, img_generator_init,
                                  stack_grouped)
    from repro_torch.models import CNNSpec, cnn_init

    C.full_float32(torch)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    spec = CNNSpec(kind="cnn1", num_classes=10, in_ch=3, width=1.0,
                   image_size=32)
    g = torch.Generator().manual_seed(0)
    clients = [Client(spec=spec, model=cnn_init(spec, generator=g,
                                                device="cuda"))
               for _ in range(args.clients)]
    with torch.no_grad():
        for c in clients:
            for name, b in c.model.named_buffers():
                mean = name.endswith("mean")
                b.copy_(torch.rand(b.shape, generator=g).to(b)
                        * (0.5 if mean else 2.0) + (0.0 if mean else 0.1))
    gspecs, gparams = stack_grouped(clients)
    gen = img_generator_init(nz=100, img_size=32, out_ch=3,
                             generator=torch.Generator().manual_seed(31),
                             device="cuda")
    src = torch.Generator(device="cuda").manual_seed(32)
    with torch.no_grad():
        x = gen(torch.randn((128, 100), device="cuda", generator=src))
    y = torch.randint(0, 10, (128,), device="cuda", generator=src)

    def grad(chunk, cudnn, which):
        with contextlib.nullcontext() if cudnn else C.without_cudnn(torch):
            xg = x.clone().requires_grad_(True)
            avg, st = grouped_ensemble_logits(gspecs, gparams, xg,
                                              with_bn_stats=True,
                                              chunk=chunk)
            loss = ce_loss(avg, y) + (bn_loss(st) if which == "both" else 0)
            return torch.autograd.grad(loss, [xg])[0]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for which in ("ce", "both"):
        got = {f"{'chunked' if chunk else 'unchunked'}"
               f"{'' if cudnn else '_no_cudnn'}": grad(chunk, cudnn, which)
               for cudnn in (True, False) for chunk in (args.chunk, 0)}
        names = list(got)
        print(json.dumps({"loss": which, "clients": args.clients,
                          "chunk": args.chunk,
                          "rel_to_max": {f"{a} | {b}": rel(got[a], got[b])
                                         for i, a in enumerate(names)
                                         for b in names[i + 1:]}}),
              flush=True)


if __name__ == "__main__":
    main()
