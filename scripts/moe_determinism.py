"""Whether the MoE layer's scatters are deterministic on one card.

    python3 scripts/moe_determinism.py [--tokens 128]

At deepseek-v2-lite-16b's full width (depth 2, float32 without TF32,
capacity factor 0.5 so that tokens drop: ``chip_smoke.py``'s
``family_train_check`` settings), from seeded weights and ``--tokens``
seeded hidden states, it asks whether
``torch.use_deterministic_algorithms(True)`` (strict) accepts the layer's
two scatters at the layer's shapes: the ``index_add_`` that adds the
experts' outputs back to their tokens, and the accumulating
``index_put_`` that the slot gather's backward runs, each with two calls
compared bit for bit; then whether both, and the layer's forward and
backward (``moe._moe_local``, the gradient with respect to the tokens),
repeat bit for bit without it. Prints the card's name and power limit
and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=128)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as C
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    C.full_float32(torch)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = C.family_cfg("deepseek-v2-lite-16b", 2, "float32").replace(
        capacity_factor=C.FAMILY_TRAIN_CAPACITY)
    p = T.layer(T.init_model(cfg, seed=4, device="cuda")["blocks"], 0)["moe"]
    x = torch.randn(args.tokens, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(4))
    cap = M._capacity(x.shape[0], cfg)

    def layer():
        xx = x.detach().clone().requires_grad_(True)
        y, _ = M._moe_local(xx, p["router"]["w"], p["gate"], p["up"],
                            p["down"], cfg=cfg, capacity=cap)
        return y.detach(), torch.autograd.grad(y.float().square().sum(),
                                               xx)[0]

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_slots = cfg.n_experts * cap
    idx = torch.randint(0, x.shape[0] + 1, (n_slots,), generator=gen,
                        device="cuda")
    src = torch.randn(n_slots, x.shape[1], generator=gen, device="cuda")
    ops = {"index_add_": lambda: x.new_zeros((x.shape[0] + 1, x.shape[1]))
           .index_add_(0, idx, src),
           "index_put_accumulate": lambda: x.new_zeros(
               (x.shape[0] + 1, x.shape[1])).index_put_((idx,), src,
                                                        accumulate=True)}
    out = {"card": C.card(), "torch": torch.__version__,
           "shape": [n_slots, x.shape[1]], "rows": x.shape[0] + 1}
    torch.use_deterministic_algorithms(True)
    for name, fn in ops.items():
        try:
            a, b = fn(), fn()
            out[name] = {"accepted_strict": True,
                         "bitwise_repeat": bool(torch.equal(a, b))}
        except RuntimeError as e:
            out[name] = {"accepted_strict": False, "error": str(e)[:240]}
    torch.use_deterministic_algorithms(False)
    for name, fn in ops.items():
        a, b = fn(), fn()
        out[name]["bitwise_repeat_default"] = bool(torch.equal(a, b))
    (ya, ga), (yb, gb) = layer(), layer()
    out["layer_bitwise_repeat_default"] = {
        "y": bool(torch.equal(ya, yb)), "dx": bool(torch.equal(ga, gb)),
        "y_max_abs_diff": float((ya - yb).abs().max()),
        "dx_max_abs_diff": float((ga - gb).abs().max())}
    print(json.dumps({"moe_determinism": out}), flush=True)


if __name__ == "__main__":
    main()
