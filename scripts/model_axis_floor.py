"""The float32 floor under ``chip_smoke.py``'s ``model_axis`` train check.

    python3 scripts/model_axis_floor.py

on a machine with one CUDA card. Runs ``launch.train.train`` on
deepseek-v2-lite-16b at full width cut to 3 layers, float32 without TF32,
3 steps of 2 x 128 on one rank, as ``model_axis`` runs its one-rank
reference, twice without deterministic algorithms and twice with them,
and holds each pair's updated parameters and Adam moments to each other
as ``model_axis`` holds the two-rank run to the one-rank run: the largest
|a − b| over the tensor's largest |b|, and the entries past 1e-4 of it.
For those entries it reports |m|/√v (Adam's update over its learning
rate, before bias correction) and |m| over the tensor's largest |m|.
Prints one JSON line. Builds no kernel.
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.shardings import leaf_paths  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

TOL = 1e-4


def run():
    state, hist = train("deepseek-v2-lite-16b", steps=3, batch=2, seq=128,
                        smoke=False, n_layers=3, dtype="float32",
                        log_every=10 ** 6, device="cuda")
    opt = state["opt"]
    flat = [(keys, p.detach(), m, v) for (keys, p), m, v in
            zip(leaf_paths(state["params"]), opt.m, opt.v)]
    return [h["loss"] for h in hist], [h["grad_norm"] for h in hist], flat


def compare(a, b) -> dict:
    rows, past, ratios, m_rel = [], 0, [], []
    for (keys, pa, ma, va), (_, pb, mb, vb) in zip(a, b, strict=True):
        scale = float(pb.abs().max())
        diff = (pa - pb).abs()
        bad = diff > TOL * scale
        past += int(bad.sum())
        if bad.any():
            ratios += (mb[bad].abs() / vb[bad].sqrt()).tolist()[:8]
            m_rel += (mb[bad].abs() / mb.abs().max()).tolist()[:8]
        m_err = float((ma - mb).abs().max()) / float(mb.abs().max())
        rows.append((float(diff.max()) / scale, m_err, "/".join(keys)))
    rows.sort(reverse=True)
    return {"params_max_rel": rows[0][0],
            "adam_m_max_rel": max(r[1] for r in rows),
            "worst": rows[:4], "entries_past_tol": past,
            "past_m_over_sqrt_v": ratios[:16],
            "past_m_over_max_m": m_rel[:16]}


def main():
    from repro_torch.configs.backend import full_float32

    full_float32()
    out = {"card": torch.cuda.get_device_name(0), "tol": TOL}
    for name, strict in (("nondeterministic", False), ("deterministic",
                                                        True)):
        torch.use_deterministic_algorithms(strict, warn_only=True)
        first, second = run(), run()
        out[name] = {"losses": [first[0], second[0]],
                     "grad_norms": [first[1], second[1]],
                     **compare(second[2], first[2])}
        del first, second
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
