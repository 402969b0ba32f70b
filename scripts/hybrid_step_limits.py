"""The readings that set ``chip_smoke.py``'s limits for ssm_hybrid_train.

Takes zamba2-7b's first bfloat16 train step as the phase does (full
width, HYBRID_LAYERS deep, 2 x 512, the phase's weights and batch) on the
plain route, then on the kernel route as it is and with one fault put
into a kernel's output at a time. Each fault is one the kernels' design
could make: an epilogue store guard one 16-column step short at D 112, a
tile of the grid never launched, the chunk state not carried into the
next chunk. A second seed's sound step gives the spread of a sound run.

For each step it prints one JSON line: the loss and grad_norm, each
relative to the plain route's, and the largest gradient error relative
to that gradient's largest entry (the per-head scalars apart, as
``train_check`` holds them). A sound run gives the floor, a faulty one
what a limit has to catch.

    python3 scripts/hybrid_step_limits.py

needs a CUDA card and builds the kernels as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as CS  # noqa: E402


def _grads_err(got, want, names) -> dict:
    errs = [(CS._grad_err(a, b), n) for a, b, n in zip(got, want, names)]
    scalar = [e for e, n in errs if n.rsplit(".", 1)[-1] in CS.SCALARS]
    rest = [(e, n) for e, n in errs if n.rsplit(".", 1)[-1] not in CS.SCALARS]
    return {"grads_max_err_rel_to_max": max(e for e, _ in rest),
            "scalar_grads_max_err_rel_to_max": max(scalar, default=None),
            "worst_grads": sorted(rest, reverse=True)[:3]}


def faults(FA, K3) -> dict:
    """name -> (module, attribute, the faulty function made from the
    sound one)."""
    def k2f(cut):
        def make(orig):
            def fwd(*a, **kw):
                o, lse = orig(*a, **kw)
                cut(o)
                return o, lse
            return fwd
        return make

    def k2kv(cut):
        def make(orig):
            def dkv(*a, **kw):
                dk, dv = orig(*a, **kw)
                cut(dk)
                cut(dv)
                return dk, dv
            return dkv
        return make

    def last_cols(t):         # a store guard 16 columns short
        t[..., -16:] = 0

    def last_rows(t):         # the last 128-row tile never launched
        t[..., -128:, :] = 0

    def k3f_no_carry(orig):   # every chunk after the first from zero state
        def fwd(x, dt, a, b, c, initial_state=None, *, chunk, **kw):
            out = list(orig(x, dt, a, b, c, initial_state, chunk=chunk,
                            **kw))
            y, S = out[0].clone(), x.shape[1]
            for i in range(chunk, S, chunk):
                part = (t[:, i:i + chunk].contiguous() for t in (x, dt, b, c))
                xs, dts, bs, cs = part
                y[:, i:i + chunk] = orig(xs, dts, a, bs, cs, chunk=chunk)[0]
            out[0] = y
            return tuple(out)
        return fwd

    def k3b_last_block(orig):  # each chunk's last 64-row block of dx lost
        def bwd(x, dt, a, b, c, states, dy, dfinal, *, chunk, **kw):
            grads = orig(x, dt, a, b, c, states, dy, dfinal, chunk=chunk,
                         **kw)
            S = x.shape[1]
            for end in range(min(chunk, S), S + chunk, chunk):
                end = min(end, S)
                grads[0][:, max(end - 64, 0):end] = 0
            return grads
        return bwd

    return {
        "k2f_o_last_16_columns": (FA, "flash_attention_fwd", k2f(last_cols)),
        "k2f_o_last_q_tile": (FA, "flash_attention_fwd", k2f(last_rows)),
        "k2kv_last_16_columns": (FA, "flash_attention_bwd_dkv",
                                 k2kv(last_cols)),
        "k2kv_last_k_tile": (FA, "flash_attention_bwd_dkv",
                             k2kv(last_rows)),
        "k3f_state_not_carried": (K3, "ssd_scan_fwd", k3f_no_carry),
        "k3b_dx_last_block": (K3, "ssd_scan_bwd", k3b_last_block)}


def run(torch, dev="cuda", **shape) -> None:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as K3

    def reading(label, cfg, params, batch, ref, names):
        loss, norm, grads = CS.first_step(torch, cfg, params, batch,
                                          keep=True)
        CS.sync(torch, dev)
        print(json.dumps({label: {
            "loss": loss, "grad_norm": norm,
            "loss_rel_err": abs(loss - ref[0]) / abs(ref[0]),
            "grad_norm_rel_err": abs(norm - ref[1]) / abs(ref[1]),
            **_grads_err(grads, ref[2], names)}}), flush=True)

    for seed in (5, 6):
        _, cfg, params, data = CS.hybrid_inputs(torch, dev, seed=seed,
                                                steps=1, **shape)
        names = CS._leaf_paths(params)
        ref = CS.first_step(torch, cfg.replace(kernel_vjp_mode="ref"),
                            params, data[0], keep=True)
        print(json.dumps({f"plain_seed{seed}": {"loss": ref[0],
                                                "grad_norm": ref[1]}}),
              flush=True)
        reading(f"sound_seed{seed}", cfg, params, data[0], ref, names)
        if seed == 5:
            for name, (module, attr, make) in faults(FA, K3).items():
                orig = getattr(module, attr)
                setattr(module, attr, make(orig))
                try:
                    reading(name, cfg, params, data[0], ref, names)
                finally:
                    setattr(module, attr, orig)
        del params, data, ref
        if dev == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    torch, _ = CS.setup()
    run(torch)
