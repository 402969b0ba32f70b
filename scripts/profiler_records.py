"""Count the kernel records torch.profiler keeps of 20 K3 forward calls.

    python3 scripts/profiler_records.py

Builds the kernels through ``chip_smoke.setup()``, then profiles 20 calls
of K3f at two of ``chip_smoke.K3_SHAPES`` (the float32 ragged, grouped
shape on the simt route; mamba2-130m's train shape in bfloat16 on the
sm90 route, three kernels a call) six times in each of four modes: CPU
and CUDA activities or CUDA alone, each with or without 20 ms of host
sleep before the calls and after the synchronize. Prints one JSON line a
run (records kept by kernel name; the first and last device and host
times in the profile's own clock) and last a summary of the records kept
a run by shape and mode. Needs one CUDA card.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as C  # noqa: E402

torch, smi = C.setup()
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels import ssd_scan as K3  # noqa: E402


def run(fn, pad, acts, calls=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if pad:
            time.sleep(pad)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        if pad:
            time.sleep(pad)
    kept = {e.key: e.count for e in prof.key_averages()
            if "ssd_" in e.key and "kernel" in e.key}
    ev = prof.events()
    dev = [e for e in ev if "CUDA" in str(getattr(e, "device_type", ""))
           and "ssd_" in e.name]
    cpu = [e for e in ev if "CUDA" not in str(getattr(e, "device_type", ""))]
    span = {}
    if dev and cpu:
        span = {"dev_first_start_us": min(e.time_range.start for e in dev),
                "dev_last_end_us": max(e.time_range.end for e in dev),
                "cpu_first_us": min(e.time_range.start for e in cpu),
                "cpu_last_us": max(e.time_range.end for e in cpu)}
    return kept, span


BOTH = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
ONLY = [ProfilerActivity.CUDA]
out = []
for name, B, S, H, P, G, N, cl, dname, init in (C.K3_SHAPES[6],
                                                C.K3_SHAPES[0]):
    dtype = getattr(torch, dname)
    x, dt, a, b, c, s0, dy, dfin = C.k3_inputs(torch, B, S, H, P, G, N,
                                               dtype, init, 1)
    fwd = lambda: K3.ssd_scan_fwd(x, dt, a, b, c, s0, chunk=cl,  # noqa: E731
                                  return_chunk_states=True)
    for rep in range(6):
        for mode, pad, acts in (("both_nopad", 0, BOTH),
                                ("both_pad", 0.02, BOTH),
                                ("cuda_nopad", 0, ONLY),
                                ("cuda_pad", 0.02, ONLY)):
            kept, span = run(fwd, pad, acts)
            out.append({"shape": name, "dtype": dname, "rep": rep,
                        "mode": mode, "kept": kept, **span})
            print(json.dumps(out[-1]), flush=True)
summary = {}
for r in out:
    key = " ".join((r["shape"], r["dtype"], r["mode"]))
    summary.setdefault(key, []).append(sum(r["kept"].values()))
print(json.dumps({"summary": summary}))
