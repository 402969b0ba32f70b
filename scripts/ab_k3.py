"""Time K3's kernel rows of two checkouts on one card, in turns.

    python3 scripts/ab_k3.py [--dtype float32] DIR_A DIR_B

For each checkout in the order A, B, B, A, a fresh process builds that
checkout's kernels and runs its ``chip_smoke.py`` phases ``setup`` and
``k3_phase`` on the ``K3_SHAPES`` rows of ``--dtype`` at P 64 (the rows
the ``sm90`` route takes). Prints one JSON line per run: each row's
wrapper and device time (ms), its device time by phase, its bound share
and whether it agreed with the plain versions. Needs one CUDA card;
compare the two checkouts only within one call.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

PHASES = ("import chip_smoke as CS; torch, _ = CS.setup(); "
          "CS.k3_phase(torch, shapes=[s for s in CS.K3_SHAPES "
          "if s[8] == {dtype!r} and s[4] == 64])")


def run(checkout: str, dtype: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", PHASES.format(dtype=dtype)],
                          cwd=checkout, capture_output=True, text=True,
                          timeout=900)
    rows, smi = [], None
    for ln in proc.stdout.splitlines():
        if not ln.startswith("{"):
            continue
        obj = json.loads(ln)
        if "setup" in obj:
            smi = obj["setup"].get("nvidia_smi")
        if "kernel_check" in obj:
            r = obj["kernel_check"]
            rows.append({"kernel": r["name"], "shape": r["shape"]["name"],
                         "route": r["route"], "ok": r["ok"], "ms": r["ms"],
                         "device_ms": r["device_ms"],
                         "by_phase": r.get("device_ms_by_phase"),
                         "bound_share": r["bound_share_of_device_ms"]})
    if proc.returncode or not rows:
        sys.exit(f"{checkout}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return {"checkout": checkout, "device": smi, "rows": rows}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("a")
    ap.add_argument("b")
    args = ap.parse_args()
    for checkout in (args.a, args.b, args.b, args.a):
        print(json.dumps(run(checkout, args.dtype)), flush=True)


if __name__ == "__main__":
    main()
