"""Time the llama LLM DENSE path of two checkouts on one card, in turns.

    python3 scripts/ab_llm_epoch.py DIR_A DIR_B

For each checkout in the order A, B, B, A, a fresh process builds that
checkout's kernels and runs its ``chip_smoke.py`` phases ``setup``,
``llm_main_path`` and ``profile_llm_epoch`` (``dense_llm_oneshot.full()``:
two llama3.2-3b clients and a llama3.2-3b student at full width and
depth, bfloat16). Prints one JSON line per run: the step and epoch
seconds (host clock around work that ends in a synchronize), and the
profiled epoch's device busy time, idle share and K2 split. Needs one
CUDA card; compare the two checkouts only within one call.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

PHASES = ("import chip_smoke as CS; torch, _ = CS.setup(); "
          "_, ctx = CS.llm_main_path(torch); CS.profile_llm_epoch(torch, ctx)")


def run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", PHASES], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    lines = {}
    for ln in proc.stdout.splitlines():
        if ln.startswith("{"):
            obj = json.loads(ln)
            lines.update(obj)
    if proc.returncode or "profile_llm_epoch" not in lines:
        sys.exit(f"{checkout}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    main, prof = lines["llm_main_path"], lines["profile_llm_epoch"]
    return {"checkout": checkout, "device": lines["setup"]["nvidia_smi"],
            "seconds": main["seconds"],
            "seconds_per_epoch_last": main["seconds_per_epoch_last"],
            "fwd_routes": main.get("fwd_routes"),
            "bwd_routes": main.get("bwd_routes"),
            "profiled_epoch_ms": prof["epoch_ms"],
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "k2_ms": prof["k2_ms"],
            "k2_ms_by_route": prof.get("k2_ms_by_route"),
            "top_host_ops_self_ms_count": prof["top_host_ops_self_ms_count"]}


def main() -> None:
    if len(sys.argv) != 3 or not all(os.path.isfile(os.path.join(
            d, "chip_smoke.py")) for d in sys.argv[1:]):
        sys.exit(__doc__)
    a, b = sys.argv[1:]
    for checkout in (a, b, b, a):
        print(json.dumps(run(checkout)), flush=True)


if __name__ == "__main__":
    main()
