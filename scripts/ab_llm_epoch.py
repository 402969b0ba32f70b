"""Time the LLM DENSE path of two checkouts on one card, in turns.

    python3 scripts/ab_llm_epoch.py [--ssm] DIR_A DIR_B

For each checkout in the order A, B, B, A, a fresh process builds that
checkout's kernels and runs its ``chip_smoke.py`` phases ``setup``,
``llm_main_path`` and ``profile_llm_epoch`` (``dense_llm_oneshot.full()``:
two llama3.2-3b clients and a llama3.2-3b student at full width and
depth, bfloat16). With ``--ssm``: the SSM LLM path instead
(``full_ssm()``: three mamba2-130m, bfloat16) and its profiled epoch,
then ``ssm_serve`` (zamba2-7b at full width and depth, 16 requests, 8
slots) and its profiled decode step. Prints one JSON line per run: the
step and epoch seconds (host clock around work that ends in a
synchronize), the profiled epoch's device busy time, idle share and its
K2 or K3 split (each kernel's time by route where the checkout reports
it), and with ``--ssm`` the serving seconds. Needs one CUDA
card; compare the two checkouts only within one call.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

PHASES = ("import chip_smoke as CS; torch, _ = CS.setup(); "
          "_, ctx = CS.llm_main_path(torch); CS.profile_llm_epoch(torch, ctx)")
SSM_PHASES = (
    "import chip_smoke as CS; torch, _ = CS.setup(); "
    "from repro_torch.launch import dense_llm_oneshot as ONE; "
    "_, ctx = CS.llm_main_path(torch, oc=ONE.full_ssm(), label='ssm_llm'); "
    "CS.profile_llm_epoch(torch, ctx, label='profile_ssm_llm_epoch'); "
    "del ctx; torch.cuda.empty_cache(); "
    "CS.serve_main_path(torch, arch='zamba2-7b', label='ssm_serve')")


def run(checkout: str, ssm: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c", SSM_PHASES if ssm
                           else PHASES], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    lines = {}
    for ln in proc.stdout.splitlines():
        if ln.startswith("{"):
            obj = json.loads(ln)
            lines.update(obj)
    pre = "ssm_" if ssm else ""
    last = "profile_ssm_serve_decode" if ssm else "profile_llm_epoch"
    if proc.returncode or last not in lines:
        sys.exit(f"{checkout}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    main = lines[f"{pre}llm_main_path"]
    prof = lines[f"profile_{pre}llm_epoch"]
    out = {"checkout": checkout, "device": lines["setup"]["nvidia_smi"],
            "seconds": main["seconds"],
            "seconds_per_epoch_last": main["seconds_per_epoch_last"],
            "fwd_routes": main.get("fwd_routes"),
            "bwd_routes": main.get("bwd_routes"),
            "profiled_epoch_ms": prof["epoch_ms"],
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "k2_ms": prof["k2_ms"],
            "k2_ms_by_route": prof.get("k2_ms_by_route"),
            "k3_ms": prof.get("k3_ms"),
            "k3f_ms_by_route": prof.get("k3f_ms_by_route"),
            "k3b_ms_by_route": prof.get("k3b_ms_by_route"),
            "k3_routes": {k: main.get(k) for k in ("k3f_routes",
                                                   "k3b_routes")},
            "kernels_launched": prof.get("kernels_launched"),
            "top_host_ops_self_ms_count": prof["top_host_ops_self_ms_count"]}
    if ssm:
        serve, dec = lines["ssm_serve"], lines["profile_ssm_serve_decode"]
        out["ssm_serve"] = {k: serve[k] for k in (
            "wall_s", "prefill_s", "decode_s", "decode_steps",
            "ms_per_decode_step", "tok_per_s")}
        out["ssm_serve"]["k3f_routes"] = serve.get("k3f_routes")
        out["ssm_serve_decode_device_busy_ms"] = dec["device_busy_ms"]
    return out


def main() -> None:
    args = sys.argv[1:]
    ssm = args[:1] == ["--ssm"]
    dirs = args[1:] if ssm else args
    if len(dirs) != 2 or not all(os.path.isfile(os.path.join(
            d, "chip_smoke.py")) for d in dirs):
        sys.exit(__doc__)
    a, b = dirs
    for checkout in (a, b, b, a):
        print(json.dumps(run(checkout, ssm)), flush=True)


if __name__ == "__main__":
    main()
