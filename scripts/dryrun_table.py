"""Format the dry run's records (``repro_torch.launch.dryrun``) as the
markdown table of PERF.md: a row per (arch, shape), each figure as
"16 x 16 / 2 x 16 x 16".

    PYTHONPATH=src python scripts/dryrun_table.py DIR_16x16 DIR_2x16x16

Per device: the peak and the arguments (GiB, MemTracker and the local
state and inputs), FLOPs (FlopCounterMode: products only), bytes (every
op's inputs and outputs), collective bytes by mesh axis (MB), and the
roofline's bottleneck. Counted by torch on fake tensors with the H100
datasheet constants: nothing here is measured.
"""
import glob
import json
import os
import sys

GIB = 2 ** 30


def _load(d):
    out = {}
    for f in glob.glob(os.path.join(d, "*.json")):
        r = json.load(open(f))
        out[r["arch"], r["shape"]] = r
    return out


def _fmt(x, unit=1.0, digits=3):
    return f"{x / unit:.{digits}g}"


def _cell(r, what):
    if r is None:
        return "—"
    if r["status"] != "ok":
        return r["status"]
    if what == "peak":
        return _fmt(r["memory"]["peak_per_device"], GIB)
    if what == "args":
        return _fmt(r["memory"]["argument_bytes"], GIB)
    if what == "flops":
        return f"{r['flops_per_device']:.3g}"
    if what == "bytes":
        return f"{r['bytes_per_device']:.3g}"
    if what == "coll":
        by = r["collectives"]["by_axis"]
        return ", ".join(f"{a} {_fmt(v['total'], 1e6)}"
                         for a, v in sorted(by.items())) or "0"
    return r["bottleneck"].replace("_s", "")


def main(one, two):
    a, b = _load(one), _load(two)
    print("| arch | shape | peak GiB | args GiB | FLOP/dev | bytes/dev "
          "| collective MB by axis | bound |")
    print("|---|---|---|---|---|---|---|---|")
    for key in sorted(set(a) | set(b)):
        ra, rb = a.get(key), b.get(key)
        if (ra or rb)["status"] == "skipped":
            continue
        cells = [f"{_cell(ra, w)} / {_cell(rb, w)}" for w in
                 ("peak", "args", "flops", "bytes", "coll", "bound")]
        print(f"| {key[0]} | {key[1]} | " + " | ".join(cells) + " |")
    skipped = sorted(k[0] for k, r in a.items() if r["status"] == "skipped")
    print(f"\nlong_500k skipped (pure full attention): {', '.join(skipped)}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
