"""The dry run's records as a table: per device argument, temp and output
GB, whether arguments and temp fit one H100's 80 GB, the counted FLOPs
and bytes, the collective GB by kind, and the roofline's three terms on
the H100's constants (``roofline/analysis.py``); then the counts of ok,
skipped and failed cells.  No device is used.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
    PYTHONPATH=src python benchmarks/torch_dryrun_table.py DIR [--arch A ...]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.roofline.analysis import analyze

DEVICE_BYTES = 80e9        # one H100 80GB HBM3


def rows(records: list[dict]) -> list[str]:
    out = ["| cell | arg GB | temp GB | fits 80 GB | TFLOP | bytes TB | "
           "all-gather / reduce-scatter / all-reduce / all-to-all GB | "
           "compute s | memory s | collective s | bottleneck | useful |",
           "| --- " * 12 + "|"]
    for c in records:
        if not c.get("ok"):
            continue
        m, cost = c["memory"], c["cost_per_device"]
        coll = c["collective_bytes_per_device"]
        roof = analyze(c, c["chips"], c["model_flops"])
        gb = " / ".join(f"{coll.get(k, 0) / 1e9:.4g}" for k in
                        ("all_gather", "reduce_scatter", "all_reduce",
                         "all_to_all"))
        fits = m["argument_bytes"] + m["temp_bytes"] <= DEVICE_BYTES
        out.append(
            f"| {c['arch']} {c['shape']} {c['mesh']} "
            f"| {m['argument_bytes'] / 1e9:.4g} | {m['temp_bytes'] / 1e9:.4g} "
            f"| {'yes' if fits else 'no'} | {cost['flops'] / 1e12:.4g} "
            f"| {cost['bytes accessed'] / 1e12:.4g} | {gb} "
            f"| {roof.t_compute:.4g} | {roof.t_memory:.4g} "
            f"| {roof.t_collective:.4g} | {roof.bottleneck} "
            f"| {roof.useful_ratio:.3g} |")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", nargs="?", default="results/dryrun_torch")
    ap.add_argument("--arch", nargs="*", default=None)
    args = ap.parse_args()
    records = [json.loads(p.read_text())
               for p in sorted(Path(args.dir).glob("*.json"))]
    if args.arch:
        records = [c for c in records if c["arch"] in args.arch]
    print("\n".join(rows(records)))
    ok = sum(bool(c.get("ok")) for c in records)
    skipped = sum(bool(c.get("skipped")) for c in records)
    print(f"{len(records)} cells: {ok} ok, {skipped} skipped, "
          f"{len(records) - ok - skipped} failed")
    for c in records:
        if not c.get("ok") and not c.get("skipped"):
            print(f"failed {c['arch']} {c['shape']} {c['mesh']}: {c['error']}")


if __name__ == "__main__":
    main()
