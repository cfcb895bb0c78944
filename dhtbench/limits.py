"""Readings that the limits of ``correct`` are set from, on the card.

    python3 dhtbench/limits.py --workload <cell> --seeds 12 [--first-seed N] [--seconds 2]

For each seed, in one process: the cell's set-up at its own size, a
short window at its own load, then the numbers the reference compares,
for the program (the lower readings) and for the control, the reference
put in the program's place with one guarantee broken or in the precision
below the configuration's (the upper readings).  One JSON line a seed.
The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def readings(spec: dict, seed: int, seconds: float, device) -> dict:
    import torch

    from dhtb import cell, loop, manifest

    ref = manifest.load_module("reference", spec["kind"])
    pool, client = cell.prepare(spec, seed, device, time.perf_counter())
    win = loop.drive(client, seconds=seconds, window=True,
                     sampled=cell.sampled_fn(pool))
    log = client.log
    client.free()
    del client
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "rounds": win.rounds,
            "program": ref.check(spec["config"], pool, log, win.kept),
            "control": ref.check(spec["config"], pool, log, win.kept,
                                 control=True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2_200_000_001)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    from dhtb import manifest

    spec = manifest.cell_spec(manifest.load_manifest(), args.workload)
    for k in range(args.seeds):
        r = readings(spec, args.first_seed + 7919 * k, args.seconds, "cuda")
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
