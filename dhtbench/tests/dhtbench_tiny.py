"""Helpers of the benchmark's CPU tests: the import paths, and each cell
cut to a size the CPU runs in seconds (the same code, a smaller table,
fewer records and rows)."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for _p in (str(BENCH), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from dhtb import cell, manifest  # noqa: E402

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]

TINY = {
    "kv_mix": dict(records=2048, round_rows=512, warm_rounds=2,
                   sample_every=1),
}


def tiny_spec(name: str, bench: Path = BENCH, man: dict | None = None,
              **traffic) -> dict:
    man = manifest.load_manifest(bench.parent / "BENCHMARK.json") \
        if man is None else man
    spec = copy.deepcopy(manifest.cell_spec(man, name, bench))
    spec["config"]["dht"]["buckets_per_shard"] = 1 << 10
    spec["traffic"].update(TINY[spec["kind"]], **traffic)
    return spec


def run_tiny(spec: dict, seed: int = 3_000_000_019, seconds: float = 0.5,
             trace: bool = False):
    return cell.run(spec, seed, seconds, trace, "cpu", time.perf_counter())
