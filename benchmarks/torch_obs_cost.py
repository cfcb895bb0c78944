#!/usr/bin/env python3
"""What recording costs an engine round of the port, on one card.

    python benchmarks/torch_obs_cost.py [--rounds 60] [--buckets 2097152]

Builds the kernels, fills a table of 8 shards x ``--buckets`` buckets
with 2^16 keys and runs 2^16-key read rounds (``dht_issue`` +
``dht_commit``) with recording on and under ``obs.metrics.disabled()``,
in blocks of 10 alternating, each round between two
``torch.cuda.synchronize`` calls.  It times the host halves of the
self-record where they run: the lane pack of the issue half
(``obs.trace._HostLanes``), the read of the pinned copy at commit
(``_HostLanes.get``) and the flush (``record_round``).  Then one
``torch.profiler`` window of 5 rounds in each mode counts the CUDA
kernels and the launches.  Prints one JSON line and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_KEYS = 1 << 16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=60,
                    help="timed read rounds a mode (blocks of 10)")
    ap.add_argument("--buckets", type=int, default=1 << 21,
                    help="buckets a shard (8 shards)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (DHTConfig, dht_commit, dht_create,
                                  dht_issue, dht_write, read_ops)
    from repro_torch.core import op_engine
    from repro_torch.kernels import build
    from repro_torch.obs import metrics, trace

    if not torch.cuda.is_available():
        print("torch_obs_cost: no CUDA device", file=sys.stderr)
        return 1
    build.build_all()
    cfg = DHTConfig(key_words=20, val_words=26, n_shards=8,
                    buckets_per_shard=args.buckets, n_probe=6)
    st = dht_create(cfg, device="cuda")
    gen = torch.Generator().manual_seed(1)
    keys = torch.randint(-2**31, 2**31, (N_KEYS, 20), generator=gen,
                         dtype=torch.int64).to(torch.int32).cuda()
    vals = torch.randint(-2**31, 2**31, (N_KEYS, 26), generator=gen,
                         dtype=torch.int64).to(torch.int32).cuda()
    dht_write(st, keys, vals)
    torch.cuda.synchronize()

    # host timers around the three pieces of the self-record
    spent = {"pack": [], "get": [], "record": []}
    lanes_cls, record = trace._HostLanes, trace.record_round

    class Timed(lanes_cls):
        def __init__(self, *a, **k):
            t = time.perf_counter()
            super().__init__(*a, **k)
            spent["pack"].append(time.perf_counter() - t)

        def get(self):
            t = time.perf_counter()
            out = super().get()
            spent["get"].append(time.perf_counter() - t)
            return out

    def timed_record(*a, **k):
        t = time.perf_counter()
        record(*a, **k)
        spent["record"].append(time.perf_counter() - t)

    trace._HostLanes = Timed
    op_engine.obs_trace.record_round = timed_record

    def rounds(on: bool, n: int) -> list:
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if on:
                dht_commit(dht_issue(st, read_ops(keys), kinds=("read",)))
            else:
                with metrics.disabled():
                    dht_commit(dht_issue(st, read_ops(keys),
                                         kinds=("read",)))
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return out

    try:
        rounds(True, 5)
        rounds(False, 5)
        for v in spent.values():
            v.clear()
        on, off = [], []
        for i in range(max(args.rounds // 10, 1)):
            for mode in ((True, False) if i % 2 == 0 else (False, True)):
                (on if mode else off).extend(rounds(mode, 10))
        kernels, launches = {}, {}
        for mode in (True, False):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                rounds(mode, 5)
            ka = prof.key_averages()
            name = "on" if mode else "off"
            kernels[name] = sum(e.count for e in ka
                                if e.device_type.name == "CUDA")
            launches[name] = sum(e.count for e in ka
                                 if e.key == "cudaLaunchKernel")
    finally:
        trace._HostLanes = lanes_cls
        op_engine.obs_trace.record_round = record

    def med(x):
        return statistics.median(x)

    print(json.dumps({
        "rounds_a_mode": len(on), "read_ms_on_median": med(on),
        "read_ms_off_median": med(off),
        "read_ms_on_quartiles": statistics.quantiles(on, n=4),
        "read_ms_off_quartiles": statistics.quantiles(off, n=4),
        "host_ms_median": {k: med(v) * 1e3 for k, v in spent.items()},
        "cuda_kernels_per_round": {k: v / 5 for k, v in kernels.items()},
        "launches_per_round": {k: v / 5 for k, v in launches.items()}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
