#!/usr/bin/env python3
"""What recording costs an engine round of the port, on one card.

    python benchmarks/torch_obs_cost.py [--rounds 60] [--buckets 2097152]
        [--span-rows 1048576] [--cell poet-kv.ycsb-b.uniform
        --cell-runs 3]

Builds the kernels, fills a table of 8 shards x ``--buckets`` buckets
with 2^16 keys and runs 2^16-key read rounds (``dht_issue`` +
``dht_commit``) with recording on and under ``obs.metrics.disabled()``,
in blocks of 10 alternating, each round between two
``torch.cuda.synchronize`` calls.  It times the host halves of the
self-record where they run: the lane pack of the issue half
(``obs.trace._HostLanes``), the read of the pinned copy at commit
(``_HostLanes.get``) and the flush (``record_round``).  Then one
``torch.profiler`` window of 5 rounds in each mode counts the CUDA
kernels and the launches.

Then the device spans' host work, on the same table, recording on.  A
round's span calls in the engine's order with no engine work between
them (``begin_round``, the phase marks, the ``write`` span, timed host
reads of the capacity, two write flags and the commit's wait, the
elapsed reads and flush at commit), timed against the same reads and
event made plainly: the new host work a round, in us.  Its pieces: a
timing event's record through the driver (what a pooled span event
costs) and through ``torch.cuda.Event``, afresh and reused, and an
elapsed read each way; the observes of the ``device_us`` lanes in
``record_round``.  And a 95/5 round's wall time with the device spans
against without them (``begin_round`` made to return None, as a round
off the card), rounds interleaved in blocks, at ``--span-rows`` rows
and at 2^12, where the card finishes each kernel before the next launch
and the difference is all host work.

With ``--cell`` it runs that benchmark cell (``dhtbench/run.py``, for
``BENCHMARK.json``'s ``run_seconds``) ``--cell-runs`` times with
recording on and as often with ``OBS_DISABLED=1``, alternating, a seed
each pair, and reports each mode's ``kv_ops_per_s`` and
``round_ms_p95``: medians and spreads (quartile distance over the
median).  Prints one JSON line and the card's name and power limit.
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
SPAN_ROUNDS = 40        # timed 95/5 rounds a side, spans on and off


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=60,
                    help="timed read rounds a mode (blocks of 10)")
    ap.add_argument("--buckets", type=int, default=1 << 21,
                    help="buckets a shard (8 shards)")
    ap.add_argument("--span-rows", type=int, default=1 << 20,
                    help="rows of the 95/5 rounds that time the device "
                         "spans' host work (0: skip)")
    ap.add_argument("--cell", default=None,
                    help="a dhtbench cell to run on and off (default: none)")
    ap.add_argument("--cell-runs", type=int, default=3)
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

    spans = span_cost(st, args.span_rows) if args.span_rows else None
    del st
    torch.cuda.empty_cache()
    cell = cell_on_off(args.cell, args.cell_runs) if args.cell else None

    print(json.dumps({
        "rounds_a_mode": len(on), "read_ms_on_median": med(on),
        "read_ms_off_median": med(off),
        "read_ms_on_quartiles": statistics.quantiles(on, n=4),
        "read_ms_off_quartiles": statistics.quantiles(off, n=4),
        "host_ms_median": {k: med(v) * 1e3 for k, v in spent.items()},
        "cuda_kernels_per_round": {k: v / 5 for k, v in kernels.items()},
        "launches_per_round": {k: v / 5 for k, v in launches.items()},
        "span_host_us_per_round": spans, "cell_on_off": cell}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


def span_cost(st, rows: int) -> dict:
    """The device spans' host work, recording on, in us: a round's span
    calls against the same reads made plainly, their pieces, and 95/5
    rounds of ``rows`` rows and of 2^12 with the spans and without."""
    import torch

    from repro_torch.core import dht_execute, dht_write, mixed_ops
    from repro_torch.obs import metrics, trace

    gen = torch.Generator().manual_seed(2)
    keys = torch.randint(-2**31, 2**31, (rows, 20), generator=gen,
                         dtype=torch.int64).to(torch.int32).cuda()
    vals = torch.randint(-2**31, 2**31, (rows, 26), generator=gen,
                         dtype=torch.int64).to(torch.int32).cuda()
    op = (torch.rand(rows, generator=gen) < 0.05).to(torch.int32).cuda()
    dht_write(st, keys, vals)
    torch.cuda.synchronize()
    dev, flag = keys.device, torch.ones((), dtype=torch.bool).cuda()

    def spanned():
        rs = trace.begin_round(dev)
        trace.host_read("capacity", bool, flag)
        rs.phase("dispatch")
        rs.phase("apply")
        with trace.device_span("write"):
            trace.host_read("write_flag", bool, flag)
            trace.host_read("write_flag", bool, flag)
        rs.phase("collect")
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(rs.stream)
        rs.close()
        rs.commit()
        trace.host_read("commit", torch.cuda.Event.synchronize, ev, rs)
        lanes = rs.lanes(ev)
        rs.close()
        return lanes

    def plain():
        bool(flag), bool(flag), bool(flag)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()

    def us(fn, n=2000):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e6

    reg = metrics.MetricRegistry()
    prev = metrics.set_registry(reg)
    times: dict = {"spanned": [], "plain": []}
    try:
        lanes = spanned()
        for _ in range(20):                     # interleaved blocks
            times["spanned"].append(us(spanned, 100))
            times["plain"].append(us(plain, 100))
    finally:
        metrics.set_registry(prev)
    with_, without = (statistics.median(times[k])
                      for k in ("spanned", "plain"))
    out = {"round_span_calls": with_ - without, "spanned": with_,
           "plain": without, "device_lanes": lanes}

    # the pieces: a timing event's record and an elapsed read, through
    # the driver and through torch.cuda.Event
    record, elapsed, _, ptr = trace._driver()
    stream = torch.cuda.current_stream()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record(stream)
    b.record(stream)
    torch.cuda.synchronize()
    raw = stream.cuda_stream
    out["record_driver"] = us(lambda: record(a.cuda_event, raw))
    out["record_torch_reused"] = us(lambda: a.record(stream))
    out["record_torch_fresh"] = us(
        lambda: torch.cuda.Event(enable_timing=True).record(stream))
    b.record(stream)
    torch.cuda.synchronize()
    out["elapsed_driver"] = us(
        lambda: elapsed(ptr, a.cuda_event, b.cuda_event))
    out["elapsed_torch"] = us(lambda: a.elapsed_time(b))

    # record_round's observes of the device lanes: a round's lanes
    # flushed with and without them into a scratch registry
    dht_execute(st, mixed_ops(op, keys, vals), kinds=("read", "write"))
    last = trace.get_tracer().events()[-1].stats
    bare = {k: v for k, v in last.items() if not k.startswith("device_us.")}
    prev = metrics.set_registry(metrics.MetricRegistry())
    saved = list(trace.get_tracer().events())
    try:
        out["record_round_observes"] = (
            us(lambda: trace.record_round("engine.read+write", last))
            - us(lambda: trace.record_round("engine.read+write", bare)))
    finally:
        metrics.set_registry(prev)
        trace.get_tracer().clear()
        for ev in saved:
            trace.get_tracer().record(ev)
    out["round_us_with_minus_without"] = {
        n: spans_on_off(st, op[:n], keys[:n], vals[:n])
        for n in (rows, 1 << 12)}
    out["rows"] = rows
    return out


def spans_on_off(st, op, keys, vals) -> dict:
    """Median wall time of a synchronous 95/5 round with the device spans
    and without them, and the difference, in us."""
    import torch

    from repro_torch.core import dht_execute, mixed_ops
    from repro_torch.obs import trace

    orig = trace.begin_round
    ops = mixed_ops(op, keys, vals)
    got: dict = {True: [], False: []}
    try:
        for i in range(2 * (SPAN_ROUNDS // 10 + 1)):
            on = i % 4 in (0, 3)                # on, off, off, on, ...
            trace.begin_round = orig if on else (lambda device: None)
            for j in range(10):
                torch.cuda.synchronize()
                t = time.perf_counter()
                dht_execute(st, ops, kinds=("read", "write"))
                if j >= 2:                      # past each block's first two
                    got[on].append((time.perf_counter() - t) * 1e6)
    finally:
        trace.begin_round = orig
    on, off = statistics.median(got[True]), statistics.median(got[False])
    return {"with": on, "without": off, "difference": on - off,
            "rounds_a_side": len(got[True])}


def cell_on_off(cell: str, runs: int) -> dict:
    """The cell's end-to-end metrics with recording on and with
    ``OBS_DISABLED=1``, alternating (on, off, off, on, ...), one seed a
    pair, each run the benchmark's ``run_seconds`` long."""
    import os

    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())[
        "run_seconds"]

    got: dict = {"on": {}, "off": {}}
    for i in range(runs):
        seed = 2**31 + 1013 * (i + 1)
        for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
            env = dict(os.environ)
            env.pop("OBS_DISABLED", None)
            if mode == "off":
                env["OBS_DISABLED"] = "1"
            out = subprocess.run(
                [sys.executable, "dhtbench/run.py", "--workload", cell,
                 "--seed", str(seed), "--seconds", str(seconds),
                 "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
                text=True, timeout=seconds + 600)
            if out.returncode != 0:
                raise RuntimeError(out.stderr[-2000:])
            line = json.loads(out.stdout.strip().splitlines()[-1])
            for name in ("kv_ops_per_s", "round_ms_p95"):
                got[mode].setdefault(name, []).append(
                    line["metrics"][name]["value"])
            got[mode].setdefault("correct", []).append(line["correct"])

    def spread(xs):
        if len(xs) < 2:
            return None
        q = statistics.quantiles(xs, n=4)
        return (q[2] - q[0]) / statistics.median(xs)

    return {mode: {name: {"median": statistics.median(xs), "spread":
                          spread(xs), "all": xs} if name != "correct"
                   else all(xs) for name, xs in vals.items()}
            for mode, vals in got.items()}


if __name__ == "__main__":
    raise SystemExit(main())
