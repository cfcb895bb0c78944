#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --faults-uniform-ids N   # phase 11 (a) alone

Run from the root of a checkout.  It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` with nvcc, holds each kernel against its
plain PyTorch version on the card, drives the main paths (the lock-free
DHT at full size, key rounding, the POET surrogate twin, the
neighbourhood-interpolation query, the L1 tier, the pipeline, elastic
membership and online resharding, replication with crash failover and
repair, the multi-rank backend, the telemetry, and gemma3-12b prefill
and decode),
checks the results, and times every kernel.  One
JSON line per phase:

1. env     - card name and power limit (nvidia-smi), CUDA, device count;
2. build   - nvcc for sm_90a, one process per source, with ptxas reports;
3. kernels - every kernel against its plain version, bit for bit, on the
             inputs of a real full-size write and read round plus small
             edge cases (hash64 also at N = 2^16 and off the block, KW 1
             to the wrapper's limit, rows one word off alignment;
             stencil_keys at D 1/10/17, radius 0/1/3, coarse on and off,
             KW 7/20/23/2D, n 1/64/2,978, span 1, sig 1/3/4, on 0, -0,
             denormals, +-inf, nan and the F1 band; the rounding and
             stencil kernels are also held against their plain versions
             in phases 5 and 7, on the inputs those paths give them);
4. dht     - S=8 x B=2^21 buckets of 192 B (3.2 GB): seeded 2^16-key
             write, read, 95/5 mixed and migrate rounds; dropped must be 0,
             every read must hit, the checksum kernel must launch once per
             write pass; then the same stream at B=2^16 on the card and on
             the CPU must leave identical slab words;
4b. obs    - the telemetry (``repro_torch.obs``) on phase 4's table: (a)
             5 write, read and 95/5 rounds with recording on and off in
             turns (after an untimed pair): median ms and range of each,
             and the host syncs of each issue and commit half, which must
             be the engine's count in both modes (1 a read issue half; a
             write's 1 + its passes + 1 where they end early; 0 at
             commit); (b) the registry's counters against the sums of
             the stat lanes the caller saw, ``engine.fill_frac`` once a
             round; (c) the JSONL and Chrome exports complete, and the
             report's timeline of the last rounds; (d) with the fence on,
             the median bin/dispatch/apply/collect/commit ms of 5 read,
             write and get-or-put rounds (``obs_spans``); (e) the cost
             model fitted over rounds of 2^12..2^16 keys, every
             coefficient >= 0 (``obs_costmodel``);
5. keys    - make_keys (the round_sig kernel) on 2 M values spanning
             1e-30..1e30: kernel against plain on the card bit for bit,
             and the card against the CPU, where a mismatch is allowed
             only within 64 ulps of a power of ten (F1 in ROADMAP.md);
6. poet    - the POET twin at its default 50 x 150 grid with and without
             the DHT (steps cut to fit the time limit, the cut printed);
7. interp  - the neighbourhood query: (a) a bracketed round on the full
             table, 2,978 query centres whose +-1-step neighbours along
             dim 0 are stored, D = 10, radius 1 + coarse tier, so 65,516
             stencil probes in one round: every row must interpolate,
             within 5% of the stored function, and one more round under
             torch.profiler: its stencil_keys call must launch its kernel
             with no host-to-device copy and no sync; (b) the same
             construction at B=2^16 on the card and on the CPU through
             both forms of lookup_interpolate_or_compute: keys, found
             flags, provenance and slab words equal, outputs at rtol
             1e-5; (c) the POET twin with --interp beside phase 6's
             plain run;
8. l1      - the locality tier: (a) l1-full: the full table holding 2^20
             keys, an L1 of 1024 sets x 4 ways, 8 Zipf(1.1) and 8 uniform
             batches of 2^16 reads, 2^12 keys rewritten after every second
             batch; every cached read must equal the uncached read of the
             same table, with nothing dropped or mismatched, and the Zipf
             stream must hit the L1 after batch 0; (b) l1-ref: the
             reference benchmark's quick stream on the card and the CPU,
             equal batch by batch, meeting its gates (hit fraction >= 0.5,
             wire ratio >= 1.5 on Zipf); (c) modes-parity: the B=2^16
             stream in small write batches under the lock-free, fine and
             coarse schedules, slab words, codes, rounds and lock tokens
             equal card/CPU; (d) lookup_cached on 2^16 POET-shaped rows
             from 4,096 chemistry states, equal to lookup, the second call
             served from the L1;
9. pipeline - the issue/commit pipeline: (a) pipeline-full: the full
             table, POET's surrogate config (10 inputs, 13 outputs, sig
             3), a Zipf(1.1) and a uniform stream of 16 batches of 2^16
             rows through lookup_or_compute_pipelined at depth 1 and 2 on
             fresh tables: outputs, found flags, counts and slab digests
             equal, forwarding on the Zipf stream, nothing dropped or
             re-issued; the miss compute is a value function on the card
             plus a host stall modelled as 1.5 measured read+write
             rounds; the walls, the depth-2 read commits' overlap and the
             host syncs of each kind of issue half printed; (b)
             pipeline-parity: a depth-2 Zipf stream at B=2^16 in the
             three modes, card against CPU; (c) the POET twin with
             --pipeline beside phase 6's plain run;
10. elastic - membership and online resharding: (a) elastic-full:
             phase 4's table on a ring of 8 shards, filled with 2^22
             seeded entries in rounds of 2^16; shard 7 leaves and joins,
             the table grows to 16 shards step by step (rounds of 2^16
             rows, the reference's 256 cut to fit) with a dual-epoch read
             of 2^16 readable keys after every step (the first must hit
             the old epoch), then shrinks back to 8; after each change
             every entry readable after the fill reads back equal but
             those evicted_at_dest counts, the live count falls by
             exactly that, and part of the table moved; the grow's plan
             (hash64 over all 2^24 stored keys), first step and first
             dual read, and the shrink's plan (2^25 keys), kernel against
             plain; plan, migrate round, entries per second, the dual
             read beside a plain read (median of 5, in turns) and the
             peak memory printed; (b) elastic-parity: the same sequence at
             B=2^12 with 3,000 entries plus 64 surrogate rows, steps of
             256, with cached reads around the leave (the epoch flush)
             and lookup/lookup_or_interpolate(prev=) mid-grow, on the
             card and on the CPU: slab words, reads and stats equal;
11. faults - crash tolerance: (a) faults-full: phase 4's table with
             n_replicas=2 on a ring of 8 beside the same table at k=1;
             bench_crash.py's mix over the paper's 712,500 ids: 2^20
             Zipf(0.99) rows written in rounds of 2^16 (capacity 2^16)
             at k=1 and k=2 in turns, the crash of shard 2 (wiped),
             reads of every pre-crash row, 2^20 uniform rows written
             during the outage, the recovery, the availability gap, the
             repair plan and repair_run; gates: 0 extra dispatch rounds
             and wire_amp 2.0 against k=1, a healthy k=2 read moves k=1's
             wire words and makes no more host syncs in its issue half,
             no read fails over while the ring is healthy, every row
             readable before the crash is found during the outage with
             its value but those whose surviving copy was evicted before
             the crash, reads fail over, diff_after 0, no read fails over
             after the repair, and the acked keys lost no more than the
             copies evicted; one replicated write, outage read, plan and
             repair round held against the plain versions; (b)
             faults-parity: the same sequence at B=2^16 with 2^14 keys
             and an L1 read before and after the crash (its epoch
             fence), card against CPU: slab words, rows and counts equal.
             Sharded replication needs k <= S ranks, so at NCCL world
             size 1 it cannot run here;
12. sharded - the multi-rank backend on NCCL at world size 1 (one rank,
             one shard): (a) sharded-full: ShardedDHT with S=1 x
             B=2^24 (3.2 GB), rounds of 2^16 keys (write, read, 95/5
             mixed, migrate), a cached read (L1 1024 x 4) twice, a
             read_async/read_commit pair, lookup_or_compute twice and
             lookup_interpolate_or_compute(one_round=True) on 2,978
             bracketed centres through the group, and the fine and
             coarse modes at 2^10 writes; every kernel call of a write
             round, a read round (S*cap + n rows: the elided residue) and
             the second cached read held against its plain version; then
             each round against the virtual-shard backend with the same
             cfg on the card: outputs, found flags, codes and slab
             digests equal; a read's wire words are the prologue's 2*S;
             (b) the rounds timed in turns with the virtual backend,
             all_to_all_single by CUDA events, host syncs per issue half;
             (c) the server baseline at the same table size, 2^13 ops at
             width 24, beside one sharded round of the same ops; (d)
             ShardedDHT.create(ring=ring_create(1)): the four rounds
             equal to the virtual backend with the same ring, and
             apply_ring to the next epoch moves nothing and bumps the
             epoch; (e) telemetry at world 1 (B=2^20, a fresh registry):
             telemetry_snapshot() after a write and two reads against
             the lanes the wrappers returned, and the all-to-all words
             torch.profiler saw in one read beside its wire words;
13. lm     - gemma3-12b: (a) the local-attention kernel against its
             plain version at the prefill shape (B=2, S=4096, H=16, Hk=8,
             D=256, window 1024) in bf16 and float32 and at edge shapes,
             within local_attn_kernel.tolerance (f32 1e-5; bf16 one ulp
             at the output's scale); (b) lm-prefill: the full model (48
             layers, bf16, random weights from a seed) on 2 x 4096
             tokens, local_attention launched once per local layer (40),
             finite logits; (e) lm-serve: 2 x 256 prompt tokens
             teacher-forced through decode, the last position's logits
             against prefill's, then 32 greedy serve_step tokens; (c)
             lm-decode: one period (5 local + 1 global) at full width in
             float32, forward over 2 x 1280 tokens against 1280 decode
             steps (the ring buffer wraps) within 2e-2; (d) lm-parity:
             the reduced model on the card against the CPU, forward and
             40 decode steps at rtol/atol 1e-4;
14. timing - each kernel, its plain version and the nearest single
             PyTorch call at the main path's shapes, with CUDA events and
             a cold L2 before each launch, beside the byte bound (the
             local-attention kernel beside its operation bound); hash64
             and stencil_keys also traced (trace_cold): their own device
             time beside the event interval.

Then the ``kernels`` line (launch counts per phase, the launches made to
hold a kernel against its plain version left out; every kernel must
launch in every phase whose path calls it), the card's name and power
limit, and the result line.  With ``--faults-uniform-ids N`` only the
build and faults-full run, with the uniform half's ids below N; where
repair leaves copies missing, a ``faults_diff`` line gives, for that
pass and two more, the missing copies and those whose probe window on
the recovered shard is full of other keys.  Any failure raises and exits non-zero
before the result line; without a CUDA device, or without the
repository around this file, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
ALU_OPS_PER_S = 67e12          # H100 SXM non-tensor f32 rate, used for ALU ops
# sizes of the run (the main path's full size)
DEVICE = "cuda"
BIG_BUCKETS = 1 << 21          # per shard, 8 shards: 3.2 GB
SMALL_BUCKETS = 1 << 16        # the card/CPU parity stream
N_KEYS = 1 << 16               # requests per round
KEY_VALUES = 2_000_000         # values rounded on the card and the CPU
POET_STEPS = 20                # of the example's 50
DHT_REPS = 5                   # timed repeats of the 4-round stream
INTERP_CENTRES = 2978          # x 22 stencil entries = 65,516 probes
INTERP_REPS = 3                # timed repeats of the bracketed round
L1_UNIVERSE = 1 << 20          # keys on the full table in the l1 phase
L1_BATCHES = 8                 # read batches of N_KEYS per stream
L1_REWRITES = 1 << 12          # keys rewritten after every second batch
MODE_KEYS = 2048               # keys of the modes-parity stream
MODE_BATCH = 256               # its write batch (coarse: a round per write)
POET_STATES = 4096             # distinct chemistry states in l1 (d)
PIPE_BATCHES = 16              # batches of N_KEYS rows per pipeline stream
PIPE_ZIPF_IDS = 1 << 20        # Zipf(1.1) ids of the pipeline stream
PIPE_UNIFORM_IDS = 1 << 22     # uniform ids (nearly every row misses)
PIPE_STALL_RATIO = 1.5         # modelled solver stall / read+write round
PIPE_PARITY_ROWS = 1 << 12     # rows per batch of the card/CPU stream
PIPE_PARITY_BATCHES = 4
ELASTIC_KEYS = 1 << 22         # entries in the elastic phase's table
ELASTIC_BATCH = 1 << 16        # rows a migrate round (reference: 256)
ELASTIC_READS = 1 << 16        # keys of each dual read
ELASTIC_TIMING_REPS = 5        # dual and plain reads timed in turns
ELASTIC_PARITY_BUCKETS = 1 << 12
ELASTIC_PARITY_KEYS = 3000
ELASTIC_PARITY_BATCH = 256
FAULT_KEYS = 1 << 20           # faults-full: keys before the crash, and during
FAULT_BATCH = 1 << 16          # rows a write or repair round; the capacity
FAULT_ID_RANGE = 712_500       # bench_crash's ids (the paper's key range)
FAULT_VICTIM = 2
FAULT_PARITY_BUCKETS = 1 << 16
FAULT_PARITY_KEYS = 1 << 13    # keys a half of the card/CPU stream
FAULT_PARITY_BATCH = 1 << 11
SHARD_BUCKETS = 1 << 24        # sharded-full: one rank, one shard, 3.2 GB
SHARD_MODE_WRITES = 1 << 10    # fine/coarse (coarse: an exchange a write)
SHARD_REPS = 5                 # timed repeats, sharded and virtual in turns
OBS_REPS = 5                   # rounds a kind and mode in the obs phase
OBS_FIT_SIZES = (1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16)
OBS_SHARD_BUCKETS = 1 << 20    # the world-1 telemetry table (sharded (e))
SERVER_OPS = 1 << 13           # the server baseline's batch
SERVER_WIDTH = 24              # ops the server applies a round
LM_ARCH = "gemma3-12b"         # full width and depth (48 layers, bf16)
LM_BATCH = 2                   # prompts per call
LM_PREFILL = 4096              # prefill tokens per prompt
LM_DECODE = 1280               # lm-decode positions (> the 1024 window)
LM_PARITY_STEPS = 40           # lm-parity decode steps (reduced model)
LM_SERVE_PROMPT = 256          # lm-serve prompt tokens, teacher-forced
LM_SERVE_NEW = 32              # lm-serve greedy tokens
BF16_TFLOPS = 989e12           # H100 SXM dense bf16 tensor-core rate
TIMING_REPS = 20
# kernels whose own device time the timing phase reports beside the event
# interval (torch.profiler, ``trace_cold``)
TRACED = ("hash64", "stencil_keys", "round_sig", "l1_probe")
HEAD_START_CYCLES = 400_000    # ~0.2 ms of card time before each timed call
KERNEL_SOURCES = {
    "route_pack": ("src/repro_torch/kernels/csrc/route.cu",
                   "src/repro/kernels/route_kernel.py:51"),
    "route_unpack": ("src/repro_torch/kernels/csrc/route.cu",
                     "src/repro/kernels/route_kernel.py:97"),
    "hash64": ("src/repro_torch/kernels/csrc/hash.cu",
               "src/repro/kernels/hash_kernel.py:35"),
    "shard_apply": ("src/repro_torch/kernels/csrc/apply.cu",
                    "src/repro/kernels/apply_kernel.py:123"),
    "checksum": ("src/repro_torch/kernels/csrc/checksum.cu",
                 "src/repro/kernels/checksum_kernel.py:29"),
    "round_sig": ("src/repro_torch/kernels/csrc/round.cu",
                  "src/repro/kernels/round_kernel.py:29"),
    "stencil_keys": ("src/repro_torch/kernels/csrc/stencil.cu",
                     "src/repro/kernels/stencil_kernel.py:78"),
    "probe": ("src/repro_torch/kernels/csrc/probe.cu",
              "src/repro/kernels/probe_kernel.py:70"),
    "l1_probe": ("src/repro_torch/kernels/csrc/l1.cu",
                 "src/repro/kernels/l1_kernel.py:54"),
    "local_attention": ("src/repro_torch/kernels/csrc/local_attn.cu",
                        "src/repro/kernels/local_attn_kernel.py:76"),
}
# the phases whose path calls each kernel: each must launch it (every
# engine phase runs read and write passes)
ENGINE_PHASES = ("dht", "obs", "poet", "interp", "l1", "pipeline",
                 "elastic", "faults", "sharded")
KERNEL_PHASES = {
    "route_pack": ENGINE_PHASES, "route_unpack": ENGINE_PHASES,
    "hash64": ENGINE_PHASES, "shard_apply": ENGINE_PHASES,
    "checksum": ENGINE_PHASES, "probe": ENGINE_PHASES,
    "round_sig": ("keys", "poet", "interp", "l1", "pipeline", "elastic",
                  "sharded"),
    "stencil_keys": ("interp", "elastic", "sharded"),
    "l1_probe": ("l1", "elastic", "faults", "sharded"),
    "local_attention": ("lm",),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def words(gen, n: int, w: int, device):
    import torch

    x = torch.randint(-2**31, 2**31, (n, w), generator=gen, dtype=torch.int64)
    return x.to(torch.int32).to(device)


class Capture:
    """Records the arguments of every kernel call the port makes while
    active (the kernels still run), bound to positional order with the
    defaults filled in."""

    NAMES = tuple(KERNEL_SOURCES)

    def __init__(self, ops):
        self.ops = ops
        self.calls: dict[str, list] = {n: [] for n in self.NAMES}

    def __enter__(self):
        self.orig = {n: getattr(self.ops, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(self.ops, n, self._wrap(n))
        return self

    def _wrap(self, name):
        fn = self.orig[name]
        sig = inspect.signature(fn)

        def recorded(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            self.calls[name].append(bound.args)
            return fn(*args, **kwargs)
        return recorded

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.ops, n, fn)
        return False


class OutOfRange(tuple):
    """Kernel arguments with source indices before the first or past the
    last row, which the kernels clamp (their contract) and the plain
    versions do not take: ``plain`` holds them clamped."""

    def __new__(cls, args, plain):
        self = super().__new__(cls, args)
        self.plain = tuple(plain)
        return self


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the outputs' values; 0.0 only where every
    output is equal bit for bit (float outputs are compared by their
    bits first, so -0 against +0 or two nan payloads count)."""
    import torch

    outs_a = a if isinstance(a, tuple) else (a,)
    outs_b = b if isinstance(b, tuple) else (b,)
    err = 0.0
    for x, y in zip(outs_a, outs_b):
        check(x.shape == y.shape and x.dtype == y.dtype, "output shape/type")
        if not x.numel():
            continue
        if x.dtype.is_floating_point:
            if torch.equal(x.view(torch.int32), y.view(torch.int32)):
                continue
            d = (x.double() - y.double()).abs().nan_to_num(float("inf"))
            err = max(err, float(d.max()) or float("inf"))
        else:
            d = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
            err = max(err, float(d))
    return err


def kernel_vs_plain(name, fn_kernel, fn_plain, args) -> float:
    import torch

    a = fn_kernel(*args)
    torch.cuda.synchronize()
    b = fn_plain(*getattr(args, "plain", args))
    torch.cuda.synchronize()
    err = max_abs_err(a, b)
    check(err == 0.0, f"{name}: kernel differs from its plain version "
                      f"(max abs err {err})")
    return err


def time_cold(fn, args, reps: int | None = None, warmup: int = 3,
              dirty: bool = True) -> float:
    """Median ms of one call, each launched into a cold L2 (a 256 MB
    buffer is overwritten before it, or with ``dirty=False`` read, which
    leaves no dirty lines to write back), timed with CUDA events.  A
    ~0.2 ms spin on the card between the flush and the start event lets
    the host enqueue the call before the card reaches it, so the
    wrapper's host time is not counted."""
    import torch

    reps = TIMING_REPS if reps is None else reps
    flush = torch.ones(64 << 20, dtype=torch.int32, device=DEVICE)
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(reps):
        if dirty:
            flush.zero_()
        else:
            flush.sum()
        torch.cuda._sleep(HEAD_START_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_events(run):
    """The events of ``run()`` under torch.profiler (CPU and CUDA
    activities, CUPTI), the card synchronised before the profile ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return prof.events()


def range_contents(events, label: str) -> list:
    """What each host range named ``label`` (``record_function``) holds:
    the device activities launched from inside it (kernels and copies:
    calls and ms by name), the CUDA runtime calls made inside it, its host
    ms, and the counts that matter for a kernel wrapper: host-to-device
    copies, memcpy calls and synchronisations."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    gpu = [e for e in events if e.device_type != cpu]
    out = []
    for r in events:
        if r.name != label or r.device_type != cpu:
            continue
        t0, t1 = r.time_range.start, r.time_range.end
        device, runtime, launched = {}, {}, set()
        for e in events:
            if (e.device_type != cpu or e.time_range.start < t0
                    or e.time_range.end > t1):
                continue
            if e is not r and e.name.startswith("cu"):
                runtime[e.name] = runtime.get(e.name, 0) + 1
                launched.add(e.id)
        # a device activity shares its CUPTI correlation id with the
        # runtime call that issued it (a kernel launched through ctypes
        # has no PyTorch op to be attached to)
        for e in gpu:
            if e.id in launched:
                calls, us = device.get(e.name, (0, 0.0))
                device[e.name] = (calls + 1, us + e.time_range.end
                                  - e.time_range.start)
        out.append({
            "host_ms": (t1 - t0) / 1e3,
            "device": {n[:90]: {"calls": c, "ms": us / 1e3}
                       for n, (c, us) in device.items()},
            "device_ms": sum(us for _c, us in device.values()) / 1e3,
            "runtime": runtime,
            "htod_copies": sum(c for n, (c, _us) in device.items()
                               if "HtoD" in n),
            "memcpy_calls": sum(c for n, c in runtime.items()
                                if n.startswith("cudaMemcpy")),
            "syncs": sum(c for n, c in runtime.items()
                         if "Synchronize" in n)})
    return out


def trace_cold(fn, args, reps: int = 5) -> dict:
    """``time_cold``'s interval under torch.profiler: each launch's CUDA
    event interval beside what the trace puts inside it (the device
    activities, their ms, runtime calls, copies, syncs); ``gap_ms`` is
    the interval less the device activities in it.  Medians over
    ``reps``; the profiler's own host cost is inside these intervals,
    so ``time_cold`` stays the kernel time that is reported."""
    import torch
    from torch.profiler import record_function

    flush = torch.ones(64 << 20, dtype=torch.int32, device=DEVICE)
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    intervals = []

    def run():
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(HEAD_START_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with record_function("timed_interval"):
                start.record()
                fn(*args)
                end.record()
            end.synchronize()
            intervals.append(start.elapsed_time(end))

    ranges = range_contents(profiled_events(run), "timed_interval")
    names = sorted({n for r in ranges for n in r["device"]})
    med = statistics.median
    # a trace that holds no device activity measured nothing (CUPTI does
    # not always deliver them): no device time, rather than 0
    seen = bool(names)
    device_ms = med(r["device_ms"] for r in ranges) if seen else None
    return {
        "interval_ms": med(intervals), "interval_ms_all": intervals,
        "device_ms": device_ms if seen else "not measured",
        "device": {n: med(r["device"].get(n, {"ms": 0.0})["ms"]
                          for r in ranges) for n in names},
        "gap_ms": (med(intervals) - device_ms) if seen else None,
        "host_ms": med(r["host_ms"] for r in ranges) if ranges else None,
        "runtime": ranges[0]["runtime"] if ranges else {},
        "htod_copies": max((r["htod_copies"] for r in ranges), default=None),
        "syncs": max((r["syncs"] for r in ranges), default=None)}


def stencil_round_profile(scfg, st, centres, icfg) -> dict:
    """One neighbourhood round (``lookup_or_interpolate``) under
    torch.profiler with its ``stencil_keys`` call and its plain
    ``lattice_step`` (the step at each centre's magnitude) each inside a
    range: what the stencil call launched on the card and made the host
    do, and under ``"lattice_step"`` the sums over the ``lattice_step``
    calls (one on the card; the plain stencil calls it again)."""
    from torch.profiler import record_function

    from repro_torch.core import lookup_or_interpolate, neighbors
    from repro_torch.kernels import ops

    orig = ops.stencil_keys, neighbors.lattice_step

    def ranged(fn, label):
        def call(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return call

    ops.stencil_keys = ranged(orig[0], "stencil_keys_call")
    neighbors.lattice_step = ranged(orig[1], "lattice_step_call")
    try:
        events = profiled_events(
            lambda: lookup_or_interpolate(scfg, st, centres, icfg))
    finally:
        ops.stencil_keys, neighbors.lattice_step = orig
    ranges = range_contents(events, "stencil_keys_call")
    steps = range_contents(events, "lattice_step_call")
    check(len(ranges) == 1 and steps,
          f"stencil profile: {len(ranges)} stencil and {len(steps)} "
          "lattice_step calls traced")
    keys = ("htod_copies", "memcpy_calls", "syncs", "host_ms", "device_ms")
    return {**ranges[0], "lattice_step": {
        "calls": len(steps), **{k: sum(r[k] for r in steps) for k in keys}}}


# ---------------------------------------------------------------------------
# byte and operation counts of each kernel on the given inputs
# ---------------------------------------------------------------------------

def bound_route_pack(mat, inv, fill):
    rows, width = inv.shape[0], mat.shape[1]
    picked = int((inv >= 0).sum())
    nbytes = 4 * (rows + picked * width + width + rows * width)
    return nbytes, 0


def bound_route_unpack(buf, slot, kept, fill):
    n, width = slot.shape[0], buf.shape[1]
    live = int((kept != 0).sum())
    nbytes = 4 * (2 * n + live * width + width + n * width)
    return nbytes, 0


def bound_hash64(keys):
    n, kw = keys.shape
    return 4 * (n * kw + 2 * n), n * kw * 2 * 11   # ~11 ALU ops per word


def bound_shard_apply(skeys, svals, smeta, scsum, q, base, n_probe, res):
    """What the decision needs: each query's key and base, the meta word
    of every distinct candidate bucket, the key words of the distinct
    occupied ones, the value and checksum of the distinct selected ones,
    and the outputs.  Operations: the checksum chain of each selected
    query."""
    import torch

    c, kw = q.shape
    vw = svals.shape[1]
    found, rsel = res
    off = torch.arange(n_probe, device=base.device, dtype=torch.int64)
    idx = (base.long()[:, None] + off).clamp(0, smeta.shape[0] - 1)
    cand = torch.unique(idx.reshape(-1))
    occ = int(((smeta[cand] & 1) != 0).sum())
    sel = torch.unique((base.long() + rsel.long())[found != 0])
    nbytes = 4 * (c * (kw + 1) + cand.numel() + occ * kw
                  + sel.numel() * (vw + 1) + c * (vw + 4))
    ops = int((found != 0).sum()) * (kw + vw) * 11
    return nbytes, ops


def bound_probe(skeys, svals, smeta, scsum, q, base, n_probe, validate,
                res):
    """What the answer needs: each query's key and base, the meta word of
    every distinct candidate up to the selected one (all of the window
    where none is), the key words of the distinct live ones among them,
    the value and checksum of the distinct selected ones, and the
    outputs.  Operations: the checksum chain of each selected query."""
    import torch

    c, kw = q.shape
    vw = svals.shape[1]
    found, rsel = res
    off = torch.arange(n_probe, device=base.device, dtype=torch.int64)
    last = torch.where(found != 0, rsel.long(), n_probe - 1)
    idx = (base.long()[:, None] + off).clamp(0, smeta.shape[0] - 1)
    cand = torch.unique(idx[off[None, :] <= last[:, None]])
    m = smeta[cand]
    live = int((((m & 1) != 0) & ((m & 2) == 0)).sum())
    sel = torch.unique((base.long() + rsel.long())[found != 0])
    nbytes = 4 * (c * (kw + 1) + cand.numel() + live * kw
                  + sel.numel() * (vw + 1) + c * (vw + 2))
    ops = int((found != 0).sum()) * (kw + vw) * 11 if validate else 0
    return nbytes, ops


def bound_l1_probe(lkeys, lvals, flags, q, set_idx):
    """Each query's key and set index in, its value row and hit flag
    out; of the cache, the flags, the key words of the coherent lines of
    the sets queried and the value rows of the lines that hit (each read
    once)."""
    import torch

    n, kw = q.shape
    ways, vw = lkeys.shape[1], lvals.shape[2]
    s = set_idx.long()
    ok = (lkeys[s] == q[:, None, :]).all(dim=-1) & (flags[s] != 0)
    hit = ok.any(dim=-1)
    line = s * ways + torch.argmax(ok.to(torch.int32), dim=-1)
    coherent = int((flags[torch.unique(s)] != 0).sum())
    hit_lines = int(torch.unique(line[hit]).numel())
    nbytes = (4 * n * (kw + 1 + vw) + n + flags.numel()
              + 4 * coherent * kw + 4 * hit_lines * vw)
    return nbytes, 0


def bound_checksum(keys, vals):
    n, kw = keys.shape
    vw = vals.shape[1]
    return 4 * (n * (kw + vw) + n), n * (kw + vw) * 11


def bound_round_sig(x, sig_digits):
    # a logf (~20 operations), floor, two table reads, three products
    return 8 * x.numel(), x.numel() * 30


def bound_stencil_keys(x, sig_digits, key_words, radius, coarse_tier,
                       n_buckets, n_probe):
    n, d = x.shape
    m = 1 + 2 * radius * d + int(coarse_tier)
    nbytes = 4 * (n * d + 2 * m + n * m * key_words + n * m)
    # per entry: D roundings, one lattice step, the KW-word chain
    return nbytes, n * m * (d * 30 + 40 + key_words * 11)


def bound_local_attention(q, k, v, window):
    """Q, K, V read once and O written once; 4 * D operations (q.k and
    p.v) per valid (query, key) pair, counted for this S and window."""
    b, s, h, d = q.shape
    w = min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w      # sum over rows of min(i+1, w)
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()
    return nbytes, 4 * d * pairs * b * h


def bound_ms(nbytes: int, ops: int,
             ops_per_s: float = ALU_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    import numpy as np
    import torch

    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, torch=torch.__version__, numpy=np.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), python=sys.version.split()[0])
    return smi


def ptxas_lines(lib: str, entry: str = "") -> list:
    """The registers/spill/smem lines of library ``lib``'s ptxas report
    (empty where another process built it); with ``entry``, only those of
    the kernels whose mangled name holds it, each prefixed with the
    kernel's name and head dim."""
    from repro_torch.kernels import build

    lines, current = [], ""
    for ln in build.PTXAS_LOG.get(lib, "").splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            current = m.group(1)
        elif entry in current and re.search(r"registers|spill|smem", ln):
            text = ln.split("ptxas info    : ")[-1].strip()
            if not entry:
                lines.append(text)
                continue
            # _ZN..._cu_<8 hex><len><name>ILi<D>E...: "name<D>"
            m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?)(?:ILi(\d+)E|E)", current)
            name = (f"{m.group(1)}<{m.group(2)}>" if m and m.group(2)
                    else m.group(1) if m else current[-60:])
            lines.append(f"{name}: {text}")
    return lines


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    secs = time.perf_counter() - t0
    report = {lib: ptxas_lines(lib) for lib in build.PTXAS_LOG}
    for lib in build.LIBRARIES:
        build.load(lib)
    emit("build", seconds=round(secs, 3), nvcc=build.nvcc_path(),
         flags=" ".join(build.NVCC_FLAGS), ptxas=report)


def main_path_capture(cfg_big, gen):
    """A full-size table holding 2^16 written keys, and the exact kernel
    inputs of a write round, a read round and two cached reads (an L1 of
    1024 sets x 4 ways, the second read finding it filled) on it."""
    import torch

    from repro_torch.core import (L1Config, dht_create, dht_read,
                                  dht_read_cached, dht_write, l1_create)
    from repro_torch.kernels import ops

    st = dht_create(cfg_big, device=DEVICE)
    keys = words(gen, N_KEYS, cfg_big.key_words, DEVICE)
    vals = words(gen, N_KEYS, cfg_big.val_words, DEVICE)
    with Capture(ops) as wcap:
        st, ws = dht_write(st, keys, vals)
    with Capture(ops) as rcap:
        st, _, found, _ = dht_read(st, keys)
    torch.cuda.synchronize()
    check(bool(found.all()), "capture round: a written key was not found")
    l1 = l1_create(L1Config(n_sets=1024, n_ways=4), cfg_big.n_shards,
                   device=DEVICE)
    with Capture(ops) as lcap:
        for _ in range(2):
            st, l1, _, found, _ = dht_read_cached(st, l1, keys)
    torch.cuda.synchronize()
    check(bool(found.all()), "capture round: a cached read missed a key")
    return st, wcap.calls, rcap.calls, lcap.calls


def off_by_one_word(t):
    """A contiguous copy of ``t`` whose first word sits 4 bytes past a
    16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def window_slab(gen, nb, kw, vw, n_probe, c):
    """A slab of ``nb`` rows drawn from six keys (so windows hold equal
    keys, some equal in every word but the last), with empty, INVALID and
    corrupted buckets, and ``c`` >= 5 queries whose first windows are fully
    occupied by other keys, all empty, ending at the slab's last row, cut
    by the clamp, and F6-shaped (the key INVALID, then failing its
    checksum, then valid)."""
    import torch

    from repro_torch.kernels import ref

    pool = words(gen, 6, kw, "cpu")
    sk = pool[torch.randint(0, 6, (nb,), generator=gen)]
    sk[torch.rand(nb, generator=gen) < 0.15, -1] ^= 1
    sv = words(gen, nb, vw, "cpu")
    kinds = torch.tensor([0, 1, 3, 2, 1 | (3 << 8)], dtype=torch.int32)
    sm = kinds[torch.multinomial(torch.tensor([0.25, 0.4, 0.15, 0.05, 0.15]),
                                 nb, replacement=True, generator=gen)]
    sk[:n_probe] = words(gen, n_probe, kw, "cpu")
    sm[:n_probe] = 1
    sm[nb // 2:nb // 2 + n_probe] = 0
    f = nb // 4
    sk[f:f + 3] = pool[0]
    sm[f:f + 3] = torch.tensor([3, 1, 1], dtype=torch.int32)
    good = ref.checksum(sk, sv)
    sc = good ^ (torch.rand(nb, generator=gen) < 0.1).to(torch.int32)
    sc[f + 1:f + 3] = good[f + 1:f + 3] ^ torch.tensor([1, 0],
                                                       dtype=torch.int32)
    q = pool[torch.randint(0, 6, (c,), generator=gen)]
    q[::5] = words(gen, len(range(0, c, 5)), kw, "cpu")
    q[4] = pool[0]
    base = torch.randint(-2, nb - n_probe + 3, (c,), generator=gen).to(
        torch.int32)
    base[:5] = torch.tensor([0, nb // 2, nb - n_probe, -3, f])
    return tuple(t.to(DEVICE) for t in (sk, sv, sm, sc, q, base))


def edge_cases(gen):
    """Small inputs like the CPU tests': ragged N and widths, fill rows,
    kept == 0, and a roughened table (INVALID, empty, corrupted
    checksums, a window at B - n_probe, a corrupted bucket shadowing a
    valid one); shard_apply also on ``window_slab``s (full, empty, clamped
    and F6 windows, widths off 4 and 2, C off the block size, 40
    candidates, rows staged past 48 KB of shared memory, slabs one word off
    16-byte alignment) and checksum on rows of 1 and 95 words, N off the
    tile, row-strided slices from column 1 and misaligned contiguous rows
    (the paths of the kernels' redesign); probe on ``window_slab``s too
    (one query, 40 candidates, rows past shared memory, misaligned slabs,
    with and without validation), route_unpack on odd widths, one word,
    misaligned buffers, every item dropped and slots out of range;
    round_sig on values one word off alignment, inputs of 1-5 values and
    one decade; l1_probe on KW 7, VW 25 and 28, misaligned query rows, 8
    and 40 ways and set indices out of range."""
    import torch

    from repro_torch.core import DHTConfig, dht_create, dht_write
    from repro_torch.core.hashing import base_bucket, hash64

    from repro_torch.kernels import hash_kernel

    cases = {name: [] for name in KERNEL_SOURCES}
    for n, kw in ((1, 20), (7, 4), (300, 33), (1000, 20), (N_KEYS, 20),
                  (N_KEYS + 77, 20), (129, 1), (129, 3), (129, 8),
                  (257, hash_kernel.max_kw())):
        keys = words(gen, n, kw, DEVICE)
        cases["hash64"].append((keys,))
        if kw in (4, 8, 20):           # one word off: the 4-byte path
            cases["hash64"].append((off_by_one_word(keys),))
    for n, kw, vw in ((1, 20, 26), (7, 4, 1), (300, 33, 17)):
        wide = words(gen, n, kw + vw + 3, DEVICE)
        cases["checksum"].append((words(gen, n, kw, DEVICE),
                                  words(gen, n, vw, DEVICE)))
        cases["checksum"].append((wide[:, :kw], wide[:, kw:kw + vw]))
    for n, kw, vw in ((1, 1, 0), (7, 0, 1), (129, 20, 75), (300, 48, 47),
                      (1000, 7, 5), (2 * N_KEYS + 5, 20, 26)):
        keys, vals = words(gen, n, kw, DEVICE), words(gen, n, vw, DEVICE)
        wide = torch.cat([words(gen, n, 1, DEVICE), keys, vals,
                          words(gen, n, 2, DEVICE)], 1)
        cases["checksum"] += [
            (keys, vals), (wide[:, 1:1 + kw], wide[:, 1 + kw:1 + kw + vw]),
            (off_by_one_word(keys), off_by_one_word(vals))]
    for kw, vw, n_probe, c in ((20, 26, 6, 203), (7, 5, 4, 77),
                               (23, 33, 6, 1000), (4, 1, 1, 33),
                               (20, 26, 40, 5), (300, 200, 6, 100)):
        sk, sv, sm, sc, q, base = window_slab(gen, 3 * n_probe + 40, kw, vw,
                                              n_probe, c)
        cases["shard_apply"] += [
            (sk, sv, sm, sc, q, base, n_probe),
            (off_by_one_word(sk), off_by_one_word(sv), sm, sc, q, base,
             n_probe)]
    for kw, vw, n_probe, c in ((20, 26, 6, 203), (20, 26, 6, 1), (7, 5, 4, 77),
                               (4, 1, 1, 33), (20, 26, 40, 203),
                               (900, 1000, 6, 40)):
        sk, sv, sm, sc, q, base = window_slab(gen, 3 * n_probe + 40, kw, vw,
                                              n_probe, max(c, 5))
        if c == 1:                      # one query: the F6 window
            q, base = q[4:5], base[4:5]
        for validate in (True, False):
            cases["probe"] += [
                (sk, sv, sm, sc, q, base, n_probe, validate),
                (off_by_one_word(sk), off_by_one_word(sv), sm, sc, q, base,
                 n_probe, validate)]
    edges = torch.tensor([0.0, -0.0, 1e-40, -1e-45, float("inf"),
                          -float("inf"), float("nan"), 9.995, 0.0999, 1.0],
                         device=DEVICE)
    # the keys' values: the 16-byte path, a view one word off alignment
    # (the 4-byte path), the n % 4 tail and inputs shorter than a vector,
    # and one decade, [1, 10)
    flat = torch.cat([edges, key_values(5000).reshape(-1).to(DEVICE)])
    decade = key_values(4100, (0.0, 1.0)).reshape(-1).to(DEVICE)
    for sig in (1, 3, 4):
        cases["round_sig"] += [(edges, sig), (flat[1:], sig),
                               (decade, sig), (decade[1:], sig)]
        cases["round_sig"] += [(flat[o:o + m], sig) for m in (1, 3, 5, 4097)
                               for o in (0, 1)]
    for d in (1, 10, 17):
        x = stencil_edge_rows(gen, INTERP_CENTRES, d)
        for radius in (0, 1, 3):
            for coarse in (True, False):
                for kw in sorted({7, 20, 23, 2 * d}):
                    full = (radius, coarse, kw) == (1, True, 20)
                    rows = x if full else x[:64]
                    cases["stencil_keys"].append(
                        (rows, 3, kw, radius, coarse, 1 << 16, 6))
        cases["stencil_keys"] += [
            (x[:1], 3, 20, 1, True, 1 << 16, 6),          # one row
            (x[:64], 3, 20, 1, True, 6, 6),               # span 1
            (x[:64], 1, 20, 3, True, 1 << 16, 6),         # sig 1
            (x[:64], 4, 23, 1, True, 1000, 6)]
    for n, rows, width in ((1, 16, 1), (80, 64, 22), (37, 96, 48),
                           (61, 32, 28)):
        mat = words(gen, n, width, DEVICE)
        inv = torch.randint(-1, n, (rows,), generator=gen).to(
            torch.int32).to(DEVICE)
        inv[:3] = -1
        fill = words(gen, 1, width, DEVICE)[0]
        cases["route_pack"].append((mat, inv, fill))
        buf = words(gen, rows, width, DEVICE)
        slot = torch.randint(0, rows, (n,), generator=gen).to(
            torch.int32).to(DEVICE)
        kept = torch.randint(0, 2, (n,), generator=gen).to(torch.int32).to(DEVICE)
        kept[0] = 0
        cases["route_unpack"].append((buf, slot, kept, fill))
    for n, rows, width in ((37, 29, 3), (300, 513, 1), (101, 64, 131),
                           (2 * N_KEYS, 4 * N_KEYS, 28)):
        buf, fill = words(gen, rows, width, DEVICE), words(gen, 1, width,
                                                          DEVICE)[0]
        slot = torch.randint(0, rows, (n,), generator=gen).to(
            torch.int32).to(DEVICE)
        kept = torch.randint(0, 2, (n,), generator=gen).to(
            torch.int32).to(DEVICE)
        past = slot.clone()
        past[::3] = rows + 2
        past[1::7] = -1
        cases["route_unpack"] += [
            (buf, slot, kept, fill),
            (off_by_one_word(buf), slot, kept, off_by_one_word(fill)),
            (buf, slot, torch.zeros_like(kept), fill),          # all dropped
            OutOfRange((buf, past, torch.ones_like(kept), fill),
                       (buf, past.clamp(0, rows - 1), torch.ones_like(kept),
                        fill))]
    for n_probe in (6, 1, 4):
        cfg = DHTConfig(n_shards=1, buckets_per_shard=128, n_probe=n_probe)
        st = dht_create(cfg, device=DEVICE)
        keys = words(gen, 96, cfg.key_words, DEVICE)
        st, _ = dht_write(st, keys, words(gen, 96, cfg.val_words, DEVICE))
        live = torch.nonzero(st.flat_meta[:-1] & 1)[:, 0]
        st.flat_meta[live[0::7]] |= 2
        st.flat_meta[live[3::11]] = 0
        st.flat_csum[live[5::9]] ^= 1
        q = torch.cat([keys[:40], words(gen, 16, cfg.key_words, DEVICE),
                       keys[40:48]])
        # one key twice in a window, its first copy failing its checksum,
        # behind an INVALID copy
        st.flat_keys[4:4 + n_probe] = q[0]
        st.flat_meta[4] = 1 | 2
        st.flat_meta[5:4 + n_probe] = 1 | (1 << 8)
        st.flat_csum[5] ^= 1
        q = torch.cat([q, q[:1]])
        base = base_bucket(hash64(q)[1], cfg.buckets_per_shard, n_probe)
        base[-2] = cfg.buckets_per_shard - n_probe
        base[-1] = 4
        slab = (st.flat_keys[:-1], st.flat_vals[:-1], st.flat_meta[:-1],
                st.flat_csum[:-1])
        cases["shard_apply"].append((*slab, q, base.contiguous(), n_probe))
        for validate in (True, False):
            cases["probe"].append((*slab, q, base.contiguous(), n_probe,
                                   validate))
    # l1_probe: 16- and 4-byte key chunks (KW 20, 7; query rows one word
    # off alignment), 16-, 8- and 4-byte value copies (VW 28, 26, 25), more
    # ways than a group's four lanes (8; 40, two mask segments) and set
    # indices out of range
    for sets, ways, n, kw, vw in ((1024, 4, 4096, 20, 26), (5, 1, 40, 20, 26),
                                  (16, 8, 300, 20, 26), (16, 8, 300, 7, 25),
                                  (64, 4, 1000, 20, 28), (7, 40, 200, 20, 26)):
        lkeys = words(gen, sets * ways, kw, DEVICE).reshape(sets, ways, kw)
        lvals = words(gen, sets * ways, vw, DEVICE).reshape(sets, ways, vw)
        flags = torch.randint(0, 2, (sets, ways), generator=gen).to(
            torch.bool).to(DEVICE)
        set_idx = torch.randint(0, sets, (n,), generator=gen).to(
            torch.int32).to(DEVICE)
        way = torch.randint(0, ways, (n,), generator=gen).to(DEVICE)
        q = lkeys[set_idx.long(), way].clone()
        q[::2] = words(gen, (n + 1) // 2, kw, DEVICE)
        if ways > 1:       # the key in two ways, the first one incoherent
            s = int(set_idx[1])
            lkeys[s, 1] = lkeys[s, 0]
            q[1] = lkeys[s, 0]
            flags[s, 0], flags[s, 1] = False, True
        past = set_idx.clone()
        past[::3] = sets + 2
        past[1::7] = -1
        cases["l1_probe"] += [
            (lkeys, lvals, flags, q, set_idx),
            (lkeys, lvals, flags, off_by_one_word(q), set_idx),
            OutOfRange((lkeys, lvals, flags, q, past),
                       (lkeys, lvals, flags, q, past.clamp(0, sets - 1)))]
    return cases


def stencil_edge_rows(gen, n: int, d: int):
    """(n, d) float32 queries over 1e-3..1e3 of either sign whose first
    words are 0, -0, two denormals, +-inf, nan and values within 3 ulps of
    10^k for k = -3..3 (the F1 band, where the card's bits must still
    equal the plain version's on the card)."""
    import torch

    x = (10.0 ** (torch.rand((n, d), generator=gen) * 6 - 3)
         * torch.where(torch.rand((n, d), generator=gen) < 0.5, -1.0, 1.0))
    x = x.to(torch.float32)
    p = torch.tensor([10.0 ** k for k in range(-3, 4)],
                     dtype=torch.float32).view(torch.int32)
    band = (p[:, None] + torch.arange(-3, 4, dtype=torch.int32)[None, :]
            ).view(torch.float32).reshape(-1)
    special = torch.tensor([0.0, -0.0, 1e-40, -1e-45, float("inf"),
                            -float("inf"), float("nan")])
    head = torch.cat([special, band, -band])
    flat = x.reshape(-1)
    flat[:min(head.numel(), flat.numel())] = head[:flat.numel()]
    return x.to(DEVICE)


def kernel_pairs():
    """name -> (kernel wrapper, plain version), each taking the arguments
    ``kernels/ops.py`` receives (the rounding wrappers take the float32
    contiguous input that ``ops`` hands them)."""
    from repro_torch.kernels import (apply_kernel, checksum_kernel,
                                     hash_kernel, l1_kernel, probe_kernel,
                                     ref, round_kernel, route_kernel,
                                     stencil_kernel)

    def f32(x):
        return x.float().contiguous()

    return {
        "route_pack": (route_kernel.route_pack, ref.route_pack),
        "route_unpack": (route_kernel.route_unpack, ref.route_unpack),
        "hash64": (hash_kernel.hash64, ref.hash64),
        "shard_apply": (apply_kernel.shard_apply, ref.shard_apply),
        "checksum": (checksum_kernel.checksum, ref.checksum),
        "round_sig": (lambda x, *a: round_kernel.round_sig(f32(x), *a),
                      ref.round_sig),
        "stencil_keys": (
            lambda x, *a: stencil_kernel.stencil_keys(f32(x), *a),
            ref.stencil_keys),
        "probe": (probe_kernel.probe, ref.probe),
        "l1_probe": (l1_kernel.l1_probe, ref.l1_probe),
    }


def compare_calls(calls: dict, errs: dict, where: str) -> dict:
    """Hold every captured kernel call against the plain version; fold
    the largest error per kernel into ``errs``.  The kernel launches made
    here count in no phase: the launch counts are restored after."""
    from repro_torch.kernels import build

    counted = dict(build.LAUNCHES)
    pairs = kernel_pairs()
    out = {}
    for name, arg_list in calls.items():
        if not arg_list:
            continue
        kern, plain = pairs[name]
        err = max(kernel_vs_plain(name, kern, plain, args)
                  for args in arg_list)
        errs[name] = max(errs.get(name, 0.0), err)
        out[name] = {"calls": len(arg_list), "max_abs_err": err}
    build.LAUNCHES.update(counted)
    emit("kernel_parity", where=where, result=out,
         tolerance="bit for bit (max_abs_err 0)")
    return out


def phase_kernels(cfg_big, gen, errs):
    st, wcalls, rcalls, lcalls = main_path_capture(cfg_big, gen)
    edges = edge_cases(gen)
    result = {}
    for name, (kern, plain) in kernel_pairs().items():
        main = wcalls[name] + rcalls[name] + lcalls[name]
        check(len(main) > 0 or name in ("round_sig", "stencil_keys"),
              f"{name}: the main path made no call")
        err = 0.0
        for args in main + edges[name]:
            err = max(err, kernel_vs_plain(name, kern, plain, args))
        errs[name] = max(errs.get(name, 0.0), err)
        result[name] = {"main_path_calls": len(main),
                        "edge_cases": len(edges[name]), "max_abs_err": err,
                        "shapes": sorted({str([tuple(a.shape) for a in args
                                               if hasattr(a, "shape")])
                                          for args in main})}
    emit("kernels", result=result, tolerance="bit for bit (max_abs_err 0)")
    return st, wcalls, rcalls, lcalls


def _stream(cfg, device, seed):
    """The seeded 2^16-key stream: keys/values for write, read, 95/5
    mixed and migrate rounds."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    n = N_KEYS
    keys = words(gen, n, cfg.key_words, device)
    vals = words(gen, n, cfg.val_words, device)
    fresh = words(gen, n // 2, cfg.key_words, device)
    mk = torch.cat([keys[: n // 2], fresh])
    mv = words(gen, n, cfg.val_words, device)
    op = (torch.rand(n, generator=gen) < 0.05).to(torch.int32).to(device)
    return keys, vals, mk, mv, op


def _rounds(st, keys, vals, mk, mv, op, record):
    """Run write, read, mixed, migrate; ``record(kind, n_ops, fn)``
    times each."""
    from repro_torch.core import (dht_execute, migrate_ops, mixed_ops,
                                  read_ops, write_ops)

    plan = [
        ("write", write_ops(keys, vals), ("write",)),
        ("read", read_ops(keys), ("read",)),
        ("mixed_95_5", mixed_ops(op, mk, mv), ("read", "write")),
        ("migrate", migrate_ops(mk, mv), ("migrate",)),
    ]
    outs = {}
    for kind, ops, kinds in plan:
        outs[kind] = record(kind, keys.shape[0],
                            lambda o=ops, k=kinds: dht_execute(st, o,
                                                               kinds=k))
    return outs


def phase_dht(cfg_big):
    import torch

    from repro_torch.convert import state_to_numpy
    from repro_torch.core import DHTConfig, dht_create, dht_write
    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    st = dht_create(cfg_big, device=DEVICE)
    table_gb = cfg_big.n_shards * cfg_big.shard_bytes / 1e9
    # warm-up round on other keys (first-call costs of the torch ops)
    wk, wv, _, _, _ = _stream(cfg_big, DEVICE, seed=99)
    dht_write(st, wk, wv)
    torch.cuda.synchronize()

    samples: dict[str, list] = {}

    def record(kind, n_ops, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        es = out[5]
        dropped = int(es["dropped"])
        check(dropped == 0, f"dht {kind}: {dropped} rows dropped")
        samples.setdefault(kind, []).append({
            "ops": n_ops, "capacity": es["capacity"],
            "fill_frac": float(es["fill_frac"]),
            "wire_words": es["wire_words"], "write_passes": es["rounds"],
            "mismatches": int(es["mismatches"]), "ms": secs * 1e3})
        return out

    ops.reset_launches()
    for rep in range(DHT_REPS):
        keys, vals, mk, mv, op = _stream(cfg_big, DEVICE, seed=1 + rep)
        outs = _rounds(st, keys, vals, mk, mv, op, record)
        check(bool(outs["read"][3].all()),
              "dht read: not every written key was found")
        check(torch.equal(outs["read"][2], vals), "dht read: wrong values")
    launches = ops.launches()
    # every write pass launches shard_apply (slot choice) and checksum
    # once; the read, mixed and migrate rounds make one probe pass each
    passes = sum(sum(r["write_passes"] for r in runs)
                 for runs in samples.values())
    check(launches["checksum"] == passes == launches["shard_apply"],
          f"dht: checksum launches {launches['checksum']}, write passes "
          f"{passes}, shard_apply launches {launches['shard_apply']}")
    check(launches["probe"] == 3 * DHT_REPS,
          f"dht: probe launches {launches['probe']}, probe passes "
          f"{3 * DHT_REPS}")
    rounds = []
    for kind, runs in samples.items():
        ms = [r["ms"] for r in runs]
        med = statistics.median(ms)
        rounds.append({
            "round": kind, "ops": runs[0]["ops"],
            "capacity": runs[0]["capacity"],
            "fill_frac": runs[0]["fill_frac"],
            "wire_words": runs[0]["wire_words"], "dropped": 0,
            "write_passes": [r["write_passes"] for r in runs],
            "mismatches": sum(r["mismatches"] for r in runs),
            "ms_median": med, "ms_all": ms,
            "mops_per_s": runs[0]["ops"] / med / 1e3})
    peak = torch.cuda.max_memory_allocated()
    emit("dht", S=cfg_big.n_shards, B=cfg_big.buckets_per_shard,
         key_words=cfg_big.key_words, val_words=cfg_big.val_words,
         n_probe=cfg_big.n_probe, mode=cfg_big.mode, table_gb=table_gb,
         reps=DHT_REPS, rounds=rounds, max_memory_allocated_gb=peak / 1e9,
         write_passes=passes, probe_passes=3 * DHT_REPS, launches=launches)
    del st

    # the same stream at B=2^16: card and CPU must agree word for word
    small = DHTConfig(key_words=20, val_words=26, n_shards=8,
                      buckets_per_shard=SMALL_BUCKETS)
    result = {}
    for device in (DEVICE, "cpu"):
        st = dht_create(small, device=device)
        stream = _stream(small, device, seed=1)
        outs = _rounds(st, *stream, lambda kind, n, fn: fn())
        result[device] = (state_to_numpy(st), {
            k: [o[i].cpu() for i in (2, 3, 4)] for k, o in outs.items()})
    card, cpu = result[DEVICE], result["cpu"]
    tables_equal = all((card[0][k] == cpu[0][k]).all() for k in cpu[0])
    items_equal = all(torch.equal(a, b) for k in cpu[1]
                      for a, b in zip(card[1][k], cpu[1][k]))
    check(tables_equal, "B=2^16 stream: card and CPU slab words differ")
    check(items_equal, "B=2^16 stream: card and CPU vals/found/code differ")
    emit("dht_parity", B=small.buckets_per_shard, tables_equal=tables_equal,
         items_equal=items_equal)
    return launches


def _obs_round(kind, keys, vals, mk, mv, op):
    """One engine round of ``kind`` (write, read, mixed_95_5, migrate)
    through the issue and commit halves -> ``(ops, kinds, mix)``: the
    batch, its kinds and the op counts the caller issued."""
    from repro_torch.core import migrate_ops, mixed_ops, read_ops, write_ops

    n = keys.shape[0]
    if kind == "write":
        return write_ops(keys, vals), ("write",), {"write": n}
    if kind == "read":
        return read_ops(keys), ("read",), {"read": n}
    if kind == "migrate":
        return migrate_ops(mk, mv), ("migrate",), {"migrate": n}
    n_write = int((op == 1).sum())
    return (mixed_ops(op, mk, mv), ("read", "write"),
            {"read": n - n_write, "write": n_write})


def phase_obs(cfg_big):
    """The telemetry of the engine on dht-full's table: (a) recording on
    against off in turns (round ms; host syncs of each issue and commit
    half); (b) the registry's counters against the lanes the caller saw;
    (c) the JSONL and Chrome exports and the report's timeline; (d) the
    fenced phase spans of read, write and get-or-put rounds; (e) the
    cost model fitted over rounds of 2^12..2^16 keys."""
    import tempfile

    import torch

    from repro_torch import obs
    from repro_torch.core import dht_commit, dht_create, dht_issue, dht_write
    from repro_torch.kernels import ops
    from repro_torch.obs import costmodel, metrics, report, trace

    st = dht_create(cfg_big, device=DEVICE)
    wk, wv, _, _, _ = _stream(cfg_big, DEVICE, seed=99)
    dht_write(st, wk, wv)               # warm-up: first-call costs
    torch.cuda.synchronize()
    reg = metrics.MetricRegistry()
    prev = metrics.set_registry(reg)
    tracer = obs.get_tracer()
    tracer.clear()
    ops.reset_launches()
    seen: list = []                     # (stats, mix) of every recorded round
    kinds = ("write", "read", "mixed_95_5")
    try:
        def run(kind, stream, record):
            sop, sk, mix = _obs_round(kind, *stream)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (contextlib.nullcontext() if record
                  else metrics.disabled()):
                es = dht_commit(dht_issue(st, sop, kinds=sk))[5]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check(int(es["dropped"]) == 0, f"obs {kind}: rows dropped")
            if record:
                seen.append((es, mix))
            return ms

        # (a) on and off in turns, fresh keys a rep and mode; rep 0 warms
        # both modes up (first-call costs) and is not timed
        times = {(m, k): [] for m in ("on", "off") for k in kinds}
        for rep in range(OBS_REPS + 1):
            for mode in (("on", "off") if rep % 2 else ("off", "on")):
                stream = _stream(cfg_big, DEVICE,
                                 seed=300 + 2 * rep + (mode == "off"))
                for kind in kinds:
                    ms = run(kind, stream, mode == "on")
                    if rep:
                        times[mode, kind].append(ms)
        overhead = {}
        for kind in kinds:
            on, off = times["on", kind], times["off", kind]
            m_on, m_off = statistics.median(on), statistics.median(off)
            overhead[kind] = {
                "ms_on_median": m_on, "ms_off_median": m_off,
                "ms_on_range": [min(on), max(on)],
                "ms_off_range": [min(off), max(off)],
                "ms_on_all": on, "ms_off_all": off,
                "overhead_frac": m_on / m_off - 1.0}
        # host syncs of each half, recording on and off (fresh keys each);
        # the sync debug mode's first window reports one sync of torch's
        # own (first-call state), so one read round opens it first
        syncs, sites = {}, {}
        sop, sk, mix = _obs_round("read",
                                  *_stream(cfg_big, DEVICE, seed=319))
        _, _, rnd = issue_syncs(lambda: dht_issue(st, sop, kinds=sk))
        seen.append((dht_commit(rnd)[5], mix))
        for mode in ("on", "off"):
            stream = _stream(cfg_big, DEVICE, seed=320 + (mode == "off"))
            for kind in kinds:
                sop, sk, mix = _obs_round(kind, *stream)
                with (contextlib.nullcontext() if mode == "on"
                      else metrics.disabled()):
                    n_i, s_i, rnd = issue_syncs(
                        lambda: dht_issue(st, sop, kinds=sk))
                    n_c, s_c, out = issue_syncs(lambda: dht_commit(rnd))
                es = out[5]
                if mode == "on":
                    seen.append((es, mix))
                syncs[f"{kind}_{mode}"] = {"issue": n_i, "commit": n_c,
                                           "write_passes": es["rounds"]}
                sites[f"{kind}_{mode}"] = s_i + s_c
        # the engine's count, on and off alike: the capacity plan, then one
        # flag read a write pass and one more where the passes end early
        # (the pass count depends on the keys); none at commit
        for key, got in syncs.items():
            p = got["write_passes"]
            want = 1 + (p + (p < cfg_big.n_probe)
                        if not key.startswith("read") else 0)
            got["expected_issue"] = want
            check(got["issue"] == want and got["commit"] == 0,
                  f"obs {key}: {got['issue']} syncs an issue half ({want} "
                  f"expected), {got['commit']} a commit ({sites})")

        # (b) the counters against the lanes the caller saw
        check(reg.counter("engine.rounds") == len(seen),
              f"obs: engine.rounds {reg.counter('engine.rounds')}, "
              f"{len(seen)} rounds recorded")
        lanes = {}
        for lane, name in trace._COUNTER_LANES.items():
            want = sum(int(es[lane]) for es, _ in seen if lane in es)
            lanes[name] = (reg.counter(name), want)
        for kind in ("read", "write"):
            lanes[f"engine.ops.{kind}"] = (
                reg.counter(f"engine.ops.{kind}"),
                sum(m.get(kind, 0) for _, m in seen))
        bad = {k: v for k, v in lanes.items() if v[0] != v[1]}
        check(not bad, f"obs: counters differ from the lanes: {bad}")
        fill = reg.histogram("engine.fill_frac")
        check(fill is not None and fill.count == len(seen),
              "obs: engine.fill_frac is not observed once a round")
        snap = reg.snapshot()
        n_counted = len(seen)

        # (c) exports
        with tempfile.TemporaryDirectory() as tmp:
            n_ev = len(tracer.events())
            n_lines = tracer.to_jsonl(f"{tmp}/trace.jsonl")
            with open(f"{tmp}/trace.jsonl") as f:
                rows = [json.loads(line) for line in f]
            n_chrome = tracer.to_chrome_trace(f"{tmp}/trace.json")
            with open(f"{tmp}/trace.json") as f:
                chrome = json.load(f)["traceEvents"]
        n_spans = sum(len(e.spans) for e in tracer.events())
        check(n_lines == len(rows) == n_ev == len(seen)
              and n_chrome == len(chrome) == n_ev + n_spans,
              f"obs exports: {n_lines} lines, {len(rows)} read back, "
              f"{n_chrome} chrome events ({n_ev} rounds, {n_spans} spans)")
        print(report.render_timeline(rows, last=6), flush=True)

        def span_ms(events, source):
            out = {}
            for ph in trace.PHASES:
                vals = [e.spans[ph][1] * 1e3 for e in events
                        if e.source == source and ph in e.spans]
                if vals:
                    out[ph] = statistics.median(vals)
            return out

        def round_ms(events, source):
            return statistics.median(e.dur * 1e3 for e in events
                                     if e.source == source)

        issue_spans = {k: span_ms(tracer.events(), f"engine.{k}")
                       for k in ("write", "read")}
        issue_round = {k: round_ms(tracer.events(), f"engine.{k}")
                       for k in ("write", "read")}

        # (d) fenced phase spans
        tracer.clear()
        trace.set_fence(True)
        try:
            for rep in range(OBS_REPS):
                stream = _stream(cfg_big, DEVICE, seed=330 + rep)
                for kind in ("write", "read", "migrate"):
                    run(kind, stream, True)
        finally:
            trace.set_fence(False)
        fenced = {k: span_ms(tracer.events(), f"engine.{k}")
                  for k in ("read", "write", "migrate")}
        fenced_round = {k: round_ms(tracer.events(), f"engine.{k}")
                        for k in fenced}
        check(all(set(v) == set(trace.PHASES) for v in fenced.values()),
              f"obs: fenced rounds lack phases: {fenced}")

        # (e) the cost model over unfenced rounds of 2^12..2^16 keys
        tracer.clear()
        for n in OBS_FIT_SIZES:
            for rep in range(3):
                stream = [t[:n] for t in _stream(cfg_big, DEVICE,
                                                 seed=340 + rep)]
                for kind in ("write", "read"):
                    run(kind, stream, True)
        model = costmodel.fit(tracer.events())
        check(min(model.coef()) >= 0.0,
              f"obs cost model: a negative coefficient {model}")
    finally:
        metrics.set_registry(prev)
    launches = ops.launches()
    emit("obs", S=cfg_big.n_shards, B=cfg_big.buckets_per_shard,
         reps=OBS_REPS, overhead=overhead, syncs=syncs,
         rounds_counted=n_counted, counters_vs_lanes=lanes,
         trace_events=n_ev, chrome_events=n_chrome,
         snapshot_counters=snap["counters"])
    emit("obs_spans", fenced_ms=fenced, fenced_round_ms=fenced_round,
         issue_time_ms=issue_spans, unfenced_round_ms=issue_round)
    emit("obs_costmodel", sizes=list(OBS_FIT_SIZES), **model.to_dict())
    tracer.clear()
    del st
    return launches


def key_values(n: int, decades: tuple[float, float] = (-30.0, 30.0)):
    """(n / 10, 10) float32 chemistry inputs of either sign whose
    magnitudes are log-uniform over ``decades`` (generator seed 5): the
    keys phase's values, and the inputs its rounding kernel is timed on."""
    import torch

    gen = torch.Generator().manual_seed(5)
    lo, hi = decades
    mag = 10.0 ** (torch.rand(n, generator=gen, dtype=torch.float64)
                   * (hi - lo) + lo)
    sign = torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0)
    return (mag * sign).to(torch.float32).reshape(-1, 10)


def phase_keys(errs):
    import numpy as np
    import torch

    from repro_torch.core import SurrogateConfig, make_keys
    from repro_torch.kernels import ops

    cfg = SurrogateConfig(sig_digits=3)
    n = KEY_VALUES
    x = key_values(n)
    x_dev = x.to(DEVICE)
    torch.cuda.synchronize()
    ops.reset_launches()
    with Capture(ops) as cap:
        k_gpu = make_keys(cfg, x_dev)
    torch.cuda.synchronize()
    launches = ops.launches()
    k_gpu = k_gpu.cpu()
    parity = compare_calls(cap.calls, errs, "keys")
    k_cpu = make_keys(cfg, x)
    diff = (k_gpu[:, 0::2] != k_cpu[:, 0::2]).reshape(-1)
    bad = x.reshape(-1)[diff].numpy()
    p = np.array([np.float32(10.0 ** k) for k in range(-37, 38)], np.float32)
    ulps = (np.abs(np.abs(bad).view(np.int32)[:, None]
                   - p.view(np.int32)[None, :]).min(axis=1)
            if bad.size else np.zeros(0))
    outside = int((ulps > 64).sum())
    emit("keys", values=n, sig_digits=cfg.sig_digits,
         kernel_vs_plain_on_card=parity,
         card_vs_cpu_mismatches=int(diff.sum()),
         outside_64ulp_band=outside,
         padding_words_equal=bool(torch.equal(k_gpu[:, 1::2],
                                              k_cpu[:, 1::2])),
         launches=launches)
    check(outside == 0, f"keys: {outside} card/CPU mismatches lie outside "
                        "the 64-ulp band of a decade boundary")
    return launches, cap.calls


def phase_poet():
    import torch

    sys.path.insert(0, str(ROOT / "examples"))
    from torch_poet_reactive_transport import PoetConfig, run_simulation

    from repro_torch.kernels import ops

    cfg = PoetConfig(n_steps=POET_STEPS)
    ref = run_simulation(cfg, use_dht=False, device=DEVICE)
    torch.cuda.synchronize()
    ops.reset_launches()
    dht = run_simulation(cfg, use_dht=True, device=DEVICE)
    torch.cuda.synchronize()
    launches = ops.launches()
    conc = dht["conc"]
    check(conc.shape == (cfg.nx * cfg.ny, 9), "poet: conc shape")
    check(bool(torch.isfinite(conc).all()), "poet: non-finite conc")
    check(dht["hit_rate"] > 0.3, f"poet: hit rate {dht['hit_rate']}")
    check(dht["chem_calls"] < ref["chem_calls"], "poet: no solver calls saved")
    err = float((conc - ref["conc"]).abs().max())
    emit("poet", grid=[cfg.nx, cfg.ny], sig_digits=cfg.sig_digits,
         solver_iters=cfg.solver_iters,
         n_steps=f"{cfg.n_steps} of {PoetConfig.n_steps} (cut to fit the "
                 "time limit)",
         hit_rate=dht["hit_rate"], hits=dht["hits"], misses=dht["misses"],
         chem_calls=dht["chem_calls"], chem_calls_no_dht=ref["chem_calls"],
         mismatches=dht["mismatches"], wall_s=dht["wall_s"],
         wall_s_no_dht=ref["wall_s"],
         gain_pct=(ref["wall_s"] - dht["wall_s"]) / ref["wall_s"] * 100,
         max_abs_dconc=err, launches=launches)
    return launches, ref, dht


def interp_fn(x):
    """The function stored in the interp phase's tables: (n, 10) -> (n, 13),
    linear, so the blend of two neighbours 1 step either side of a centre
    recovers it up to rounding."""
    import torch

    return torch.cat([x * 2.0, x[:, :3]], dim=-1)


def _bracketed(scfg, n, device, seed):
    """``n`` query centres on the ``sig_digits`` lattice (uniform in
    1.5..9.5, D = 10) and the 2n points one lattice step either side of
    each along dim 0, which the phase stores: every centre is then a
    near miss with two cached neighbours (tests/test_interp.py's
    construction).  Made on the CPU, then moved."""
    import torch

    from repro_torch.core.neighbors import lattice_step, round_significant

    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n, scfg.n_inputs), generator=gen) * 8 + 1.5
    centre = round_significant(x, scfg.sig_digits)
    step = lattice_step(centre, scfg.sig_digits)
    lo, hi = centre.clone(), centre.clone()
    lo[:, 0] -= step[:, 0]
    hi[:, 0] += step[:, 0]
    return centre.to(device), torch.cat([lo, hi]).to(device)


def _rows(seed, n, lo, hi, device):
    import torch

    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 10), generator=gen) * (hi - lo) + lo).to(device)


def _interp_parity(icfg):
    """(b): the bracketed construction at B=2^16, plus stored exact rows
    and far misses, on the card and on the CPU."""
    import numpy as np
    import torch

    from repro_torch.convert import state_to_numpy
    from repro_torch.core import (DHTConfig, SurrogateConfig, dht_read_many,
                                  lookup_interpolate_or_compute, store,
                                  surrogate_create)
    from repro_torch.core.neighbors import dedup_mask
    from repro_torch.kernels import ops

    small = SurrogateConfig(n_inputs=10, n_outputs=13, sig_digits=3,
                            dht=DHTConfig(key_words=20, val_words=26,
                                          n_shards=8,
                                          buckets_per_shard=SMALL_BUCKETS))
    n = INTERP_CENTRES
    k = n // 6                   # stored exact rows; 2k far misses
    res = {}
    for device in (DEVICE, "cpu"):
        centres, nbrs = _bracketed(small, n, device, seed=12)
        exact = _rows(13, k, 0.5, 9.5, device)
        far = _rows(14, 2 * k, 20.0, 90.0, device)
        st = surrogate_create(small, device=device)
        rows = torch.cat([nbrs, exact])
        st, _ = store(small, st, rows, interp_fn(rows))
        # n rows: bracketed centres, the exact rows, k far misses
        q1 = torch.cat([centres[:n - 2 * k], exact, far[:k]])
        keys, base = ops.stencil_keys(
            q1, small.sig_digits, small.dht.key_words, icfg.radius,
            icfg.coarse_tier, SMALL_BUCKETS, small.dht.n_probe)
        st, vals, found, _ = dht_read_many(st, keys, dedup_mask(keys))
        st, o1, p1, s1 = lookup_interpolate_or_compute(
            small, st, q1, interp_fn, icfg)
        # n rows: centres (those of q1 now exact), k fresh far misses
        q2 = torch.cat([centres[k:], far[k:] * 1.01])[:n]
        st, o2, p2, s2 = lookup_interpolate_or_compute(
            small, st, q2, interp_fn, icfg, one_round=True)
        res[device] = {
            "keys": keys.cpu(), "base": base.cpu(), "found": found.cpu(),
            "vals": vals.cpu(), "prov_host": p1.cpu(),
            "prov_one_round": p2.cpu(), "out_host": o1.cpu(),
            "out_one_round": o2.cpu(),
            "stored": (int(s1["stored"]), int(s2["stored"])),
            "table": state_to_numpy(st)}
    card, cpu = res[DEVICE], res["cpu"]
    equal = {k: bool(torch.equal(card[k], cpu[k]))
             for k in ("keys", "base", "found", "vals", "prov_host",
                       "prov_one_round")}
    equal["stored"] = card["stored"] == cpu["stored"]
    equal["table"] = all((card["table"][k] == cpu["table"][k]).all()
                         for k in cpu["table"])
    for k in ("out_host", "out_one_round"):
        np.testing.assert_allclose(card[k].numpy(), cpu[k].numpy(),
                                   rtol=1e-5, err_msg=k)
    provs = {int(v) for v in torch.cat([cpu["prov_host"],
                                         cpu["prov_one_round"]]).unique()}
    emit("interp_parity", B=SMALL_BUCKETS, rows=n, equal=equal,
         outputs="rtol 1e-5", provenances=sorted(provs),
         stored=cpu["stored"], probe_hits=int(cpu["found"].sum()))
    check(all(equal.values()), f"interp B=2^16: card and CPU differ {equal}")
    check(provs == {0, 1, 2}, f"interp B=2^16: provenances {provs}")


def phase_interp(cfg_big, errs, poet_plain):
    import torch

    sys.path.insert(0, str(ROOT / "examples"))
    from torch_poet_reactive_transport import PoetConfig, run_simulation

    from repro_torch.core import (PROV_INTERP, InterpConfig, SurrogateConfig,
                                  lookup_or_interpolate, store,
                                  surrogate_create)
    from repro_torch.core.neighbors import n_stencil
    from repro_torch.kernels import ops

    scfg = SurrogateConfig(n_inputs=10, n_outputs=13, sig_digits=3,
                           dht=cfg_big)
    icfg = InterpConfig(radius=1, coarse_tier=True)
    n = INTERP_CENTRES
    m = n_stencil(scfg.n_inputs, icfg.radius, icfg.coarse_tier)

    # (a) the bracketed round on the full table
    st = surrogate_create(scfg, device=DEVICE)
    centres, nbrs = _bracketed(scfg, n, DEVICE, seed=11)
    wc, wn = _bracketed(scfg, 64, DEVICE, seed=99)      # warm-up rows
    st, _ = store(scfg, st, wn, interp_fn(wn))
    lookup_or_interpolate(scfg, st, wc, icfg)
    torch.cuda.synchronize()
    ops.reset_launches()
    times = []

    def timed_round():
        t0 = time.perf_counter()
        result = lookup_or_interpolate(scfg, st, centres, icfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return result

    with Capture(ops) as cap:              # the store and the first round
        t0 = time.perf_counter()
        st, ws = store(scfg, st, nbrs, interp_fn(nbrs))
        torch.cuda.synchronize()
        store_ms = (time.perf_counter() - t0) * 1e3
        timed_round()
    for _ in range(INTERP_REPS - 1):
        st, out, prov, stats = timed_round()
    launches_a = ops.launches()
    prof = stencil_round_profile(scfg, st, centres, icfg)
    kernel_ms = [v["ms"] for k, v in prof["device"].items()
                 if "stencil_keys_kernel" in k]
    step = prof["lattice_step"]
    emit("interp_stencil_profile", call="stencil_keys in one round",
         htod_copies=prof["htod_copies"], memcpy_calls=prof["memcpy_calls"],
         syncs=prof["syncs"], kernel_device_ms=kernel_ms,
         host_ms=prof["host_ms"], runtime=prof["runtime"],
         lattice_step=step)
    check(len(kernel_ms) == 1, "interp: the profile saw no stencil kernel")
    check(prof["htod_copies"] == 0 and prof["memcpy_calls"] == 0
          and prof["syncs"] == 0,
          f"interp: stencil_keys copied from the host or waited {prof}")
    check(step["htod_copies"] == 0 and step["memcpy_calls"] == 0,
          f"interp: lattice_step copied from the host {step}")
    truth = interp_fn(centres)
    rel = float(((out - truth).abs() / (truth.abs() + 1e-9)).max())
    n_interp = int((prov == PROV_INTERP).sum())
    a = {"rows": n, "stencil_entries": m, "probes": n * m,
         "stored_rows": int(nbrs.shape[0]), "store_ms": store_ms,
         "store_dropped": int(ws["dropped"]),
         "round_ms_all": times, "round_ms_median": statistics.median(times),
         "interpolated": n_interp, "exact": int(stats["exact"]),
         "misses": int(stats["misses"]),
         "probe_hits": int(stats["probe_hits"]),
         "dropped": int(stats["dropped"]),
         "mismatches": int(stats["mismatches"]),
         "wire_words": stats["wire_words"],
         "fill_frac": float(stats["fill_frac"]), "max_rel_err": rel,
         "launches": launches_a}
    emit("interp_round", **a)
    check(n_interp == n, f"interp: {n - n_interp} of {n} rows did not "
                         "interpolate")
    check(rel < 0.05, f"interp: max relative error {rel}")
    check(a["dropped"] == 0 and a["store_dropped"] == 0
          and a["mismatches"] == 0, f"interp: dropped or mismatched {a}")
    check(len(cap.calls["stencil_keys"]) == 1
          and tuple(cap.calls["stencil_keys"][0][0].shape) == (n, 10),
          "interp: the round made no stencil_keys call at full shape")
    compare_calls(cap.calls, errs, "interp")
    del st

    # (b) card against CPU at B=2^16
    _interp_parity(icfg)

    # (c) the POET twin with --interp, beside phase 6's plain run
    cfg = PoetConfig(n_steps=POET_STEPS, use_interp=True)
    torch.cuda.synchronize()
    ops.reset_launches()
    res = run_simulation(cfg, use_dht=True, device=DEVICE)
    torch.cuda.synchronize()
    launches_c = ops.launches()
    conc = res["conc"]
    cells = cfg.nx * cfg.ny * cfg.n_steps
    check(conc.shape == (cfg.nx * cfg.ny, 9)
          and bool(torch.isfinite(conc).all()), "interp poet: bad conc")
    check(res["hits"] + res["interp_hits"] + res["misses"] == cells,
          "interp poet: hits + interpolated + misses != cells")
    emit("interp_poet", grid=[cfg.nx, cfg.ny], sig_digits=cfg.sig_digits,
         n_steps=f"{cfg.n_steps} of {PoetConfig.n_steps}",
         radius=cfg.interp_radius, max_dist=cfg.interp_max_dist,
         min_neighbors=cfg.interp_min_neighbors,
         exact_hits=res["hits"], interp_hits=res["interp_hits"],
         misses=res["misses"], chem_calls=res["chem_calls"],
         mismatches=res["mismatches"], wall_s=res["wall_s"],
         plain={k: poet_plain[k] for k in ("hits", "misses", "chem_calls",
                                           "wall_s")},
         max_abs_dconc_vs_plain=float(
             (conc - poet_plain["conc"]).abs().max()),
         launches=launches_c)
    return {k: launches_a[k] + launches_c[k] for k in launches_a}, cap.calls


def _l1_full(cfg_big, errs):
    """(a) l1-full: cached against uncached reads of one full-size table
    on a Zipf and a uniform stream, with rewrites between batches."""
    import numpy as np
    import torch

    from repro_torch.core import (L1Config, dht_create, dht_read,
                                  dht_read_cached, dht_write, l1_create)
    from repro_torch.kernels import ops

    torch.cuda.reset_peak_memory_stats()
    st = dht_create(cfg_big, device=DEVICE)
    gen = torch.Generator().manual_seed(21)
    u = L1_UNIVERSE
    ukeys = words(gen, u, cfg_big.key_words, DEVICE)
    uvals = words(gen, u, cfg_big.val_words, DEVICE)
    for i in range(0, u, N_KEYS):
        st, ws = dht_write(st, ukeys[i:i + N_KEYS], uvals[i:i + N_KEYS])
        check(int(ws["dropped"]) == 0, "l1-full: universe write dropped rows")
    rng = np.random.default_rng(22)
    out = {}
    for dist in ("zipf", "uniform"):
        l1 = l1_create(L1Config(n_sets=1024, n_ways=4), cfg_big.n_shards,
                       device=DEVICE)
        hits = queries = wire_c = wire_p = 0
        ms_c, ms_p, per_batch = [], [], []
        for b in range(L1_BATCHES):
            ids = (rng.zipf(1.1, N_KEYS) % u if dist == "zipf"
                   else rng.integers(0, u, N_KEYS))
            kb = ukeys[torch.from_numpy(ids).to(DEVICE)]
            torch.cuda.synchronize()
            with Capture(ops) as cap:
                t0 = time.perf_counter()
                st, l1, cv, cf, cs = dht_read_cached(st, l1, kb)
                torch.cuda.synchronize()
                ms_c.append((time.perf_counter() - t0) * 1e3)
            if dist == "zipf" and b == 1:
                compare_calls(cap.calls, errs, "l1-full cached round")
            del cap
            t0 = time.perf_counter()
            st, pv, pf, ps = dht_read(st, kb)
            torch.cuda.synchronize()
            ms_p.append((time.perf_counter() - t0) * 1e3)
            n_hit = int(cs["l1_hits"])
            bad = {k: (int(cs[k]), int(ps[k])) for k in ("dropped",
                                                         "mismatches")
                   if int(cs[k]) or int(ps[k])}
            check(not bad, f"l1-full {dist} batch {b}: {bad}")
            check(torch.equal(cv, pv) and torch.equal(cf, pf),
                  f"l1-full {dist} batch {b}: cached read differs from "
                  "the uncached one")
            # a rewrite touches every shard, so its watermark fence
            # retires every line: the batch after it refills the cache
            after_write = b > 0 and b % 2 == 0
            check(dist != "zipf" or b == 0 or after_write or n_hit > 0,
                  f"l1-full zipf batch {b}: no L1 hit")
            per_batch.append({"l1_hits": n_hit, "after_rewrite": after_write,
                              "found": int(cf.sum()),
                              "wire_cached": cs["wire_words"],
                              "wire_uncached": ps["wire_words"]})
            if b:
                hits += n_hit
                queries += N_KEYS
                wire_c += cs["wire_words"]
                wire_p += ps["wire_words"]
            if b % 2 == 1:      # rewrite keys of the universe: the fence
                wid = torch.from_numpy(rng.choice(u, L1_REWRITES,
                                                  replace=False)).to(DEVICE)
                st, ws = dht_write(st, ukeys[wid], words(
                    gen, L1_REWRITES, cfg_big.val_words, DEVICE))
                check(int(ws["dropped"]) == 0, "l1-full: rewrite dropped")
        out[dist] = {"l1_hit_frac": hits / queries,
                     "wire_words_cached": wire_c,
                     "wire_words_uncached": wire_p,
                     "wire_ratio": wire_p / wire_c,
                     "cached_round_ms_median": statistics.median(ms_c),
                     "uncached_round_ms_median": statistics.median(ms_p),
                     "cached_round_ms": ms_c, "uncached_round_ms": ms_p,
                     "batches": per_batch}
    emit("l1_full", S=cfg_big.n_shards, B=cfg_big.buckets_per_shard,
         universe=u, l1="1024 sets x 4 ways", batch=N_KEYS,
         batches=L1_BATCHES, rewrites=L1_REWRITES,
         hit_frac_and_wire_over="batches 1..7", streams=out,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del st


def _l1_ref_stream(device):
    """``benchmarks/bench_l1_locality.py``'s quick stream, drawn in its
    order: the key table, then per distribution the table write, the L1
    and four batches."""
    import numpy as np
    import torch

    from repro_torch.convert import l1_to_numpy
    from repro_torch.core import (DHTConfig, L1Config, dht_create, dht_read,
                                  dht_read_cached, dht_write, l1_create)

    universe, n, s = 2048, 2048, 8
    rng = np.random.default_rng(11)

    def table(w):
        a = rng.integers(0, 2**31, size=(universe, w)).astype(np.int32)
        return torch.from_numpy(a).to(device)

    ukeys, uvals = table(20), table(26)
    cfg = DHTConfig(n_shards=s, buckets_per_shard=1 << 10)
    res = {}
    for dist in ("zipf", "uniform"):
        st = dht_create(cfg, device=device)
        st, ws = dht_write(st, ukeys, uvals)
        check(int(ws["dropped"]) == 0, "l1-ref: table write dropped rows")
        l1 = l1_create(L1Config(n_sets=1024, n_ways=4), s, device=device)
        batches = []
        for _ in range(4):
            ids = (rng.zipf(1.1, size=n) % universe if dist == "zipf"
                   else rng.integers(0, universe, size=n))
            batches.append(ukeys[torch.from_numpy(ids).to(device)])
        steps = []
        for kb in batches:
            st, l1, cv, cf, cs = dht_read_cached(st, l1, kb)
            _, pv, pf, ps = dht_read(st.clone(), kb)
            check(torch.equal(cv, pv) and torch.equal(cf, pf),
                  f"l1-ref {dist} on {device}: cached differs from uncached")
            steps.append({"vals": cv.cpu(), "found": cf.cpu(),
                          "l1_hits": int(cs["l1_hits"]),
                          "wire_words": cs["wire_words"],
                          "wire_uncached": ps["wire_words"]})
        res[dist] = (steps, l1_to_numpy(l1))
    return res


def _l1_ref():
    """(b) l1-ref: card against CPU, batch by batch, and the reference's
    gates on the Zipf stream."""
    import torch

    card, cpu = _l1_ref_stream(DEVICE), _l1_ref_stream("cpu")
    out = {}
    for dist in ("zipf", "uniform"):
        (cs, cl), (ps, pl) = card[dist], cpu[dist]
        equal = all(torch.equal(a[k], b[k]) for a, b in zip(cs, ps)
                    for k in ("vals", "found"))
        equal &= all(a[k] == b[k] for a, b in zip(cs, ps)
                     for k in ("l1_hits", "wire_words"))
        equal &= all((cl[k] == pl[k]).all() for k in pl)
        check(equal, f"l1-ref {dist}: card and CPU differ")
        hits = sum(b["l1_hits"] for b in cs[1:])
        wire_c = sum(b["wire_words"] for b in cs[1:])
        wire_p = sum(b["wire_uncached"] for b in cs[1:])
        out[dist] = {"l1_hit_frac": hits / (3 * 2048),
                     "wire_ratio": wire_p / wire_c,
                     "l1_hits": [b["l1_hits"] for b in cs],
                     "card_equals_cpu": equal}
    z = out["zipf"]
    check(z["l1_hit_frac"] >= 0.5 and z["wire_ratio"] >= 1.5,
          f"l1-ref zipf misses the reference's gates: {z}")
    emit("l1_ref", S=8, B=1 << 10, universe=2048, batch=2048, batches=4,
         gates="zipf l1_hit_frac >= 0.5, wire_ratio >= 1.5 (batches 1..3)",
         streams=out)


def _modes_stream(mode, device):
    """The B=2^16 stream's first MODE_KEYS keys in small batches under
    one locking schedule: writes, one read, 95/5 mixed and migrate."""
    import torch

    from repro_torch.convert import state_to_numpy
    from repro_torch.core import (DHTConfig, dht_create, dht_execute,
                                  migrate_ops, mixed_ops, read_ops,
                                  write_ops)

    cfg = DHTConfig(key_words=20, val_words=26, n_shards=8,
                    buckets_per_shard=SMALL_BUCKETS, mode=mode)
    keys, vals, mk, mv, op = _stream(cfg, device, seed=1)
    n, h = MODE_KEYS, MODE_KEYS // 2
    # the migrate/mixed keys: half stored, half fresh, as in the stream
    mk = torch.cat([mk[:h], mk[N_KEYS // 2:N_KEYS // 2 + h]])
    keys, vals, mv, op = keys[:n], vals[:n], mv[:n], op[:n]
    st = dht_create(cfg, device=device)
    b = MODE_BATCH
    plan = [("write", write_ops(keys[i:i + b], vals[i:i + b]), ("write",))
            for i in range(0, n, b)]
    plan.append(("read", read_ops(keys), ("read",)))
    plan += [("mixed_95_5", mixed_ops(op[i:i + b], mk[i:i + b], mv[i:i + b]),
              ("read", "write")) for i in range(0, n, b)]
    plan += [("migrate", migrate_ops(mk[i:i + b], mv[i:i + b]), ("migrate",))
             for i in range(0, n, b)]
    rec = []
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for kind, ops, kinds in plan:
        st, _, v, f, code, es = dht_execute(st, ops, kinds=kinds)
        rec.append((kind, code.cpu(), es["rounds"], es["lock_tokens"],
                    int(es["dropped"])))
    secs = time.perf_counter() - t0
    return state_to_numpy(st), rec, secs


def _modes_parity():
    """(c) modes-parity: the three schedules, card against CPU."""
    out = {}
    for mode in ("lockfree", "fine", "coarse"):
        (tc, rc, sc), (tp, rp, sp) = (_modes_stream(mode, DEVICE),
                                      _modes_stream(mode, "cpu"))
        tables = all((tc[k] == tp[k]).all() for k in tp)
        items = all(a[0] == b[0] and bool((a[1] == b[1]).all())
                    and a[2:] == b[2:] for a, b in zip(rc, rp))
        check(tables and items, f"modes-parity {mode}: card and CPU differ "
                                f"(tables {tables}, items {items})")
        check(not any(r[4] for r in rc), f"modes-parity {mode}: dropped")
        kinds = {}
        for kind, _c, rounds, tok, _d in rc:
            k = kinds.setdefault(kind, {"rounds": [], "lock_tokens": []})
            k["rounds"].append(rounds)
            k["lock_tokens"].append(tok)
        out[mode] = {"card_s": sc, "cpu_s": sp, "equal": True, **kinds}
    check(sum(out["fine"]["write"]["rounds"])
          < sum(out["coarse"]["write"]["rounds"]),
          "modes-parity: coarse took no more write rounds than fine")
    emit("modes_parity", B=SMALL_BUCKETS, S=8, keys=MODE_KEYS,
         write_batch=MODE_BATCH, modes=out)


def _lookup_cached():
    """(d) lookup_cached on POET-shaped rows against lookup."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "examples"))
    from torch_poet_reactive_transport import (N_IN, N_OUT, PoetConfig,
                                               chemistry, initial_state)

    from repro_torch.core import (DHTConfig, L1Config, SurrogateConfig,
                                  l1_create, lookup, lookup_cached, store,
                                  surrogate_create)

    pc = PoetConfig()
    scfg = SurrogateConfig(
        n_inputs=N_IN, n_outputs=N_OUT, sig_digits=pc.sig_digits,
        dht=DHTConfig(key_words=20, val_words=26, n_shards=pc.dht_shards,
                      buckets_per_shard=pc.dht_buckets, mode=pc.dht_mode))
    rng = np.random.default_rng(31)
    base = initial_state(pc, "cpu")[:1].repeat(POET_STATES, 1)
    scale = torch.from_numpy(10.0 ** rng.uniform(-1, 1, size=(POET_STATES,
                                                              9)))
    states = torch.cat([base * scale.to(torch.float32),
                        torch.full((POET_STATES, 1), pc.dt)], dim=1)
    states = states.to(DEVICE)
    rows = states[torch.from_numpy(rng.integers(0, POET_STATES,
                                                N_KEYS)).to(DEVICE)]
    st = surrogate_create(scfg, device=DEVICE)
    known = POET_STATES * 3 // 4
    st, ws = store(scfg, st, states[:known], chemistry(states[:known]))
    check(int(ws["dropped"]) == 0, "lookup_cached: store dropped rows")
    l1 = l1_create(L1Config(n_sets=1024, n_ways=4), scfg.dht.n_shards,
                   device=DEVICE)
    calls = []
    for _ in range(2):
        st, l1, out, found, cs = lookup_cached(scfg, st, l1, rows)
        _, ref_out, ref_found, _ = lookup(scfg, st, rows)
        check(torch.equal(out.view(torch.int32), ref_out.view(torch.int32))
              and torch.equal(found, ref_found),
              "lookup_cached differs from lookup")
        calls.append({"l1_hits": int(cs["l1_hits"]),
                      "found": int(found.sum()),
                      "wire_words": cs["wire_words"]})
    check(calls[1]["l1_hits"] > 0, "lookup_cached: second call had no L1 hit")
    check(0 < calls[1]["found"] < N_KEYS, "lookup_cached: found all or none")
    emit("l1_lookup_cached", rows=N_KEYS, states=POET_STATES,
         stored_states=known, sig_digits=scfg.sig_digits,
         S=scfg.dht.n_shards, B=scfg.dht.buckets_per_shard, calls=calls)


def phase_l1(cfg_big, errs):
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    _l1_full(cfg_big, errs)
    _l1_ref()
    _modes_parity()
    _lookup_cached()
    torch.cuda.synchronize()
    launches = ops.launches()
    emit("l1", launches=launches)
    return launches


# ---------------------------------------------------------------------------
# the lm phase: gemma3-12b prefill and decode, local layers on the kernel
# ---------------------------------------------------------------------------

def zipf_ids(gen, n: int, universe: int, s: float = 1.1):
    """(n,) int64 Zipf(s) ranks over [0, universe), by inverse CDF over a
    seeded torch generator's uniforms, so the stream does not depend on
    numpy's version (F7 in ROADMAP.md)."""
    import torch

    w = torch.arange(1, universe + 1, dtype=torch.float64) ** -s
    cdf = torch.cumsum(w, 0)
    u = torch.rand(n, generator=gen, dtype=torch.float64) * cdf[-1]
    return torch.searchsorted(cdf, u).clamp(max=universe - 1)


def pipe_inputs(ids, device):
    """(n,) ids -> (n, 10) float32 POET-shaped inputs whose values carry 3
    significant digits (100..999), so key rounding keeps them and
    distinct ids give distinct keys."""
    import torch

    x = torch.full((ids.shape[0], 10), 5.0, dtype=torch.float32)
    for j in range(3):
        x[:, j] = (100 + (ids // 900 ** j) % 900).to(torch.float32)
    x[:, 9] = 0.25
    return x.to(device)


def pipe_value(x):
    """The pipeline streams' stored function: (n, 10) -> (n, 13), exact
    in float32 (a doubling and a +1)."""
    return x[:, list(range(10)) + [0, 1, 2]] * 2.0 + 1.0


def slab_digest(st) -> list:
    """Position-weighted sums (int64, wrapping) of the words of the four
    slab arrays (without the dump row): equal tables give equal
    digests."""
    import torch

    out = []
    for t in (st.keys, st.vals, st.meta, st.csum):
        flat = t.reshape(-1)
        acc = torch.zeros((), dtype=torch.int64, device=flat.device)
        for lo in range(0, flat.numel(), 1 << 26):
            x = flat[lo:lo + (1 << 26)].to(torch.int64) & 0xFFFFFFFF
            w = torch.arange(lo, lo + x.numel(), dtype=torch.int64,
                             device=flat.device) * 2 + 1
            acc += (x * w).sum()
        out.append(int(acc))
    return out


def issue_syncs(issue):
    """Host syncs the card reports while ``issue()`` runs (sync debug
    mode): their count, the Python lines that made them, and the handle
    ``issue()`` returned."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rnd = issue()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    return len(sites), sites, rnd


def _pipe_syncs(scfg):
    """Syncs of each kind of issue half at N_KEYS rows on the full table:
    a read, a read through a non-empty pending filter, a write and a
    95/5 mixed round; and of the read's commit half."""
    import torch

    from repro_torch.core import (PendingWrites, dht_commit, dht_issue,
                                  dht_read_async, dht_read_commit,
                                  dht_write_async, dht_write_commit,
                                  make_keys, mixed_ops, surrogate_create)

    st = surrogate_create(scfg, device=DEVICE)
    gen = torch.Generator().manual_seed(41)
    keys = make_keys(scfg, pipe_inputs(torch.randint(
        0, PIPE_UNIFORM_IDS, (N_KEYS,), generator=gen), DEVICE))
    vals = words(gen, N_KEYS, scfg.dht.val_words, DEVICE)
    op = (torch.rand(N_KEYS, generator=gen) < 0.05).to(torch.int32).to(
        DEVICE)
    pend = PendingWrites(scfg.dht.val_words)
    pend.promise(keys[: N_KEYS // 2])
    pend.publish(keys[: N_KEYS // 2], vals[: N_KEYS // 2])
    out, sites = {}, {}
    out["write"], sites["write"], w = issue_syncs(
        lambda: dht_write_async(st, keys, vals))
    dht_write_commit(w)
    out["read"], sites["read"], r = issue_syncs(
        lambda: dht_read_async(st, keys))
    torch.cuda.synchronize()
    out["read_commit"], sites["read_commit"], _ = issue_syncs(
        lambda: dht_read_commit(r))
    out["read_pending"], sites["read_pending"], r = issue_syncs(
        lambda: dht_read_async(st, keys, pending=pend))
    dht_read_commit(r)
    out["mixed_95_5"], sites["mixed_95_5"], m = issue_syncs(
        lambda: dht_issue(st, mixed_ops(op, keys, vals),
                          kinds=("read", "write")))
    dht_commit(m)
    del st
    return out, sites


def _pipe_full(cfg_big):
    """(a) pipeline-full: depth 1 against depth 2 on the full table."""
    import torch

    from repro_torch.core import (SurrogateConfig, dht_read, dht_write,
                                  lookup_or_compute_pipelined, make_keys,
                                  pack_floats, surrogate_create)
    from repro_torch.core import dht as dht_mod

    scfg = SurrogateConfig(n_inputs=10, n_outputs=13, sig_digits=3,
                           dht=cfg_big)
    # calibrate the modelled solver stall on one read + write round
    st = surrogate_create(scfg, device=DEVICE)
    gen = torch.Generator().manual_seed(40)
    x = pipe_inputs(torch.randint(0, PIPE_UNIFORM_IDS, (N_KEYS,),
                                  generator=gen), DEVICE)
    keys, vals = make_keys(scfg, x), pack_floats(pipe_value(x), 26)
    round_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dht_read(st, keys)
        dht_write(st, keys, vals)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
    t_round = min(round_ms[1:]) / 1e3
    stall = PIPE_STALL_RATIO * t_round
    del st

    def compute(inp):
        out = pipe_value(inp)          # measured: the card's value function
        time.sleep(stall)              # modelled: the solver's wall time
        return out

    commits = []
    orig_commit = dht_mod.dht_read_commit

    def noted_commit(rnd):
        res = orig_commit(rnd)
        commits.append(rnd.telemetry)
        return res

    gen = torch.Generator().manual_seed(42)
    streams = {
        "zipf": [zipf_ids(gen, N_KEYS, PIPE_ZIPF_IDS)
                 for _ in range(PIPE_BATCHES)],
        "uniform": [torch.randint(0, PIPE_UNIFORM_IDS, (N_KEYS,),
                                  generator=gen)
                    for _ in range(PIPE_BATCHES)]}
    result = {}
    for dist, ids in streams.items():
        batches = [pipe_inputs(i, DEVICE) for i in ids]
        runs = {}
        for depth in (1, 2):
            st = surrogate_create(scfg, device=DEVICE)
            commits.clear()
            torch.cuda.synchronize()
            dht_mod.dht_read_commit = noted_commit
            try:
                t0 = time.perf_counter()
                st, outs, founds, stats = lookup_or_compute_pipelined(
                    scfg, st, batches, compute, depth=depth)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                dht_mod.dht_read_commit = orig_commit
            runs[depth] = {
                "wall_s": wall, "stats": stats, "digest": slab_digest(st),
                "outs": torch.stack(outs).view(torch.int32),
                "found": torch.stack(founds),
                "overlap": [c["overlap_frac"] for c in commits],
                "commit_wait_us": [c["commit_wait_us"] for c in commits]}
            del st, outs, founds
        one, two = runs[1], runs[2]
        same = {"outputs": torch.equal(one["outs"], two["outs"]),
                "found": torch.equal(one["found"], two["found"]),
                "slab_digest": one["digest"] == two["digest"]}
        for k in ("hits", "misses", "stored"):
            same[k] = one["stats"][k] == two["stats"][k]
        s2 = two["stats"]
        result[dist] = {
            "batches": PIPE_BATCHES, "rows": N_KEYS,
            "wall_s_depth1": one["wall_s"], "wall_s_depth2": two["wall_s"],
            "stats_depth1": one["stats"], "stats_depth2": s2,
            "equal": same,
            "depth2_read_commits": len(two["overlap"]),
            "depth2_overlap_frac_mean": statistics.mean(two["overlap"]),
            "depth2_commit_wait_us_median": statistics.median(
                two["commit_wait_us"])}
        check(all(same.values()), f"pipeline-full {dist}: depth 1 and "
                                  f"depth 2 differ {same}")
        check(s2["requeued"] == 0 and one["stats"]["requeued"] == 0,
              f"pipeline-full {dist}: rows re-issued")
        check(dist != "zipf" or s2["forwarded"] > 0,
              "pipeline-full zipf: nothing was forwarded")
        del runs, one, two, batches
    syncs, sites = _pipe_syncs(scfg)
    emit("pipeline_full", S=cfg_big.n_shards, B=cfg_big.buckets_per_shard,
         sig_digits=scfg.sig_digits,
         measured="the walls, the card's value function, the overlap",
         modelled=f"a host sleep of {stall * 1e3:.3f} ms per miss batch "
                  f"({PIPE_STALL_RATIO} x the read+write round)",
         read_write_round_ms=round_ms, streams=result,
         syncs_per_issue_half=syncs, sync_sites=sites)


def _pipe_stream(mode, device):
    """(b) the depth-2 Zipf stream at B=2^16 on ``device``: outputs,
    found flags, stats and slab words."""
    import torch

    from repro_torch.convert import state_to_numpy
    from repro_torch.core import (DHTConfig, SurrogateConfig,
                                  lookup_or_compute_pipelined,
                                  surrogate_create)

    scfg = SurrogateConfig(n_inputs=10, n_outputs=13, sig_digits=3,
                           dht=DHTConfig(n_shards=8, mode=mode,
                                         buckets_per_shard=SMALL_BUCKETS))
    gen = torch.Generator().manual_seed(43)
    batches = [pipe_inputs(zipf_ids(gen, PIPE_PARITY_ROWS, PIPE_ZIPF_IDS),
                           device) for _ in range(PIPE_PARITY_BATCHES)]
    st = surrogate_create(scfg, device=device)
    st, outs, founds, stats = lookup_or_compute_pipelined(
        scfg, st, batches, pipe_value, depth=2)
    return (state_to_numpy(st), torch.stack(outs).view(torch.int32).cpu(),
            torch.stack(founds).cpu(), stats)


def phase_pipeline(cfg_big, poet_plain):
    import torch

    sys.path.insert(0, str(ROOT / "examples"))
    from torch_poet_reactive_transport import PoetConfig, run_simulation

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    _pipe_full(cfg_big)

    parity = {}
    for mode in ("lockfree", "fine", "coarse"):
        card, cpu = _pipe_stream(mode, DEVICE), _pipe_stream(mode, "cpu")
        eq = {"slab": all((card[0][k] == cpu[0][k]).all() for k in cpu[0]),
              "outputs": torch.equal(card[1], cpu[1]),
              "found": torch.equal(card[2], cpu[2]),
              "stats": card[3] == cpu[3]}
        parity[mode] = {"equal": eq, "stats": card[3]}
        check(all(eq.values()), f"pipeline-parity {mode}: card and CPU "
                                f"differ {eq}")
        check(card[3]["forwarded"] > 0,
              f"pipeline-parity {mode}: nothing was forwarded")
    emit("pipeline_parity", B=SMALL_BUCKETS, rows=PIPE_PARITY_ROWS,
         batches=PIPE_PARITY_BATCHES, depth=2, modes=parity)

    # (c) the POET twin with --pipeline, beside phase 6's plain run
    cfg = PoetConfig(n_steps=POET_STEPS, use_pipeline=True)
    torch.cuda.synchronize()
    res = run_simulation(cfg, use_dht=True, device=DEVICE)
    torch.cuda.synchronize()
    launches = ops.launches()
    conc = res["conc"]
    check(conc.shape == (cfg.nx * cfg.ny, 9)
          and bool(torch.isfinite(conc).all()), "pipeline poet: bad conc")
    for k in ("hits", "misses"):
        check(res[k] == poet_plain[k], f"pipeline poet: {k} {res[k]} "
                                       f"against {poet_plain[k]} plain")
    # the pipelined driver solves a whole batch when it holds a miss (as
    # the reference's does), the plain loop only the missed rows
    check(res["chem_calls"] >= poet_plain["chem_calls"],
          "pipeline poet: fewer solver rows than missed rows")
    emit("pipeline_poet", grid=[cfg.nx, cfg.ny],
         n_steps=f"{cfg.n_steps} of {PoetConfig.n_steps}",
         hits=res["hits"], misses=res["misses"],
         chem_calls=res["chem_calls"], wall_s=res["wall_s"],
         plain={k: poet_plain[k] for k in ("hits", "misses", "chem_calls",
                                           "wall_s")},
         max_abs_dconc_vs_plain=float(
             (conc - poet_plain["conc"]).abs().max()),
         note="the twin's chemistry is launch-bound on the card (F8): "
              "this wall is not a pipeline measurement; solver rows count "
              "whole batches holding a miss, as in the reference")
    return launches


# ---------------------------------------------------------------------------
# elastic: membership changes and online resharding on the full table
# ---------------------------------------------------------------------------

def _n_live(st) -> int:
    from repro_torch.core import dht_occupancy

    return int(dht_occupancy(st)["live_per_shard"].sum())


def _elastic_readable(st, keys, vals):
    """(n,) bool on the card: the keys that read back found, with their
    value, in rounds of N_KEYS."""
    import torch

    from repro_torch.core import dht_read

    ok = torch.empty(keys.shape[0], dtype=torch.bool, device=keys.device)
    for lo in range(0, keys.shape[0], N_KEYS):
        hi = lo + N_KEYS
        _, out, found, _ = dht_read(st, keys[lo:hi])
        ok[lo:hi] = found & (out == vals[lo:hi]).all(dim=-1)
    return ok


def _elastic_change(name, st, stats, keys, vals, ok, secs):
    """Every entry that read back before the change reads back after it
    but those ``evicted_at_dest`` counts; the live count falls by exactly
    that many; part, not all, of the table moved."""
    now = _elastic_readable(st, keys, vals)
    lost = int((ok & ~now).sum())
    n_live = _n_live(st)
    ev = stats["evicted_at_dest"]
    check(lost <= ev, f"elastic {name}: {lost} readable entries lost, "
                      f"{ev} counted as evicted at the destination")
    check(n_live == stats["n_live"] - ev,
          f"elastic {name}: {n_live} live after, {stats['n_live']} before, "
          f"{ev} evicted")
    check(0 < stats["moved"] < stats["n_live"],
          f"elastic {name}: moved {stats['moved']} of {stats['n_live']}")
    return ok & now, {**stats, "lost": lost, "live_after": n_live,
                      "readable_after": int((ok & now).sum()),
                      "wall_s": secs}


def _elastic_full(cfg_big, errs):
    """(a) elastic-full: dht-full's table on a ring of 8, filled with
    ELASTIC_KEYS entries; shard 7 leaves and joins, the table grows to 16
    shards step by step with a dual read between the steps, then shrinks
    back to 8.  Every kernel call of the grow's plan (``hash64`` over all
    S*B stored keys), first step and first dual read, and of the shrink's
    plan (S*B = 2^25 keys), is held against its plain version."""
    import torch

    from repro_torch.core import (dht_create, dht_read, dht_resize,
                                  dht_write, migration_begin,
                                  migration_finish, migration_read,
                                  migration_step, occupancy,
                                  plan_migration, ring_create, ring_resize,
                                  shard_join, shard_leave)
    from repro_torch.kernels import ops

    st = dht_create(cfg_big, ring_create(cfg_big.n_shards), device=DEVICE)
    gen = torch.Generator().manual_seed(80)
    keys = words(gen, ELASTIC_KEYS, cfg_big.key_words, DEVICE)
    vals = words(gen, ELASTIC_KEYS, cfg_big.val_words, DEVICE)
    fill_evicted = 0
    for lo in range(0, ELASTIC_KEYS, N_KEYS):
        _, ws = dht_write(st, keys[lo:lo + N_KEYS], vals[lo:lo + N_KEYS])
        fill_evicted += int(ws["evicted"])
    ok = _elastic_readable(st, keys, vals)
    res = {"fill": {"entries": ELASTIC_KEYS, "readable": int(ok.sum()),
                    "evicted_at_fill": fill_evicted, "live": _n_live(st)}}

    (st, ls), secs = _timed(
        lambda: shard_leave(st, 7, batch=ELASTIC_BATCH))
    check(float(occupancy(st)[7]) == 0.0, "elastic leave: shard 7 not empty")
    ok, res["leave"] = _elastic_change("leave", st, ls, keys, vals, ok, secs)
    (st, js), secs = _timed(
        lambda: shard_join(st, 7, batch=ELASTIC_BATCH))
    check(float(occupancy(st)[7]) > 0.0, "elastic join: shard 7 empty")
    ok, res["join"] = _elastic_change("join", st, js, keys, vals, ok, secs)

    # the grow to 16, driven step by step
    wide = dataclasses.replace(cfg_big, n_shards=2 * cfg_big.n_shards)
    new_ring = ring_resize(st.ring, wide.n_shards)
    plan_ms = []
    for _ in range(3):
        _, secs = _timed(lambda: plan_migration(st, new_ring, wide))
        plan_ms.append(secs * 1e3)
    read_keys = keys[ok][:ELASTIC_READS]
    read_vals = vals[ok][:ELASTIC_READS]
    with Capture(ops) as cap:
        mig, secs = _timed(lambda: migration_begin(
            st, new_ring, wide, batch=ELASTIC_BATCH))
        begin_ms = secs * 1e3
        (mig, _), secs = _timed(lambda: migration_step(mig))
        mig, out, found, ds = migration_read(mig, read_keys)
    compare_calls(cap.calls, errs, "elastic grow: plan, step 1, dual read")
    del cap
    step_ms = [secs * 1e3]
    check(bool(found.all()) and torch.equal(out, read_vals),
          "elastic dual read: an entry in flight was lost")
    hits_old = int(ds["hits_old_epoch"])
    check(hits_old > 0, "elastic dual read: no hit from the old epoch")
    # dual read beside a plain read of the same keys, in turns
    dual_ms, plain_ms = [], []
    for _ in range(ELASTIC_TIMING_REPS):
        _, secs = _timed(lambda: migration_read(mig, read_keys))
        dual_ms.append(secs * 1e3)
        _, secs = _timed(lambda: dht_read(mig.new, read_keys))
        plain_ms.append(secs * 1e3)
    n_reads = 1
    while not mig.done:
        (mig, _), secs = _timed(lambda: migration_step(mig))
        step_ms.append(secs * 1e3)
        mig, out, found, ds = migration_read(mig, read_keys)
        n_reads += 1
        check(bool(found.all()) and torch.equal(out, read_vals),
              "elastic dual read: an entry in flight was lost")
    (st, gs), secs = _timed(lambda: migration_finish(mig))
    del mig
    check(st.cfg.n_shards == wide.n_shards, "elastic grow: shard count")
    ok, res["grow"] = _elastic_change("grow", st, gs, keys, vals, ok,
                                      sum(step_ms) / 1e3)
    res["grow"].update(
        plan_ms=plan_ms, begin_ms=begin_ms, finish_ms=secs * 1e3,
        steps=len(step_ms), step_ms_median=statistics.median(step_ms),
        step_ms_all=step_ms,
        entries_per_s=gs["moved"] / (sum(step_ms) / 1e3),
        dual_reads=n_reads, first_read_hits_old_epoch=hits_old,
        dual_read_ms_median=statistics.median(dual_ms),
        dual_read_ms_all=dual_ms,
        plain_read_ms_median=statistics.median(plain_ms),
        plain_read_ms_all=plain_ms)

    # the shrink back to 8: its plan hashes all 2^25 stored keys
    with Capture(ops) as cap:
        plan_migration(st, ring_resize(st.ring, cfg_big.n_shards), cfg_big)
    compare_calls({"hash64": cap.calls["hash64"]}, errs,
                  "elastic shrink plan: hash64 over S*B keys")
    del cap
    (st, ss), secs = _timed(
        lambda: dht_resize(st, cfg_big.n_shards, batch=ELASTIC_BATCH))
    check(st.flat_meta.shape[0] == cfg_big.n_shards
          * cfg_big.buckets_per_shard + 1, "elastic shrink: rows not freed")
    ok, res["shrink"] = _elastic_change("shrink", st, ss, keys, vals, ok,
                                        secs)
    del st
    return res


def _elastic_stream(device):
    """(b) elastic-parity: the same sequence at B=2^12 with
    ELASTIC_PARITY_KEYS entries and 64 POET-shaped surrogate rows, steps
    of 256 rows, plus the locality tier (a cached read before the leave,
    twice, and after it: the epoch flush) and the surrogate's dual-epoch
    queries after the grow's first step.  Returns the slab words after
    each change, every read's outputs and counts, and the stats."""
    import torch

    from repro_torch.convert import state_to_numpy
    from repro_torch.core import (DHTConfig, InterpConfig, L1Config,
                                  SurrogateConfig, dht_create,
                                  dht_read_cached, dht_resize, dht_write,
                                  l1_create, lookup, lookup_or_interpolate,
                                  migration_begin, migration_finish,
                                  migration_read, migration_step,
                                  ring_create, ring_resize, shard_join,
                                  shard_leave, store)

    cfg = DHTConfig(key_words=20, val_words=26, n_shards=8,
                    buckets_per_shard=ELASTIC_PARITY_BUCKETS)
    scfg = SurrogateConfig(n_inputs=10, n_outputs=13, sig_digits=3, dht=cfg)
    gen = torch.Generator().manual_seed(81)
    keys = words(gen, ELASTIC_PARITY_KEYS, cfg.key_words, device)
    vals = words(gen, ELASTIC_PARITY_KEYS, cfg.val_words, device)
    centres, nbrs = _bracketed(scfg, 32, device, seed=82)
    st = dht_create(cfg, ring_create(8), device=device)
    dht_write(st, keys, vals)
    store(scfg, st, nbrs, interp_fn(nbrs))
    l1 = l1_create(L1Config(n_sets=256, n_ways=4), 16, device=device)
    out = {"slabs": [], "reads": [], "stats": []}

    def snap(stats):
        out["slabs"].append({k: v.copy()
                             for k, v in state_to_numpy(st).items()})
        out["stats"].append(stats)

    def cached():
        nonlocal st, l1
        st, l1, o, f, s = dht_read_cached(st, l1, keys[:512])
        out["reads"].append((o.cpu(), f.cpu(), int(s["l1_hits"])))

    cached()
    cached()
    st, stats = shard_leave(st, 7, batch=ELASTIC_PARITY_BATCH)
    snap(stats)
    cached()
    st, stats = shard_join(st, 7, batch=ELASTIC_PARITY_BATCH)
    snap(stats)
    mig = migration_begin(st, ring_resize(st.ring, 16),
                          dataclasses.replace(cfg, n_shards=16),
                          batch=ELASTIC_PARITY_BATCH)
    first = True
    while not mig.done:
        mig, step = migration_step(mig)
        mig, o, f, ds = migration_read(mig, keys)
        out["reads"].append((o.cpu(), f.cpu(), int(ds["hits"]),
                             int(ds["hits_old_epoch"]), step))
        if first:
            _, o, f, s = lookup(scfg, mig.new, nbrs, prev=mig.old)
            out["reads"].append((o.cpu(), f.cpu(), int(s["hits_old_epoch"])))
            _, _, o, p, s = lookup_or_interpolate(
                scfg, mig.new, centres, InterpConfig(), prev=mig.old)
            out["reads"].append((o.cpu(), p.cpu(), int(s["interpolated"])))
            first = False
    st, stats = migration_finish(mig)
    snap(stats)
    st, stats = dht_resize(st, 8, batch=ELASTIC_PARITY_BATCH)
    snap(stats)
    return out


def _same(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def phase_elastic(cfg_big, errs):
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    full = _elastic_full(cfg_big, errs)
    card = _elastic_stream(DEVICE)
    torch.cuda.synchronize()
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    g = full["grow"]
    check(g["first_read_hits_old_epoch"] > 0, "elastic: no old-epoch hit")
    emit("elastic", S=cfg_big.n_shards, B=cfg_big.buckets_per_shard,
         grown_to=2 * cfg_big.n_shards, entries=ELASTIC_KEYS,
         batch=ELASTIC_BATCH, batch_note="cut from the reference's "
         "DEFAULT_BATCH of 256, which would take ~8,000 rounds here",
         max_memory_allocated_gb=peak / 1e9, launches=launches, **full)
    print(f"elastic plan ms (hash64 + ring lookup + nonzero over "
          f"{cfg_big.n_shards * cfg_big.buckets_per_shard} buckets): "
          f"{statistics.median(g['plan_ms'])}", flush=True)
    print(f"elastic migrate round ms (median of {g['steps']}): "
          f"{g['step_ms_median']}; entries per second: "
          f"{g['entries_per_s']}", flush=True)
    print(f"elastic dual read ms (2^16 keys, median of "
          f"{ELASTIC_TIMING_REPS}): {g['dual_read_ms_median']} beside a "
          f"plain read of the same keys: {g['plain_read_ms_median']}",
          flush=True)
    print(f"elastic peak memory GB: {peak / 1e9}", flush=True)

    cpu = _elastic_stream("cpu")
    eq = {"slabs": all(all((a[k] == b[k]).all() for k in a)
                       for a, b in zip(card["slabs"], cpu["slabs"])),
          "reads": _same(card["reads"], cpu["reads"]),
          "stats": card["stats"] == cpu["stats"]}
    check(all(eq.values()), f"elastic-parity: card and CPU differ {eq}")
    check(card["reads"][1][2] > 0 and card["reads"][2][2] == 0,
          "elastic-parity: the L1 did not serve, or served across the "
          "epoch change")
    emit("elastic_parity", B=ELASTIC_PARITY_BUCKETS,
         entries=ELASTIC_PARITY_KEYS, batch=ELASTIC_PARITY_BATCH,
         equal=eq, stats=card["stats"], reads=len(card["reads"]))
    return launches


# ---------------------------------------------------------------------------
# faults: k-successor replication, crash failover, anti-entropy repair
# ---------------------------------------------------------------------------

def fault_workload(gen, n: int, device, uniform_ids: int = FAULT_ID_RANGE):
    """bench_crash.py's mix over the paper's 712,500-id range: the first
    half Zipf(0.99) ids (``zipf_ids``, F7), the second half uniform ids
    (below ``uniform_ids``);
    key words from the id as ``benchmarks/common.make_keys_vals``
    makes them, values a pure function of the key (a duplicate write is
    idempotent, a read is checkable).  Returns ``(ids, keys, vals)``."""
    import torch

    from repro_torch.core.layout import MASK32, to_i32

    z = zipf_ids(gen, n // 2, FAULT_ID_RANGE, s=0.99)
    u = torch.randint(0, uniform_ids, (n - n // 2,), generator=gen)
    ids = torch.cat([z, u])
    w = torch.arange(20, dtype=torch.int64)
    keys = (ids[:, None] * (w * 2654435761 + 1)) & MASK32
    keys[:, 0] = ids & MASK32
    keys[:, 1] = ids >> 32
    v = torch.arange(26, dtype=torch.int64)
    vals = (keys[:, :1] * (2 * v + 1) * 2654435761 + v) & MASK32
    return ids, to_i32(keys).to(device), to_i32(vals).to(device)


def _read_ok(st, keys, vals, rows: int = FAULT_BATCH):
    """Per row: found, and the value equal; the rounds' fallback_reads
    summed; each round's ms."""
    import torch

    from repro_torch.core import dht_read

    found = torch.empty(keys.shape[0], dtype=torch.bool, device=keys.device)
    equal = torch.empty_like(found)
    fallback, ms = 0, []
    for lo in range(0, keys.shape[0], rows):
        (_, out, f, rs), secs = _timed(lambda: dht_read(st, keys[lo:lo + rows]))
        found[lo:lo + rows] = f
        equal[lo:lo + rows] = (out == vals[lo:lo + rows]).all(dim=-1)
        fallback += int(rs["fallback_reads"])
        ms.append(secs * 1e3)
    return found, found & equal, fallback, ms


def _overflowing(st, shard: int) -> int:
    """How many of the copies ``shard`` still lacks find their probe
    window there full of live entries of other keys (no repair pass can
    place them; the others were displaced by a later insert)."""
    import torch

    from repro_torch.core import plan_repair
    from repro_torch.core.hashing import base_bucket
    from repro_torch.core.layout import live_mask
    from repro_torch.kernels import ops

    src = plan_repair(st, shard).src
    if not src.numel():
        return 0
    cfg = st.cfg
    base = base_bucket(ops.hash64(st.flat_keys[src].contiguous())[:, 1],
                       cfg.buckets_per_shard, cfg.n_probe)
    win = (shard * cfg.buckets_per_shard + base.long()[:, None]
           + torch.arange(cfg.n_probe, device=base.device))
    return int(live_mask(st.flat_meta[win]).all(dim=-1).sum())


def _distinct(ids, mask) -> int:
    return int(ids[mask.cpu()].unique().numel())


def _faults_full(cfg_big, errs, uniform_ids: int):
    """(a) faults-full: dht-full's table with n_replicas=2 on a ring of 8
    beside the same table at k=1; FAULT_KEYS Zipf keys written before the
    crash of shard FAULT_VICTIM (wiped) and FAULT_KEYS uniform keys
    during the outage, in FAULT_BATCH-row rounds at capacity FAULT_BATCH;
    reads through the failover, the availability gap after the recovery,
    and repair_run.  The kernel calls of one
    replicated write, one outage read, the plan and the first repair
    round are held against their plain versions."""
    import torch

    from repro_torch.core import (W_DROPPED, crash_shard, dht_create,
                                  dht_read_async, dht_read_commit,
                                  dht_write, dht_write_replicated,
                                  plan_repair, recover_shard, repair_begin,
                                  repair_diff, repair_run, repair_step,
                                  ring_create)
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics

    cfg1 = dataclasses.replace(cfg_big, capacity=FAULT_BATCH)
    cfg2 = dataclasses.replace(cfg1, n_replicas=2)
    ring = ring_create(cfg_big.n_shards)
    st1 = dht_create(cfg1, ring, device=DEVICE)
    st2 = dht_create(cfg2, ring, device=DEVICE)
    gen = torch.Generator().manual_seed(90)
    ids, keys, vals = fault_workload(gen, 2 * FAULT_KEYS, DEVICE,
                                     uniform_ids)
    pre, post = slice(0, FAULT_KEYS), slice(FAULT_KEYS, 2 * FAULT_KEYS)
    res = {}

    # healthy writes: the same batches at k=1 and k=2, in turns
    w = {"k1_ms": [], "k2_ms": [], "k1_wire": 0, "k2_wire": 0,
         "k1_dispatches": 0, "k2_dispatches": 0, "k1_passes": [],
         "k2_passes": [], "acked": 0, "replica_writes": 0,
         "evicted_copies": 0, "dropped": 0}
    acked_pre = torch.empty(FAULT_KEYS, dtype=torch.bool, device=DEVICE)
    cap = Capture(ops)
    for lo in range(0, FAULT_KEYS, FAULT_BATCH):
        k, v = keys[lo:lo + FAULT_BATCH], vals[lo:lo + FAULT_BATCH]
        with metrics.counting() as d1:
            (_, ws1), s1 = _timed(lambda: dht_write(st1, k, v))
        with (metrics.counting() as d2,
              cap if lo == 0 else contextlib.nullcontext()):
            (_, ws2), s2 = _timed(lambda: dht_write_replicated(st2, k, v))
        w["k1_ms"].append(s1 * 1e3)
        w["k2_ms"].append(s2 * 1e3)
        w["k1_wire"] += int(ws1["wire_words"])
        w["k2_wire"] += int(ws2["wire_words"])
        w["k1_dispatches"] += d1.delta
        w["k2_dispatches"] += d2.delta
        w["k1_passes"].append(int(ws1["rounds"]))
        w["k2_passes"].append(int(ws2["rounds"]))
        for lane in ("acked", "replica_writes", "evicted_copies", "dropped"):
            w[lane] += int(ws2[lane])
        acked_pre[lo:lo + FAULT_BATCH] = ws2["code"] != W_DROPPED
    compare_calls(cap.calls, errs, "faults: a replicated write round")
    del cap
    extra_rounds = w["k2_dispatches"] - w["k1_dispatches"]
    wire_amp = w["k2_wire"] / w["k1_wire"]
    check(extra_rounds == 0, f"faults: {extra_rounds} extra write rounds")
    check(wire_amp == 2.0, f"faults: write wire amplification {wire_amp}")
    check(bool(acked_pre.all()) and w["dropped"] == 0,
          f"faults: healthy writes unacked or dropped ({w['dropped']})")
    res["writes"] = {
        "batches": FAULT_KEYS // FAULT_BATCH,
        "write_round_ms_k1_median": statistics.median(w["k1_ms"]),
        "write_round_ms_k2_median": statistics.median(w["k2_ms"]),
        "write_round_ms_k1_all": w["k1_ms"],
        "write_round_ms_k2_all": w["k2_ms"],
        "dispatch_rounds_k1": w["k1_dispatches"],
        "dispatch_rounds_k2": w["k2_dispatches"],
        "extra_write_rounds": extra_rounds, "wire_amp": wire_amp,
        "write_passes_k1": w["k1_passes"], "write_passes_k2": w["k2_passes"],
        "acked": w["acked"], "replica_writes": w["replica_writes"],
        "evicted_copies": w["evicted_copies"]}

    # healthy reads: k=2 moves what k=1 moves; nothing fails over
    _, ok1, _, r1_ms = _read_ok(st1, keys[pre], vals[pre])
    f2, ok_pre, fb2, r2_ms = _read_ok(st2, keys[pre], vals[pre])
    _, _, _, rs1 = dht_read_commit(dht_read_async(st1, keys[:FAULT_BATCH]))
    _, _, _, rs2 = dht_read_commit(dht_read_async(st2, keys[:FAULT_BATCH]))
    read_wire_ratio = int(rs2["wire_words"]) / int(rs1["wire_words"])
    check(read_wire_ratio == 1.0 and fb2 == 0,
          f"faults: healthy k=2 read wire ratio {read_wire_ratio}, "
          f"fallback {fb2}")
    # host syncs of an issue half: the replica select adds none (after
    # one call of each, which sets up torch's state)
    for st in (st1, st2):
        dht_read_commit(dht_read_async(st, keys[:FAULT_BATCH]))
    sy1, sites1, rnd = issue_syncs(
        lambda: dht_read_async(st1, keys[:FAULT_BATCH]))
    dht_read_commit(rnd)
    sy2, sites2, rnd = issue_syncs(
        lambda: dht_read_async(st2, keys[:FAULT_BATCH]))
    dht_read_commit(rnd)
    check(sy2 <= sy1, f"faults: a replicated read issue half syncs {sy2} "
                      f"times ({sites2}), a plain one {sy1} ({sites1})")
    wsy1, _, _ = issue_syncs(lambda: dht_write(st1, keys[:FAULT_BATCH],
                                               vals[:FAULT_BATCH]))
    wsy2, wsites2, _ = issue_syncs(lambda: dht_write_replicated(
        st2, keys[:FAULT_BATCH], vals[:FAULT_BATCH]))
    res["healthy_read"] = {
        "read_round_ms_k1_median": statistics.median(r1_ms),
        "read_round_ms_k2_median": statistics.median(r2_ms),
        "read_wire_ratio": read_wire_ratio, "fallback_reads": fb2,
        "readable_rows_k1": int(ok1.sum()),
        "readable_rows": int(ok_pre.sum()),
        "readable_keys": _distinct(ids[pre], ok_pre),
        "read_issue_syncs_k1": sy1, "read_issue_syncs_k2": sy2,
        "read_issue_sync_sites_k1": sites1,
        "read_issue_sync_sites_k2": sites2,
        "write_call_syncs_k1": wsy1, "write_call_syncs_k2": wsy2,
        "write_call_sync_sites_k2": wsites2}
    del st1

    # the crash, and reads through the failover
    st2, crash_s = _timed(lambda: crash_shard(st2, FAULT_VICTIM))
    with Capture(ops) as cap:
        _, _, fb, _ = _read_ok(st2, keys[:FAULT_BATCH], vals[:FAULT_BATCH])
    compare_calls(cap.calls, errs, "faults: an outage read round")
    del cap
    f_out, ok_out, fb_out, out_ms = _read_ok(st2, keys[pre], vals[pre])
    missing = ok_pre & ~ok_out
    wrong = f_out & ~ok_out
    check(int(wrong.sum()) == 0, "faults: an outage read returned a wrong "
                                 "value")
    check(_distinct(ids[pre], missing) <= w["evicted_copies"],
          f"faults: {int(missing.sum())} rows readable before the crash "
          f"missing during the outage, {w['evicted_copies']} copies evicted")
    check(fb_out > 0, "faults: no read failed over")
    res["outage"] = {
        "crash_ms": crash_s * 1e3,
        "read_round_ms_median": statistics.median(out_ms),
        "read_round_ms_all": out_ms, "fallback_reads": fb_out,
        "found_rows": int(f_out.sum()), "missing_rows": int(missing.sum()),
        "missing_keys": _distinct(ids[pre], missing)}

    # writes during the outage: the victim's copies are not sent
    acked_post = torch.empty(FAULT_KEYS, dtype=torch.bool, device=DEVICE)
    ev_post, post_ms = 0, []
    for lo in range(0, FAULT_KEYS, FAULT_BATCH):
        k = keys[post][lo:lo + FAULT_BATCH]
        v = vals[post][lo:lo + FAULT_BATCH]
        (_, ws), secs = _timed(lambda: dht_write_replicated(st2, k, v))
        acked_post[lo:lo + FAULT_BATCH] = ws["code"] != W_DROPPED
        ev_post += int(ws["evicted_copies"])
        post_ms.append(secs * 1e3)
    check(bool(acked_post.all()), "faults: a write during the outage was "
                                  "not acked")
    res["outage_writes"] = {"write_round_ms_median": statistics.median(post_ms),
                            "evicted_copies": ev_post}

    # recovery: the availability gap, then anti-entropy repair
    st2 = recover_shard(st2, FAULT_VICTIM)
    f_gap, _, _, _ = _read_ok(st2, keys, vals)
    plan_ms = []
    for _ in range(3):
        plan, secs = _timed(lambda: plan_repair(st2, FAULT_VICTIM))
        plan_ms.append(secs * 1e3)
    with Capture(ops) as cap:
        plan_repair(st2, FAULT_VICTIM)
        rep = repair_begin(st2, FAULT_VICTIM, batch=FAULT_BATCH)
        (rep, step), secs = _timed(lambda: repair_step(rep))
    compare_calls(cap.calls, errs, "faults: repair plan and first round")
    del cap
    step_ms = [secs * 1e3]
    while not rep.done:
        (rep, step), secs = _timed(lambda: repair_step(rep))
        step_ms.append(secs * 1e3)
    st2 = rep.state
    diff = repair_diff(st2, FAULT_VICTIM)
    if diff:
        # a repair insert that meets a full window evicts a copy there,
        # perhaps one healed before it: the missing copies and those of
        # them whose window is full, after this pass and two more
        passes = []
        for _ in range(3):
            passes.append({"diff": repair_diff(st2, FAULT_VICTIM),
                           "window_full": _overflowing(st2, FAULT_VICTIM)})
            st2, _ = repair_run(st2, FAULT_VICTIM, batch=FAULT_BATCH)
        emit("faults_diff", uniform_ids=uniform_ids, passes=passes)
    check(diff == 0, f"faults: repair left a diff of {diff}")
    _, ok_fin, fb_fin, _ = _read_ok(st2, keys, vals)
    acked = torch.cat([ok_pre, acked_post])
    lost = acked & ~ok_fin
    lost_keys = _distinct(ids, lost)
    evicted = w["evicted_copies"] + ev_post
    check(lost_keys <= evicted,
          f"faults: {lost_keys} acked keys lost, {evicted} copies evicted")
    check(fb_fin == 0, f"faults: {fb_fin} reads still fail over")
    res["repair"] = {
        "gap_rows": int((~f_gap).sum()), "gap_frac": float((~f_gap).float()
                                                          .mean()),
        "plan_ms_median": statistics.median(plan_ms), "plan_ms_all": plan_ms,
        "round_ms_median": statistics.median(step_ms),
        "round_ms_all": step_ms,
        "entries_per_s": rep.healed / (sum(step_ms) / 1e3),
        "n_candidates": rep.plan.n_candidates,
        "n_present": rep.plan.n_present, "n_planned": rep.plan.n_missing,
        "healed": rep.healed, "skipped": rep.skipped, "rounds": rep.rounds,
        "diff_after": diff}
    res["lost_acked"] = {"keys": lost_keys, "rows": int(lost.sum()),
                         "acked_keys": _distinct(ids, acked),
                         "evicted_copies_before_crash": w["evicted_copies"],
                         "evicted_copies_during_outage": ev_post}
    del st2
    return res


def _faults_stream(device):
    """(b) faults-parity: the faults-full sequence at B=2^16 with
    FAULT_PARITY_KEYS keys a half in FAULT_PARITY_BATCH-row rounds, and
    an L1 (256 x 4) read before and after the crash (its epoch fence).
    Returns the slab words after the writes, the outage writes and the
    repair, and every step's rows and counts."""
    import torch

    from repro_torch.convert import state_to_numpy
    from repro_torch.core import (DHTConfig, L1Config, crash_shard,
                                  dht_create, dht_read, dht_read_cached,
                                  dht_write_replicated, l1_create,
                                  plan_repair, recover_shard, repair_diff,
                                  repair_run, ring_create)

    cfg = DHTConfig(key_words=20, val_words=26, n_shards=8, n_replicas=2,
                    buckets_per_shard=FAULT_PARITY_BUCKETS,
                    capacity=FAULT_PARITY_BATCH)
    gen = torch.Generator().manual_seed(91)
    _, keys, vals = fault_workload(gen, 2 * FAULT_PARITY_KEYS, device)
    half = FAULT_PARITY_KEYS
    st = dht_create(cfg, ring_create(8), device=device)
    l1 = l1_create(L1Config(n_sets=256, n_ways=4), 8, device=device)
    out = {"slabs": [], "rows": [], "counts": []}

    def snap():
        out["slabs"].append({k: v.copy()
                             for k, v in state_to_numpy(st).items()})

    def writes(lo, hi):
        nonlocal st
        for a in range(lo, hi, FAULT_PARITY_BATCH):
            st, ws = dht_write_replicated(st, keys[a:a + FAULT_PARITY_BATCH],
                                          vals[a:a + FAULT_PARITY_BATCH])
            out["rows"].append(ws["code"].cpu())
            out["counts"].append({k: int(ws[k]) for k in (
                "acked", "replica_writes", "evicted_copies", "inserted",
                "updated", "evicted", "dropped", "rounds")})

    def reads(lo, hi):
        nonlocal st
        st, o, f, rs = dht_read(st, keys[lo:hi])
        out["rows"] += [o.cpu(), f.cpu()]
        out["counts"].append({k: int(rs[k]) for k in (
            "hits", "misses", "fallback_reads", "dropped")})

    def cached():
        nonlocal st, l1
        st, l1, o, f, rs = dht_read_cached(st, l1, keys[:FAULT_PARITY_BATCH])
        out["rows"] += [o.cpu(), f.cpu()]
        out["counts"].append({k: int(rs[k]) for k in (
            "hits", "l1_hits", "fallback_reads")})

    writes(0, half)
    snap()
    cached()
    cached()
    st = crash_shard(st, FAULT_VICTIM)
    cached()
    reads(0, half)
    writes(half, 2 * half)
    snap()
    st = recover_shard(st, FAULT_VICTIM)
    reads(0, 2 * half)
    plan = plan_repair(st, FAULT_VICTIM)
    out["rows"].append(plan.src.cpu())
    st, rep = repair_run(st, FAULT_VICTIM, batch=FAULT_PARITY_BATCH)
    out["counts"].append({**rep, "diff": repair_diff(st, FAULT_VICTIM)})
    snap()
    reads(0, 2 * half)
    return out


def phase_faults(cfg_big, errs, uniform_ids: int = FAULT_ID_RANGE):
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    full = _faults_full(cfg_big, errs, uniform_ids)
    card = _faults_stream(DEVICE)
    torch.cuda.synchronize()
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    emit("faults", S=cfg_big.n_shards, B=cfg_big.buckets_per_shard,
         n_replicas=2, victim=FAULT_VICTIM, keys_before_crash=FAULT_KEYS,
         keys_during_outage=FAULT_KEYS, batch=FAULT_BATCH,
         capacity=FAULT_BATCH, id_range=FAULT_ID_RANGE,
         uniform_ids=uniform_ids,
         sharded_note="sharded replication needs k <= S ranks: at NCCL "
         "world size 1 it cannot run; it waits for the 4-chip cell of "
         "ROADMAP item 16 (on the CPU: 4 gloo ranks, "
         "tests/test_torch_faults.py)",
         max_memory_allocated_gb=peak / 1e9, launches=launches, **full)
    wr, rp = full["writes"], full["repair"]
    print(f"faults write round ms (median of {wr['batches']}): replicated "
          f"{wr['write_round_ms_k2_median']}, plain "
          f"{wr['write_round_ms_k1_median']}; wire_amp {wr['wire_amp']}, "
          f"extra_write_rounds {wr['extra_write_rounds']}", flush=True)
    print(f"faults outage read round ms: "
          f"{full['outage']['read_round_ms_median']}; fallback_reads "
          f"{full['outage']['fallback_reads']}", flush=True)
    print(f"faults plan ms: {rp['plan_ms_median']}; repair round ms: "
          f"{rp['round_ms_median']}; entries per second: "
          f"{rp['entries_per_s']}; diff_after: {rp['diff_after']}",
          flush=True)
    la = full["lost_acked"]
    print(f"faults lost_acked: {la['keys']} keys; copies evicted: "
          f"{la['evicted_copies_before_crash']} before the crash, "
          f"{la['evicted_copies_during_outage']} during the outage",
          flush=True)
    print(f"faults peak memory GB: {peak / 1e9}", flush=True)

    cpu = _faults_stream("cpu")
    eq = {"slabs": all(all((a[k] == b[k]).all() for k in a)
                       for a, b in zip(card["slabs"], cpu["slabs"])),
          "rows": _same(card["rows"], cpu["rows"]),
          "counts": card["counts"] == cpu["counts"]}
    check(all(eq.values()), f"faults-parity: card and CPU differ {eq}")
    fence = [c["l1_hits"] for c in card["counts"] if "l1_hits" in c]
    check(fence[1] > 0 and fence[2] == 0,
          f"faults-parity: the L1 did not serve, or served across the "
          f"crash ({fence})")
    emit("faults_parity", B=FAULT_PARITY_BUCKETS, keys=2 * FAULT_PARITY_KEYS,
         batch=FAULT_PARITY_BATCH, equal=eq, l1_hits=fence,
         repair=card["counts"][-2])
    return launches


# ---------------------------------------------------------------------------
# sharded: the multi-rank backend at world size 1
# ---------------------------------------------------------------------------

def _sharded_group():
    """One-rank process group on a free local port: NCCL on the card
    (gloo where DEVICE is the CPU, for a rehearsal)."""
    import datetime
    import socket

    import torch
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    kw = {}
    if DEVICE.startswith("cuda"):
        kw["device_id"] = torch.device(DEVICE if ":" in DEVICE
                                       else f"{DEVICE}:0")
    dist.init_process_group(
        "nccl" if DEVICE.startswith("cuda") else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=300), **kw)


def _sharded_plan(keys, vals, mk, mv, op, execute):
    """The 4-round stream on one backend: ``execute(kind, ...)`` runs a
    round and returns ``(vals, found, code, stats)``."""
    return [("write", lambda: execute("write", keys, vals)),
            ("read", lambda: execute("read", keys, None)),
            ("mixed_95_5", lambda: execute("mixed", mk, mv, op)),
            ("migrate", lambda: execute("migrate", mk, mv))]


def _sharded_exec(d):
    """Round runner through the ShardedDHT's entry points."""
    import torch

    from repro_torch.core import dht_execute, mixed_ops

    def run(kind, k, v, op=None):
        if kind == "write":
            st = d.write(k, v)
            return None, None, st["code"], st
        if kind == "read":
            out, found, st = d.read(k)
            return out, found, None, st
        if kind == "mixed":
            d.state, _, out, found, code, st = dht_execute(
                d.state, mixed_ops(op, k, v), kinds=("read", "write"),
                axis_name=d.group)
            return out, found, code, st
        ones = torch.ones(k.shape[0], dtype=torch.bool, device=k.device)
        d.state, out, found, code, st = d.execute_fn(("migrate",))(
            d.state, k, v, ones)
        return out, found, code, st
    return run


def _virtual_exec(st):
    """The same rounds on the virtual-shard backend, through its own
    wrappers where the sharded side takes ShardedDHT's."""
    from repro_torch.core import (dht_execute, dht_read, dht_write,
                                  migrate_ops, mixed_ops)

    def run(kind, k, v, op=None):
        if kind == "write":
            _, stats = dht_write(st, k, v)
            return None, None, stats["code"], stats
        if kind == "read":
            _, out, found, stats = dht_read(st, k)
            return out, found, None, stats
        if kind == "mixed":
            _, _, out, found, code, es = dht_execute(
                st, mixed_ops(op, k, v), kinds=("read", "write"))
            return out, found, code, es
        _, _, out, found, code, es = dht_execute(st, migrate_ops(k, v),
                                                 kinds=("migrate",))
        return out, found, code, es
    return run


def _rows_of(res):
    return [x for x in res[:3] if x is not None]


def _sharded_main(cfg, errs):
    """(a) the counted run: every entry point of the sharded path once,
    outputs and digests kept for the comparison that follows."""
    import torch

    from repro_torch.core import (InterpConfig, L1Config, SurrogateConfig,
                                  l1_create, lookup_interpolate_or_compute,
                                  lookup_or_compute, store)
    from repro_torch.core.distributed import ShardedDHT
    from repro_torch.kernels import ops

    scfg = SurrogateConfig(n_inputs=10, n_outputs=13, sig_digits=3,
                           dht=cfg)
    gen = torch.Generator().manual_seed(60)
    surr_x = pipe_inputs(torch.randint(0, PIPE_UNIFORM_IDS, (N_KEYS,),
                                       generator=gen), DEVICE)
    centres, nbrs = _bracketed(scfg, INTERP_CENTRES, DEVICE, seed=61)
    mode_keys = words(gen, SHARD_MODE_WRITES, cfg.key_words, DEVICE)
    mode_vals = words(gen, SHARD_MODE_WRITES, cfg.val_words, DEVICE)
    warm = _stream(cfg, DEVICE, seed=99)
    stream = _stream(cfg, DEVICE, seed=1)
    torch.cuda.synchronize()

    saved: dict = {}
    d = ShardedDHT.create(cfg, device=DEVICE)
    ops.reset_launches()
    run = _sharded_exec(d)
    run("write", warm[0], warm[1])
    with Capture(ops) as cap:
        for kind, fn in _sharded_plan(*stream, run):
            res = fn()
            saved[kind] = (_rows_of(res), slab_digest(d.state), res[3])
            if kind == "read":
                wire = int(res[3]["wire_words"])
    # cached reads through the ShardedDHT's closure: elided residue
    l1 = l1_create(L1Config(n_sets=1024, n_ways=4), cfg.n_shards,
                   device=DEVICE)
    cached = d.read_cached_fn()
    ones = torch.ones(N_KEYS, dtype=torch.bool, device=DEVICE)
    with Capture(ops) as lcap:
        for i in range(2):
            d.state, l1, out, found, cst = cached(d.state, l1, stream[0],
                                                  ones)
            saved[f"cached{i}"] = ([out, found], int(cst["l1_hits"]),
                                   int(cst["wire_words"]))
    out, found, ast = d.read_commit(d.read_async(stream[0]))
    saved["async"] = ([out, found], ast["overlap_frac"])
    # the surrogate forms through the group, one round each
    for i in range(2):
        d.state, out, found, sst = lookup_or_compute(
            scfg, d.state, surr_x, pipe_value, axis_name=d.group)
        saved[f"loc{i}"] = ([out, found], int(sst["hits"]))
    with Capture(ops) as scap:
        d.state, _ = store(scfg, d.state, nbrs, interp_fn(nbrs),
                           axis_name=d.group)
        d.state, out, prov, ist = lookup_interpolate_or_compute(
            scfg, d.state, centres, interp_fn, InterpConfig(),
            one_round=True, axis_name=d.group)
    saved["lic"] = ([out, prov], int(ist["stored"]))
    saved["digest"] = slab_digest(d.state)
    # fine and coarse: their locked schedules on the full table
    for mode in ("fine", "coarse"):
        mcfg = dataclasses.replace(cfg, mode=mode)
        dm = ShardedDHT.create(mcfg, device=DEVICE)
        mst = dm.write(mode_keys, mode_vals)
        out, found, rst = dm.read(mode_keys)
        saved[mode] = ([mst["code"], out, found], slab_digest(dm.state),
                       {k: int(mst[k]) for k in ("rounds", "lock_tokens")},
                       int(rst["lock_tokens"]))
        del dm
    torch.cuda.synchronize()
    launches = ops.launches()
    calls = {n: cap.calls[n] + lcap.calls[n] + scap.calls[n]
             for n in cap.calls}
    compare_calls(calls, errs, "sharded")
    return d, saved, launches, wire, (scfg, surr_x, centres, nbrs,
                                      mode_keys, mode_vals, warm, stream)


def _sharded_parity(cfg, saved, inputs) -> dict:
    """The virtual-shard backend on the same rounds: every output, flag
    and code, and the slab digests, equal."""
    import torch

    from repro_torch.core import (InterpConfig, dht_create, dht_read,
                                  dht_write, lookup_interpolate_or_compute,
                                  lookup_or_compute, store)

    scfg, surr_x, centres, nbrs, mkeys, mvals, warm, stream = inputs
    eq = {}
    v = dht_create(cfg, device=DEVICE)
    run = _virtual_exec(v)
    run("write", warm[0], warm[1])
    for kind, fn in _sharded_plan(*stream, run):
        res = fn()
        rows, digest, _ = saved[kind]
        eq[kind] = (all(torch.equal(a, b) for a, b in zip(_rows_of(res),
                                                          rows))
                    and slab_digest(v) == digest)
    v, rout, rfound, _ = dht_read(v, stream[0])
    for i in range(2):
        out, found = saved[f"cached{i}"][0]
        eq[f"cached{i}"] = torch.equal(out, rout) and torch.equal(found,
                                                                  rfound)
    out, found = saved["async"][0]
    eq["async"] = torch.equal(out, rout) and torch.equal(found, rfound)
    for i in range(2):
        v, out, found, _ = lookup_or_compute(scfg, v, surr_x, pipe_value,
                                             one_round=True)
        eq[f"loc{i}"] = all(torch.equal(a, b) for a, b in zip(
            (out, found), saved[f"loc{i}"][0]))
    v, _ = store(scfg, v, nbrs, interp_fn(nbrs))
    v, out, prov, _ = lookup_interpolate_or_compute(
        scfg, v, centres, interp_fn, InterpConfig(), one_round=True)
    eq["lic"] = all(torch.equal(a, b) for a, b in zip(
        (out, prov), saved["lic"][0]))
    eq["digest"] = slab_digest(v) == saved["digest"]
    del v
    for mode in ("fine", "coarse"):
        vm = dht_create(dataclasses.replace(cfg, mode=mode), device=DEVICE)
        vm, ws = dht_write(vm, mkeys, mvals)
        vm, out, found, _ = dht_read(vm, mkeys)
        rows, digest, _, _ = saved[mode]
        eq[mode] = (all(torch.equal(a, b) for a, b in zip(
            (ws["code"], out, found), rows)) and slab_digest(vm) == digest)
        del vm
    return eq


def _sharded_ring(cfg) -> dict:
    """(d) ring placement on the group: ``ShardedDHT.create(ring=)`` runs
    the four rounds equal to the virtual backend with the same ring
    (outputs, flags, codes, slab digests), then ``apply_ring`` to the
    next epoch of the same shard set moves nothing and bumps the epoch
    that the next read stamps."""
    import torch

    from repro_torch.core import dht_create, ring_create, ring_resize
    from repro_torch.core.distributed import ShardedDHT

    stream = _stream(cfg, DEVICE, seed=2)
    d = ShardedDHT.create(cfg, device=DEVICE, ring=ring_create(1))
    saved = {}
    for kind, fn in _sharded_plan(*stream, _sharded_exec(d)):
        res = fn()
        saved[kind] = (_rows_of(res), slab_digest(d.state))
    before = slab_digest(d.state)
    applied = d.apply_ring(ring_resize(d.ring, 1))
    out, found, rst = d.read(stream[0])
    check(applied["moved"] == 0 and applied["n_planned"] == 0
          and applied["epoch"] == 1 and d.ring.epoch == 1,
          f"sharded apply_ring: {applied}")
    check(int(rst["epoch"]) == 1 and bool(found.all())
          and slab_digest(d.state) == before,
          "sharded apply_ring: the table changed or the epoch is stale")
    del d
    v = dht_create(cfg, ring_create(1), device=DEVICE)
    eq = {}
    for kind, fn in _sharded_plan(*stream, _virtual_exec(v)):
        res = fn()
        rows, digest = saved[kind]
        eq[kind] = (all(torch.equal(a, b) for a, b in zip(_rows_of(res),
                                                          rows))
                    and slab_digest(v) == digest)
    del v
    check(all(eq.values()), f"sharded ring vs virtual ring differ: {eq}")
    return {"equal_to_virtual": eq, "apply_ring": applied,
            "read_epoch_after": int(rst["epoch"])}


def _sharded_telemetry(cfg) -> dict:
    """(e) The group's telemetry at world size 1, on a B=2^20 table from
    a fresh registry: ``telemetry_snapshot()`` after a write and two
    reads against the lanes the wrappers returned, and the all-to-all
    words ``torch.profiler`` saw in one read beside its wire lanes (every
    row self-owned: the buffer holds only the elided self block, the
    wire words only the prologue)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.distributed import ShardedDHT
    from repro_torch.obs import costmodel, metrics

    tcfg = dataclasses.replace(cfg, buckets_per_shard=OBS_SHARD_BUCKETS)
    keys, vals, _, _, _ = _stream(tcfg, DEVICE, seed=70)
    reg = metrics.MetricRegistry()
    prev = metrics.set_registry(reg)
    try:
        d = ShardedDHT.create(tcfg, device=DEVICE)
        ws = d.write(keys, vals)
        _, _, r1 = d.read(keys)
        _, _, r2 = d.read(keys)
        snap = d.telemetry_snapshot()
        c = snap["counters"]
        want = {
            "engine.rounds": 3 + int(ws["write_retries"]),
            "engine.wire_words": sum(int(x["wire_words"])
                                     for x in (ws, r1, r2)),
            "engine.inserted": int(ws["inserted"]),
            "dht.hits": int(r1["hits"]) + int(r2["hits"]),
            "dht.misses": int(r1["misses"]) + int(r2["misses"]),
            "engine.ops.write": N_KEYS, "engine.ops.read": 2 * N_KEYS}
        got = {k: c.get(k, 0) for k in want}
        check(got == want and snap == reg.snapshot()
              and snap["histograms"]["engine.fill_frac"]["count"]
              == want["engine.rounds"],
              f"sharded telemetry: {got} against the lanes {want}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            _, _, rs = d.read(keys)
            torch.cuda.synchronize()
        events = prof.events()
        names = sorted({e.name for e in events
                        if "alltoall" in e.name.lower().replace("_", "")})
        profiled = costmodel.profiled_alltoall_words(events)
        del d
    finally:
        metrics.set_registry(prev)
    return {"snapshot_counters": got, "engine_rounds": c["engine.rounds"],
            "profiled_alltoall_words": profiled,
            "wire_words": int(rs["wire_words"]),
            "prologue_words": 2 * tcfg.n_shards,
            "alltoall_event_names": names}


def _sharded_timing(cfg) -> dict:
    """(b) the four rounds on fresh sharded and virtual tables in turns
    (fresh keys each repeat), the exchange alone by CUDA events, and the
    host syncs of each issue half."""
    import torch

    from repro_torch.core import dht_create, routing
    from repro_torch.core.distributed import ShardedDHT

    d = ShardedDHT.create(cfg, device=DEVICE)
    v = dht_create(cfg, device=DEVICE)
    warm = _stream(cfg, DEVICE, seed=99)
    _sharded_exec(d)("write", warm[0], warm[1])
    _virtual_exec(v)("write", warm[0], warm[1])
    ms = {"sharded": {}, "virtual": {}}
    for rep in range(SHARD_REPS):
        stream = _stream(cfg, DEVICE, seed=200 + rep)
        for backend, run in (("sharded", _sharded_exec(d)),
                             ("virtual", _virtual_exec(v))):
            for kind, fn in _sharded_plan(*stream, run):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms[backend].setdefault(kind, []).append(
                    (time.perf_counter() - t0) * 1e3)
    # where the extra host time of a round goes: torch.profiler over one
    # read and one write round of each backend
    stream = _stream(cfg, DEVICE, seed=250)
    profiles = {}
    for backend, run in (("sharded", _sharded_exec(d)),
                         ("virtual", _virtual_exec(v))):
        for kind, fn in _sharded_plan(*stream, run)[:2]:
            profiles[f"{backend}_{kind}"] = _host_profile(fn)
    del v
    rounds = {}
    for kind in ms["sharded"]:
        row = {}
        for backend in ms:
            t = ms[backend][kind]
            row[backend] = {"median": statistics.median(t), "min": min(t),
                            "max": max(t), "all": t}
        row["sharded_minus_virtual_ms"] = (row["sharded"]["median"]
                                           - row["virtual"]["median"])
        rounds[kind] = row
    # the exchange alone: a write round's send leg at S = 1, (cap, L)
    # int32 with L = base + key + value + valid lanes
    stream = _stream(cfg, DEVICE, seed=300)
    buf = torch.zeros((N_KEYS, 1 + cfg.key_words + cfg.val_words + 1),
                      dtype=torch.int32, device=DEVICE)
    a2a = []
    for _ in range(TIMING_REPS + 3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        routing._exchange(buf, d.group)
        end.record()
        end.synchronize()
        a2a.append(start.elapsed_time(end))
    syncs, sites = {}, {}
    syncs["read"], sites["read"], r = issue_syncs(
        lambda: d.read_async(stream[0]))
    d.read_commit(r)
    syncs["write"], sites["write"], w = issue_syncs(
        lambda: d.write_async(stream[0], stream[1]))
    d.write_commit(w)
    r = d.read_async(stream[0])
    torch.cuda.synchronize()
    syncs["read_commit"], sites["read_commit"], _ = issue_syncs(
        lambda: d.read_commit(r))
    del d
    return {"rounds": rounds, "profiles": profiles,
            "all_to_all_ms": {"shape": list(buf.shape),
                              "median": statistics.median(a2a[3:]),
                              "min": min(a2a[3:]), "max": max(a2a[3:])},
            "syncs_per_issue_half": syncs, "sync_sites": sites}


def _host_profile(fn, top: int = 10) -> dict:
    """One call of ``fn`` under torch.profiler: its wall, the card's busy
    time, the count of kernel launches and collectives, and the ``top``
    host operations by self CPU time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_s = _timed(fn)
    host, device_us, launches, collectives = [], 0.0, 0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device_us += getattr(ev, "device_time_total", 0.0)
            continue
        if ev.key in ("cudaLaunchKernel", "cuLaunchKernel",
                      "cudaLaunchKernelExC"):
            launches += ev.count
        if "nccl" in ev.key.lower() or "c10d::" in ev.key:
            collectives += ev.count
        host.append((ev.self_cpu_time_total, ev.key, ev.count))
    host.sort(reverse=True)
    return {"wall_ms": wall_s * 1e3,
            "device_ms": device_us / 1e3 if device_us else "not measured",
            "kernel_launches": launches, "collective_calls": collectives,
            "host_top": [{"op": k[:70], "self_ms": us / 1e3, "calls": n}
                         for us, k, n in host[:top]]}


def _server_baseline(cfg) -> dict:
    """(c) the server baseline at the same table size beside one sharded
    round of the same ops."""
    import torch

    from repro_torch.core.distributed import ShardedDHT
    from repro_torch.core.server_kv import (server_create, server_read,
                                            server_write)

    gen = torch.Generator().manual_seed(70)
    keys = words(gen, SERVER_OPS, cfg.key_words, DEVICE)
    vals = words(gen, SERVER_OPS, cfg.val_words, DEVICE)
    out = {}
    srv = server_create(cfg, device=DEVICE)
    d = ShardedDHT.create(cfg, device=DEVICE)
    for rep in range(3):
        for name, write, read in (
                ("server", lambda: server_write(srv, keys, vals,
                                                SERVER_WIDTH),
                 lambda: server_read(srv, keys, SERVER_WIDTH)),
                ("sharded", lambda: d.write(keys, vals),
                 lambda: d.read(keys))):
            for kind, fn in (("write", write), ("read", read)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn()
                torch.cuda.synchronize()
                out.setdefault(f"{name}_{kind}_ms", []).append(
                    (time.perf_counter() - t0) * 1e3)
                if kind == "read":
                    got, found = (res[1], res[2]) if name == "server" \
                        else (res[0], res[1])
                    check(bool(found.all()) and torch.equal(got, vals),
                          f"server baseline: {name} read lost a value")
    del srv, d
    return {"ops": SERVER_OPS, "server_width": SERVER_WIDTH,
            "server_rounds": -(-SERVER_OPS // SERVER_WIDTH),
            **{k: {"median": statistics.median(v), "all": v}
               for k, v in out.items()}}


def phase_sharded(errs):
    import torch
    import torch.distributed as dist

    from repro_torch.core import DHTConfig

    cfg = DHTConfig(key_words=20, val_words=26, n_shards=1,
                    buckets_per_shard=SHARD_BUCKETS, n_probe=6,
                    mode="lockfree")
    torch.cuda.synchronize()
    _sharded_group()
    try:
        d, saved, launches, wire, inputs = _sharded_main(cfg, errs)
        check(wire == 2 * cfg.n_shards,
              f"sharded read: wire words {wire}, the prologue's "
              f"{2 * cfg.n_shards} expected (every row self-owned)")
        for kind in ("write", "mixed_95_5", "migrate"):
            check(int(saved[kind][2]["dropped"]) == 0,
                  f"sharded {kind}: rows dropped")
        check(bool(saved["read"][0][1].all())
              and torch.equal(saved["read"][0][0], inputs[7][1]),
              "sharded read: a written key was lost")
        check(saved["cached1"][1] > 0, "sharded cached read: no L1 hit")
        check(saved["loc1"][1] == N_KEYS,
              "sharded lookup_or_compute: the second batch missed")
        from repro_torch.core import PROV_INTERP

        check(bool((saved["lic"][0][1] == PROV_INTERP).all()),
              "sharded interpolation: a centre did not interpolate")
        del d
        eq = _sharded_parity(cfg, saved, inputs)
        check(all(eq.values()), f"sharded vs virtual backend differ: {eq}")
        del saved, inputs
        ring = _sharded_ring(cfg)
        telemetry = _sharded_telemetry(cfg)
        timing = _sharded_timing(cfg)
        server = _server_baseline(cfg)
    finally:
        dist.destroy_process_group()
    emit("sharded", backend="nccl", world_size=1, S=cfg.n_shards,
         B=cfg.buckets_per_shard,
         table_gb=cfg.n_shards * cfg.shard_bytes / 1e9,
         read_wire_words=wire, equal_to_virtual=eq, launches=launches,
         ring=ring, telemetry=telemetry, **timing)
    emit("sharded_server", **server)
    return launches


def _attn_case(gen, b, s, h, hk, d, dtype):
    import torch

    return tuple(torch.randn((b, s, x, d), generator=gen).to(dtype).to(DEVICE)
                 for x in (h, hk, hk))


def _attn_vs_plain(label, args, cases, errs, tols):
    """Hold the kernel against the plain version on ``args`` (q, k, v,
    window) at the tolerance ``local_attn_kernel.tolerance`` states: f32
    1e-5 abs, bf16 one bf16 ulp at the output's largest magnitude."""
    import torch

    from repro_torch.kernels import local_attn_kernel, ref

    out = local_attn_kernel.local_attention(*args)
    torch.cuda.synchronize()
    plain = ref.local_attention(*args)
    torch.cuda.synchronize()
    err = float((out.float() - plain.float()).abs().max())
    tol = local_attn_kernel.tolerance(plain)
    check(out.shape == plain.shape and out.dtype == plain.dtype,
          f"local_attention {label}: output shape/type")
    check(err <= tol, f"local_attention {label}: kernel differs from its "
                      f"plain version by {err} > {tol}")
    errs["local_attention"] = max(errs.get("local_attention", 0.0), err)
    tols["local_attention"] = max(tols.get("local_attention", 0.0), tol)
    q = args[0]
    cases.append({"case": label, "shape": list(q.shape),
                  "kv_heads": args[1].shape[2], "window": args[3],
                  "dtype": str(q.dtype).split(".")[-1], "max_abs_err": err,
                  "tolerance": tol})


def _lm_kernel_checks(cfg, errs, tols):
    """(a) the kernel against its plain version at the prefill shape in
    bf16 and float32, and at the edges: S not a multiple of the query
    tiles (128 rows in bf16, 64 in float32), windows below, one below, at
    and one above the key tiles (32 keys in float32, 64 in bf16), window
    >= S, window 1, S = 1, G = 1 and G = 2."""
    import torch

    gen = torch.Generator().manual_seed(11)
    h, hk, d, w = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.local_window
    cases: list = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _attn_case(gen, LM_BATCH, LM_PREFILL, h, hk, d, dtype)
        _attn_vs_plain("prefill", (q, k, v, w), cases, errs, tols)
        del q, k, v
        for label, (s, win, hh, kk) in {
                "ragged_s": (1000, w, h, hk), "window_below_tile": (300, 20, h, hk),
                "window_31": (300, 31, h, hk), "window_32": (300, 32, h, hk),
                "window_33": (300, 33, h, hk), "window_63": (300, 63, h, hk),
                "window_64": (300, 64, h, hk), "window_65": (300, 65, h, hk),
                "s_130": (130, w, h, hk),
                "window_ge_s": (700, w, h, hk), "window_1": (200, 1, h, hk),
                "s_1": (1, w, h, hk), "g_1": (333, 64, 4, 4),
                "g_2": (333, 64, 4, 2)}.items():
            args = _attn_case(gen, LM_BATCH, s, hh, kk, d, dtype)
            _attn_vs_plain(label, (*args, win), cases, errs, tols)
    return cases


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profile(fn, top: int = 12) -> dict:
    """Device time by kernel name over one call of ``fn`` (torch.profiler,
    CUPTI): the total, the busy share of the call's wall time, and the
    ``top`` kernels.  Device times of 0 are reported as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_s = _timed(fn)
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    if not rows:
        return {"device_ms": "not measured", "wall_ms": wall_s * 1e3}
    return {"device_ms": total_ms, "wall_ms": wall_s * 1e3,
            "busy_share": total_ms / (wall_s * 1e3),
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": n}
                    for us, k, n in rows[:top]]}


def _lm_prefill_and_serve(cfg, calls):
    """(b) lm-prefill and (e) lm-serve on the full-depth bf16 model."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import (decode_step, greedy_sample, init_cache,
                                    init_lm, param_count, prefill)
    from repro_torch.serving import make_serve_step

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    lm, init_s = _timed(lambda: init_lm(cfg, generator=gen, device=DEVICE))
    tgen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PREFILL),
                           generator=tgen).to(DEVICE)
    before = ops.launches()["local_attention"]
    with Capture(ops) as cap:
        logits, cold_s = _timed(lambda: prefill(lm, {"tokens": tokens}))
    n_local = sum(k == "attn_local" for k in cfg.block_pattern)
    launched = ops.launches()["local_attention"] - before
    check(launched == n_local, f"lm-prefill: local_attention launched "
                               f"{launched} times, {n_local} local layers")
    check(logits.shape == (LM_BATCH, cfg.padded_vocab), "lm-prefill: shape")
    check(bool(torch.isfinite(logits).all()), "lm-prefill: non-finite logits")
    # layer 0's and the last local layer's kernel inputs, for (a) and timing
    calls.extend([cap.calls["local_attention"][0],
                  cap.calls["local_attention"][-1]])
    del cap
    # the peak of an uncaptured prefill (the capture held every layer's
    # q, k, v)
    torch.cuda.reset_peak_memory_stats()
    logits2, warm_s = _timed(lambda: prefill(lm, {"tokens": tokens}))
    check(torch.equal(logits, logits2), "lm-prefill: two runs differ")
    peak = torch.cuda.max_memory_allocated()
    prof = _profile(lambda: prefill(lm, {"tokens": tokens}))
    emit("lm_prefill", arch=cfg.name, layers=cfg.n_layers,
         local_layers=n_local, d_model=cfg.d_model, dtype=cfg.dtype,
         params=param_count(lm), batch=LM_BATCH, seq=LM_PREFILL,
         init_s=init_s, prefill_s_first=cold_s, prefill_s=warm_s,
         tokens_per_s=LM_BATCH * LM_PREFILL / warm_s,
         greedy=greedy_sample(logits, cfg).tolist(),
         local_attention_launches=launched,
         max_memory_allocated_gb=peak / 1e9, profile=prof)

    # (e) lm-serve: teacher-forced prompt through serve_step's decode, then
    # greedy tokens fed back
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SERVE_PROMPT),
                           generator=tgen).to(DEVICE)
    ref = prefill(lm, {"tokens": prompt}).float()
    # one slot more than the run uses, for the profiled step after it
    cache = init_cache(cfg, LM_BATCH, LM_SERVE_PROMPT + LM_SERVE_NEW + 1,
                       torch.bfloat16, device=DEVICE)

    def teacher():
        c, lg = cache, None
        for t in range(LM_SERVE_PROMPT):
            lg, c = decode_step(lm, c, prompt[:, t:t + 1], t)
        return lg

    last, forced_s = _timed(teacher)
    diff = (last.float() - ref)
    # bf16 tolerance: prefill and decode round the residual stream of 48
    # layers to bf16 at different places, so the last position's logits
    # differ by bf16 noise; a wrong cache, rope or mask gives errors of the
    # logits' own size.  Held: relative RMS error <= 2^-4.
    rel_rms = float(diff.norm() / ref.norm())
    check(rel_rms <= 2.0 ** -4, f"lm-serve: decode and prefill logits "
                                f"differ, relative RMS {rel_rms}")
    step = make_serve_step(cfg)
    tok = greedy_sample(last, cfg)
    first = tok.clone()

    def serve():
        nonlocal tok, cache
        out = []
        for i in range(LM_SERVE_NEW):
            tok, cache = step(lm, cache, tok[:, None], LM_SERVE_PROMPT + i)
            out.append(tok)
        return torch.stack(out, dim=1)

    new, serve_s = _timed(serve)
    prof = _profile(lambda: step(lm, cache, tok[:, None],
                                 LM_SERVE_PROMPT + LM_SERVE_NEW), top=6)
    check(bool(((new >= 0) & (new < cfg.vocab_size)).all()),
          "lm-serve: token outside the vocabulary")
    emit("lm_serve", batch=LM_BATCH, prompt=LM_SERVE_PROMPT,
         new_tokens=LM_SERVE_NEW, forced_ms_per_token=forced_s * 1e3 /
         LM_SERVE_PROMPT, ms_per_token=serve_s * 1e3 / LM_SERVE_NEW,
         prefill_vs_decode_rel_rms=rel_rms,
         prefill_vs_decode_max_abs=float(diff.abs().max()),
         logit_max_abs=float(ref.abs().max()),
         greedy_equal=bool(torch.equal(first, greedy_sample(ref, cfg))),
         profile_one_step=prof,
         tokens=torch.cat([first[:, None], new], dim=1).tolist())


def _lm_decode(cfg):
    """(c) lm-decode: one period (5 local + 1 global) at full width in
    float32; forward over LM_DECODE positions against as many decode steps
    through the ring buffer, which wraps after the 1024-token window."""
    import dataclasses

    import torch

    from repro_torch.models import decode_step, forward, init_cache, init_lm

    period = cfg.block_pattern[:6]
    c1 = dataclasses.replace(cfg, n_layers=6, block_pattern=period,
                             dtype="float32")
    lm = init_lm(c1, generator=torch.Generator(device=DEVICE).manual_seed(2),
                 device=DEVICE)
    toks = torch.randint(0, c1.vocab_size, (LM_BATCH, LM_DECODE),
                         generator=torch.Generator().manual_seed(3)).to(DEVICE)
    full, fwd_s = _timed(lambda: forward(lm, {"tokens": toks}))
    cache = init_cache(c1, LM_BATCH, LM_DECODE, torch.float32, device=DEVICE)

    def run():
        errs = []
        for t in range(LM_DECODE):
            lg, _ = decode_step(lm, cache, toks[:, t:t + 1], t)
            errs.append((lg - full[:, t]).abs().max())
        return torch.stack(errs)

    errs, dec_s = _timed(run)
    worst = float(errs.max())
    check(bool(torch.isfinite(full).all()), "lm-decode: non-finite logits")
    # the bound of tests/test_models.py::test_decode_matches_forward
    check(worst <= 2e-2, f"lm-decode: decode differs from forward by {worst}")
    emit("lm_decode", layers=list(period), dtype="float32", batch=LM_BATCH,
         positions=LM_DECODE, window=c1.local_window, forward_s=fwd_s,
         decode_ms_per_step=dec_s * 1e3 / LM_DECODE,
         max_abs_err=worst, tolerance=2e-2,
         max_abs_err_after_wrap=float(errs[c1.local_window:].max()))


def _lm_parity():
    """(d) lm-parity: the reduced gemma3-12b (7 layers, window 16) from one
    seed on the card and on the CPU: forward logits and LM_PARITY_STEPS
    decode steps at rtol = atol = 1e-4 (float32, sums in another order)."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import decode_step, forward, init_cache, init_lm

    cfg = reduced(get_config(LM_ARCH))
    cpu = init_lm(cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    card = init_lm(cfg, generator=torch.Generator(device=DEVICE).manual_seed(4),
                   device=DEVICE)
    card.load_state_dict(cpu.state_dict())
    card.refresh_head()
    toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, 48),
                         generator=torch.Generator().manual_seed(6))
    a, b = forward(card, {"tokens": toks.to(DEVICE)}).cpu(), forward(
        cpu, {"tokens": toks})
    fwd_err = float((a - b).abs().max())
    check(torch.allclose(a, b, rtol=1e-4, atol=1e-4),
          f"lm-parity: forward differs card/CPU by {fwd_err}")
    cc = init_cache(cfg, LM_BATCH, 64, torch.float32, device=DEVICE)
    cp = init_cache(cfg, LM_BATCH, 64, torch.float32, device="cpu")
    dec_err = 0.0
    for t in range(LM_PARITY_STEPS):
        x, cc = decode_step(card, cc, toks[:, t:t + 1].to(DEVICE), t)
        y, cp = decode_step(cpu, cp, toks[:, t:t + 1], t)
        x = x.cpu()
        dec_err = max(dec_err, float((x - y).abs().max()))
        check(torch.allclose(x, y, rtol=1e-4, atol=1e-4),
              f"lm-parity: decode step {t} differs card/CPU")
    emit("lm_parity", layers=cfg.n_layers, window=cfg.local_window,
         forward_max_abs_err=fwd_err, decode_steps=LM_PARITY_STEPS,
         decode_max_abs_err=dec_err, rtol=1e-4, atol=1e-4)


def phase_lm(errs, tols):
    """gemma3-12b: (a) the local-attention kernel against its plain
    version; then the main path, between a reset and a read of the launch
    counts: (b) lm-prefill and (e) lm-serve at full depth in bf16, (c)
    lm-decode and (d) lm-parity; then the kernel against its plain
    version on the prefill's own layer inputs.  Returns the launches and
    the inputs the timing phase uses."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg = get_config(LM_ARCH)
    cases = _lm_kernel_checks(cfg, errs, tols)
    calls: list = []
    torch.cuda.synchronize()
    ops.reset_launches()
    _lm_prefill_and_serve(cfg, calls)
    torch.cuda.empty_cache()
    _lm_decode(cfg)
    torch.cuda.empty_cache()
    _lm_parity()
    torch.cuda.synchronize()
    launches = ops.launches()
    for label, args in zip(("prefill_layer_0", "prefill_layer_46"), calls):
        _attn_vs_plain(label, args, cases, errs, tols)
    emit("lm_kernel_parity", cases=cases)
    emit("lm", launches=launches)
    return launches, calls


def warm_card(seconds: float = 1.0) -> None:
    """Keep the card busy for ``seconds`` before the first timed launch:
    the lm phase ends with work on the CPU, and a card that idled runs
    its first kernels at a lower clock."""
    import torch

    x = torch.randn(4096, 4096, device=DEVICE, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            x @ x
        torch.cuda.synchronize()


def phase_timing(wcalls, rcalls, kcalls, icalls, lcalls, acalls):
    import torch

    import torch.nn.functional as F

    from repro_torch.kernels import (apply_kernel, hash_kernel,
                                     local_attn_kernel, ref, route_kernel)

    pairs = kernel_pairs()
    warm_card()

    def sdpa_call(args):
        """One PyTorch call computing local attention: SDPA with a boolean
        band mask on K/V expanded per query group, (B, H, S, D) views and
        the mask prepared outside the timing."""
        q, k, v, window = args
        g = q.shape[2] // k.shape[2]
        qt, kt, vt = (x.transpose(1, 2) for x in (
            q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
        i = torch.arange(q.shape[1], device=q.device)
        band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        return lambda *a: F.scaled_dot_product_attention(qt, kt, vt,
                                                         attn_mask=band)

    def lib_call(args):
        """The nearest single PyTorch call: one row gather by index
        (without the fill rows), its index prepared outside the timing."""
        idx = args[1].clamp(min=0)
        return lambda *a: torch.index_select(a[0], 0, idx)

    def apply_bound(args):
        _v, found, rsel, _w, _k = ref.shard_apply(*args)
        return bound_shard_apply(*args, (found, rsel))

    def probe_bound(args):
        _v, found, rsel = ref.probe(*args)
        return bound_probe(*args, (found, rsel))

    spec = {
        # name: (kernel, plain, library call or None, inputs, bound fn)
        "route_pack": (route_kernel.route_pack, ref.route_pack, lib_call,
                       rcalls["route_pack"][0], bound_route_pack),
        "route_unpack": (route_kernel.route_unpack, ref.route_unpack,
                         lib_call, rcalls["route_unpack"][0],
                         bound_route_unpack),
        "hash64": (hash_kernel.hash64, ref.hash64, None,
                   rcalls["hash64"][0], bound_hash64),
        # the write round's first pass: the slot choice
        "shard_apply": (apply_kernel.shard_apply, ref.shard_apply, None,
                        wcalls["shard_apply"][0], apply_bound),
        # no single PyTorch call computes these three
        "checksum": (*pairs["checksum"], None, wcalls["checksum"][0],
                     bound_checksum),
        "round_sig": (*pairs["round_sig"], None, kcalls["round_sig"][0],
                      bound_round_sig),
        "stencil_keys": (*pairs["stencil_keys"], None,
                         icalls["stencil_keys"][0], bound_stencil_keys),
        # the read round's probe pass; the second cached read's L1 probe
        "probe": (*pairs["probe"], None, rcalls["probe"][0], probe_bound),
        "l1_probe": (*pairs["l1_probe"], None, lcalls["l1_probe"][-1],
                     bound_l1_probe),
        # layer 0's inputs in the full-depth bf16 prefill
        "local_attention": (local_attn_kernel.local_attention,
                            ref.local_attention, sdpa_call, acalls[0],
                            bound_local_attention),
    }
    out = {}
    for name, (kern, plain, lib, args, bound_fn) in spec.items():
        nbytes, nops = (bound_fn(args) if name in ("shard_apply", "probe")
                        else bound_fn(*args))
        b_ms, b_by = bound_ms(nbytes, nops)
        if name == "local_attention" and args[0].dtype == torch.bfloat16:
            # bf16 inputs, float32 sums: the tensor cores' bf16 rate
            b_ms, b_by = bound_ms(nbytes, nops, BF16_TFLOPS)
        out[name] = {
            "shapes": [list(a.shape) for a in args if hasattr(a, "shape")],
            "ms": time_cold(kern, args),
            "plain_ms": time_cold(plain, args, reps=5, warmup=1),
            "library_ms": None if lib is None else time_cold(lib(args), args),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": nops,
        }
        if name in TRACED:
            # the kernel's own device time beside the event interval
            out[name]["traced"] = trace_cold(kern, args)
    # the write round's send leg (L = 48) beside the read round's (L = 22)
    wargs = wcalls["route_pack"][0]
    nbytes, nops = bound_route_pack(*wargs)
    out["route_pack"]["write_leg"] = {
        "shapes": [list(a.shape) for a in wargs],
        "ms": time_cold(route_kernel.route_pack, wargs),
        "plain_ms": time_cold(ref.route_pack, wargs, reps=5, warmup=1),
        "library_ms": time_cold(lib_call(wargs), wargs),
        "bound_ms": bound_ms(nbytes, nops)[0]}
    # the float32 form at the same shape (lm-decode's forward runs it)
    f32 = tuple(x.float() for x in acalls[0][:3]) + (acalls[0][3],)
    nbytes, nops = bound_local_attention(*f32)
    out["local_attention"]["float32"] = {
        "ms": time_cold(local_attn_kernel.local_attention, f32),
        "plain_ms": time_cold(ref.local_attention, f32, reps=5, warmup=1),
        "library_ms": time_cold(sdpa_call(f32), f32),
        "bound_ms": bound_ms(nbytes, nops)[0]}
    for t in out.values():
        for row in (t, t.get("write_leg"), t.get("float32")):
            if row and row["library_ms"] is not None:
                row["vs_library"] = row["ms"] / row["library_ms"]
            if row:
                row["share_of_bound"] = row["bound_ms"] / row["ms"]
    # registers and spills of the attention kernels at the prefill's head
    # dim (nvcc -Xptxas -v; their shared memory is dynamic, set at launch)
    out["local_attention"]["ptxas"] = ptxas_lines(
        "local_attn", f"ILi{acalls[0][0].shape[-1]}E")
    emit("timing", timing=f"CUDA events, median of {TIMING_REPS} launches "
                          "(plain: 5), L2 flushed before each", kernels=out)
    return out


def main(argv: list[str]) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import DHTConfig

    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    cfg_big = DHTConfig(key_words=20, val_words=26, n_shards=8,
                        buckets_per_shard=BIG_BUCKETS, n_probe=6,
                        mode="lockfree")
    errs: dict[str, float] = {}
    if argv[:1] == ["--faults-uniform-ids"]:
        # the faults phase alone, its uniform half below argv[1]: what
        # repair leaves at that load (the `faults_diff` line)
        phase_faults(cfg_big, errs, int(argv[1]))
        print(smi, flush=True)
        return 0
    gen = torch.Generator().manual_seed(0)
    _st, wcalls, rcalls, lcalls = phase_kernels(cfg_big, gen, errs)
    launches = {"dht": phase_dht(cfg_big)}
    launches["obs"] = phase_obs(cfg_big)
    launches["keys"], kcalls = phase_keys(errs)
    launches["poet"], _ref, poet_plain = phase_poet()
    del _ref
    launches["interp"], icalls = phase_interp(cfg_big, errs, poet_plain)
    launches["l1"] = phase_l1(cfg_big, errs)
    launches["pipeline"] = phase_pipeline(cfg_big, poet_plain)
    launches["elastic"] = phase_elastic(cfg_big, errs)
    launches["faults"] = phase_faults(cfg_big, errs)
    launches["sharded"] = phase_sharded(errs)
    tols: dict[str, float] = {}        # the bit-exact kernels: 0
    launches["lm"], acalls = phase_lm(errs, tols)
    timing = phase_timing(wcalls, rcalls, kcalls, icalls, lcalls, acalls)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        per_phase = {ph: launches[ph][name] for ph in launches}
        missing = [ph for ph in KERNEL_PHASES[name] if per_phase[ph] == 0]
        check(not missing, f"{name}: not launched on the path of "
                           f"{missing} ({per_phase})")
        check(errs[name] <= tols.get(name, 0.0),
              f"{name}: max_abs_err {errs[name]}")
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(per_phase.values()),
            **{f"launches_{ph}": v for ph, v in per_phase.items()},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
