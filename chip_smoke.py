#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` with nvcc, holds each kernel against its
plain PyTorch version on the card, drives the main path (the lock-free
DHT at full size, then the POET surrogate twin), checks the results, and
times every kernel.  One JSON line per phase:

1. env     - card name and power limit (nvidia-smi), CUDA, device count;
2. build   - nvcc for sm_90a, one process per source, with ptxas reports;
3. kernels - every kernel against its plain version, bit for bit, on the
             inputs of a real full-size round plus small edge cases;
4. dht     - S=8 x B=2^21 buckets of 192 B (3.2 GB): seeded 2^16-key
             write, read, 95/5 mixed and migrate rounds; dropped must be 0,
             every read must hit; then the same stream at B=2^16 on the
             card and on the CPU must leave identical slab words;
5. keys    - make_keys on the card against the CPU on 2 M values spanning
             1e-30..1e30; a mismatch is allowed only within 64 ulps of a
             power of ten (F1 in ROADMAP.md);
6. poet    - the POET twin at its default 50 x 150 grid with and without
             the DHT (steps cut to fit the time limit, the cut printed);
7. timing  - each kernel, its plain version and the nearest single
             PyTorch call at the main path's shapes, with CUDA events and
             a cold L2 before each launch, beside the byte bound.

Then the ``kernels`` line (launch counts from phases 4 and 6, each must be
> 0), the card's name and power limit, and the result line.  Any failure
raises and exits non-zero before the result line; without a CUDA device,
or without the repository around this file, it exits non-zero at once.
"""
from __future__ import annotations

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
TIMING_REPS = 20
KERNEL_SOURCES = {
    "route_pack": ("src/repro_torch/kernels/csrc/route.cu",
                   "src/repro/kernels/route_kernel.py:51"),
    "route_unpack": ("src/repro_torch/kernels/csrc/route.cu",
                     "src/repro/kernels/route_kernel.py:97"),
    "hash64": ("src/repro_torch/kernels/csrc/hash.cu",
               "src/repro/kernels/hash_kernel.py:35"),
    "shard_apply": ("src/repro_torch/kernels/csrc/apply.cu",
                    "src/repro/kernels/apply_kernel.py:123"),
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
    """Records the arguments of every kernel call the engine makes while
    active (the kernels still run)."""

    NAMES = ("route_pack", "route_unpack", "hash64", "shard_apply")

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

        def recorded(*args):
            self.calls[name].append(args)
            return fn(*args)
        return recorded

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.ops, n, fn)
        return False


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the outputs' values (0.0 = bit for bit)."""
    import torch

    outs_a = a if isinstance(a, tuple) else (a,)
    outs_b = b if isinstance(b, tuple) else (b,)
    err = 0.0
    for x, y in zip(outs_a, outs_b):
        check(x.shape == y.shape and x.dtype == y.dtype, "output shape/type")
        if x.numel():
            d = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
            err = max(err, float(d))
    return err


def kernel_vs_plain(name, fn_kernel, fn_plain, args) -> float:
    import torch

    a = fn_kernel(*args)
    torch.cuda.synchronize()
    b = fn_plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err(a, b)
    check(err == 0.0, f"{name}: kernel differs from its plain version "
                      f"(max abs err {err})")
    return err


def time_cold(fn, args, reps: int | None = None, warmup: int = 3) -> float:
    """Median ms of one call, each launched into a cold L2 (a 256 MB
    buffer is overwritten before it), timed with CUDA events."""
    import torch

    reps = TIMING_REPS if reps is None else reps
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    import torch

    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), python=sys.version.split()[0])
    return smi


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    secs = time.perf_counter() - t0
    report = {}
    for lib, log in build.PTXAS_LOG.items():
        report[lib] = [ln.split("ptxas info    : ")[-1].strip()
                       for ln in log.splitlines()
                       if re.search(r"registers|spill|smem", ln)]
    for lib in build.LIBRARIES:
        build.load(lib)
    emit("build", seconds=round(secs, 3), nvcc=build.nvcc_path(),
         flags=" ".join(build.NVCC_FLAGS), ptxas=report)


def main_path_capture(cfg_big, gen):
    """A full-size table holding 2^16 written keys, and the exact kernel
    inputs of a write round and a read round on it."""
    import torch

    from repro_torch.core import dht_create, dht_read, dht_write
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
    return st, wcap.calls, rcap.calls


def edge_cases(gen):
    """Small inputs like the CPU tests': ragged N and widths, fill rows,
    kept == 0, and a roughened table (INVALID, empty, corrupted
    checksums, a window at B - n_probe, a corrupted bucket shadowing a
    valid one)."""
    import torch

    from repro_torch.core import DHTConfig, dht_create, dht_write
    from repro_torch.core.hashing import base_bucket, hash64

    cases = {"hash64": [], "route_pack": [], "route_unpack": [],
             "shard_apply": []}
    for n, kw in ((1, 20), (7, 4), (300, 33), (1000, 20)):
        cases["hash64"].append((words(gen, n, kw, DEVICE),))
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
        base = base_bucket(hash64(q)[1], cfg.buckets_per_shard, n_probe)
        base[-1] = cfg.buckets_per_shard - n_probe
        slab = (st.flat_keys[:-1], st.flat_vals[:-1], st.flat_meta[:-1],
                st.flat_csum[:-1])
        cases["shard_apply"].append((*slab, q, base.contiguous(), n_probe))
    return cases


def phase_kernels(cfg_big, gen):
    from repro_torch.kernels import (apply_kernel, hash_kernel, ref,
                                     route_kernel)

    pairs = {
        "route_pack": (route_kernel.route_pack, ref.route_pack),
        "route_unpack": (route_kernel.route_unpack, ref.route_unpack),
        "hash64": (hash_kernel.hash64, ref.hash64),
        "shard_apply": (apply_kernel.shard_apply, ref.shard_apply),
    }
    st, wcalls, rcalls = main_path_capture(cfg_big, gen)
    edges = edge_cases(gen)
    result = {}
    for name, (kern, plain) in pairs.items():
        main = wcalls[name] + rcalls[name]
        check(len(main) > 0, f"{name}: the main path made no call")
        err = 0.0
        for args in main + edges[name]:
            err = max(err, kernel_vs_plain(name, kern, plain, args))
        result[name] = {"main_path_calls": len(main),
                        "edge_cases": len(edges[name]), "max_abs_err": err,
                        "shapes": sorted({str([tuple(a.shape) for a in args
                                               if hasattr(a, "shape")])
                                          for args in main})}
    emit("kernels", result=result, tolerance="bit for bit (max_abs_err 0)")
    return st, wcalls, rcalls, {k: v["max_abs_err"] for k, v in result.items()}


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
         launches=launches)
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


def phase_keys():
    import numpy as np
    import torch

    from repro_torch.core import SurrogateConfig, make_keys

    cfg = SurrogateConfig(sig_digits=3)
    gen = torch.Generator().manual_seed(5)
    n = KEY_VALUES
    mag = 10.0 ** (torch.rand(n, generator=gen, dtype=torch.float64) * 60
                   - 30)
    sign = torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0)
    x = (mag * sign).to(torch.float32).reshape(-1, 10)
    k_gpu = make_keys(cfg, x.to(DEVICE)).cpu()
    k_cpu = make_keys(cfg, x)
    diff = (k_gpu[:, 0::2] != k_cpu[:, 0::2]).reshape(-1)
    bad = x.reshape(-1)[diff].numpy()
    p = np.array([np.float32(10.0 ** k) for k in range(-37, 38)], np.float32)
    ulps = (np.abs(np.abs(bad).view(np.int32)[:, None]
                   - p.view(np.int32)[None, :]).min(axis=1)
            if bad.size else np.zeros(0))
    outside = int((ulps > 64).sum())
    emit("keys", values=n, sig_digits=cfg.sig_digits,
         mismatches=int(diff.sum()), outside_64ulp_band=outside,
         padding_words_equal=bool(torch.equal(k_gpu[:, 1::2],
                                              k_cpu[:, 1::2])))
    check(outside == 0, f"keys: {outside} card/CPU mismatches lie outside "
                        "the 64-ulp band of a decade boundary")


def phase_poet():
    import torch

    sys.path.insert(0, str(ROOT / "examples"))
    from torch_poet_reactive_transport import PoetConfig, run_simulation

    from repro_torch.kernels import ops

    cfg = PoetConfig(n_steps=POET_STEPS)
    ref = run_simulation(cfg, use_dht=False, device=DEVICE)
    ops.reset_launches()
    dht = run_simulation(cfg, use_dht=True, device=DEVICE)
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
    return launches


def phase_timing(wcalls, rcalls):
    import torch

    from repro_torch.kernels import (apply_kernel, hash_kernel, ref,
                                     route_kernel)

    def lib_call(args):
        """The nearest single PyTorch call: one row gather by index
        (without the fill rows), its index prepared outside the timing."""
        idx = args[1].clamp(min=0)
        return lambda *a: torch.index_select(a[0], 0, idx)

    def apply_bound(args):
        _v, found, rsel, _w, _k = ref.shard_apply(*args)
        return bound_shard_apply(*args, (found, rsel))

    spec = {
        # name: (kernel, plain, library call or None, inputs, bound fn)
        "route_pack": (route_kernel.route_pack, ref.route_pack, lib_call,
                       rcalls["route_pack"][0], bound_route_pack),
        "route_unpack": (route_kernel.route_unpack, ref.route_unpack,
                         lib_call, rcalls["route_unpack"][0],
                         bound_route_unpack),
        "hash64": (hash_kernel.hash64, ref.hash64, None,
                   rcalls["hash64"][0], bound_hash64),
        "shard_apply": (apply_kernel.shard_apply, ref.shard_apply, None,
                        rcalls["shard_apply"][0], apply_bound),
    }
    out = {}
    for name, (kern, plain, lib, args, bound_fn) in spec.items():
        nbytes, nops = (bound_fn(args) if name == "shard_apply"
                        else bound_fn(*args))
        b_ms, b_by = bound_ms(nbytes, nops)
        out[name] = {
            "shapes": [list(a.shape) for a in args if hasattr(a, "shape")],
            "ms": time_cold(kern, args),
            "plain_ms": time_cold(plain, args, reps=5, warmup=1),
            "library_ms": None if lib is None else time_cold(lib(args), args),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": nops,
        }
    # the write round's send leg (L = 48) beside the read round's (L = 22)
    wargs = wcalls["route_pack"][0]
    nbytes, nops = bound_route_pack(*wargs)
    out["route_pack"]["write_leg"] = {
        "shapes": [list(a.shape) for a in wargs],
        "ms": time_cold(route_kernel.route_pack, wargs),
        "plain_ms": time_cold(ref.route_pack, wargs, reps=5, warmup=1),
        "library_ms": time_cold(lib_call(wargs), wargs),
        "bound_ms": bound_ms(nbytes, nops)[0]}
    emit("timing", timing=f"CUDA events, median of {TIMING_REPS} launches "
                          "(plain: 5), L2 flushed before each", kernels=out)
    return out


def main() -> int:
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
    gen = torch.Generator().manual_seed(0)
    _st, wcalls, rcalls, errs = phase_kernels(cfg_big, gen)
    dht_launches = phase_dht(cfg_big)
    phase_keys()
    poet_launches = phase_poet()
    timing = phase_timing(wcalls, rcalls)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        n_dht, n_poet = dht_launches[name], poet_launches[name]
        check(n_dht > 0 and n_poet > 0,
              f"{name}: not launched on the main path "
              f"(dht {n_dht}, poet {n_poet})")
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_dht + n_poet,
            "launches_dht": n_dht, "launches_poet": n_poet,
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
    sys.exit(main())
