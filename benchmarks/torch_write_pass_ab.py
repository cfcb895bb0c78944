#!/usr/bin/env python3
"""Kernels of a DHT round built from several source trees and timed on
the same inputs on one card, in turns: by default the write pass's two,
shard_apply and checksum; ``--kernels probe,route_unpack`` the read
round's two; ``--kernels hash64,stencil_keys`` the key front end;
``--kernels round_sig,l1_probe`` the keys' rounding and the L1 probe.

    python benchmarks/torch_write_pass_ab.py --tree new=src/repro_torch/kernels/csrc \\
        --tree old=DIR [--kernels shard_apply,checksum] [--misaligned] \\
        [--trace] [--out FILE]

Each DIR holds the sources of the kernels asked for (``apply.cu``,
``checksum.cu``, ``probe.cu``, ``route.cu``, ``hash.cu``, ``stencil.cu``,
``round.cu``, ``l1.cu``) with the port's C interface and the headers they
include; a ``stencil.cu`` whose launcher still takes the (M, 2)
enumeration table is called as its wrapper called it, with the table
copied to the card on every call.  They are built with the port's nvcc
flags (one nvcc per source, all at once). The inputs are those of
``chip_smoke.py``'s timing phase: the full table (8 x 2^21 buckets of 192
B) holding 2^16 written keys, and the arguments captured through the
engine of a write round's first pass (shard_apply, checksum), of a read
round (probe, route_unpack, hash64), of the second of two cached reads
(l1_probe: 2^16 queries on an L1 of 1024 sets x 4 ways) or of the interp
phase's neighbourhood round on a second full table (stencil_keys: 2,978
centres, 22 entries of 20 words); round_sig takes the keys phase's 2 M
values (log-uniform over 1e-30..1e30, sig 3) and, as
``round_sig/one_decade``, 2 M values from [1, 10). Every tree's outputs
are held bit for bit against the plain versions (a tree that differs is
reported and not timed); times are medians of cold-L2 launches
(``chip_smoke.time_cold``; ``--flush read`` clears the L2 by reading
instead, so no dirty lines are written back during the launch), taken in
the order t1..tn, tn..t1, beside the bound ``chip_smoke.py`` computes and
a yardstick: the time of one PyTorch call that moves part of the same
bytes the same way (a streaming float32 sum of the checksum's or hash64's
input size; a zero fill of stencil_keys' output size; a gather of the
value rows shard_apply or probe selects; the route kernels' row gather
``index_select`` by their index without the fill rows; a ``torch.neg`` of
round_sig's input; l1_probe's value rows gathered by the hit line).
``route_pack`` (the read round's send leg) can be named too.
``--misaligned`` hands shard_apply, probe, hash64 and l1_probe a copy of
their key rows (and the slab's values), and round_sig a copy of its
values, one word off 16-byte alignment, to time their 4-byte paths.
``--trace`` also runs each tree's call of the kernels in
``chip_smoke.TRACED`` through ``chip_smoke.trace_cold`` (the event
interval beside the device activities, runtime calls, copies and syncs
torch.profiler finds inside it) and profiles one neighbourhood round of
the installed package (``chip_smoke.stencil_round_profile``). Needs one
NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

KERNELS = {"shard_apply": ("apply", "repro_shard_apply"),
           "checksum": ("checksum", "repro_checksum"),
           "probe": ("probe", "repro_probe"),
           "route_unpack": ("route", "repro_route_unpack"),
           "route_pack": ("route", "repro_route_pack"),
           "hash64": ("hash", "repro_hash64"),
           "stencil_keys": ("stencil", "repro_stencil_keys"),
           "round_sig": ("round", "repro_round_sig"),
           "l1_probe": ("l1", "repro_l1_probe")}
# the older stencil launcher: (x, table, keys, base, n, d, m, kw, sig, span,
# stream), the (M, 2) enumeration table copied by the wrapper on each call
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
STENCIL_TABLE_ARGS = (_P, _P, _P, _P, _L, _I, _I, _I, _I, _L, _P)


def takes_table(src_dir: Path) -> bool:
    """Whether the tree's stencil launcher takes the enumeration table."""
    return "const void* offsets" in (src_dir / "stencil.cu").read_text()


def ptxas_summary(log: str) -> list:
    """The registers and spill lines of an ``nvcc -Xptxas -v`` log, each
    after the tail of its kernel's mangled name."""
    out, current = [], ""
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            current = m.group(1)
        elif re.search(r"registers|spill", ln):
            text = ln.split("ptxas info    : ")[-1].strip()
            out.append(f"{current[-48:]}: {text}")
    return out


def build_tree(label: str, src_dir: Path, kernels: list) -> dict:
    """``{kernel: ctypes function}`` of ``kernels`` from the tree in
    ``src_dir``."""
    out = build.BUILD_DIR / "ab" / label
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lib in {KERNELS[k][0] for k in kernels}:
        so = out / f"{lib}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(src_dir),
               "-o", str(so), str(src_dir / build.LIBRARIES[lib][0])]
        procs[lib] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for lib, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}/{lib}:\n{log}")
        print(json.dumps({"tree": label, "lib": lib,
                          "ptxas": ptxas_summary(log)}), flush=True)
        libs[lib] = ctypes.CDLL(str(so))
    fns = {}
    for kernel in kernels:
        lib, fn = KERNELS[kernel]
        f = getattr(libs[lib], fn)
        f.argtypes = list(build.LIBRARIES[lib][1][fn])
        if kernel == "stencil_keys" and takes_table(src_dir):
            f.argtypes = list(STENCIL_TABLE_ARGS)
            f.takes_table = True
        f.restype = ctypes.c_int
        fns[kernel] = f
    return fns


def callers(fns: dict) -> dict:
    """The wrappers' launch sequences around one tree's C functions."""
    import torch

    from repro_torch.core.neighbors import n_stencil, stencil_offsets

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def shard_apply(sk, sv, sm, sc, q, base, n_probe):
        c, vw = q.shape[0], sv.shape[1]
        vals = torch.empty((c, vw), dtype=torch.int32, device=q.device)
        res = torch.empty((c, 4), dtype=torch.int32, device=q.device)
        err = fns["shard_apply"](
            sk.data_ptr(), sv.data_ptr(), sm.data_ptr(), sc.data_ptr(),
            sk.shape[0], q.data_ptr(), base.data_ptr(), c, q.shape[1], vw,
            n_probe, vals.data_ptr(), res.data_ptr(), stream())
        cs.check(err == 0, f"shard_apply launch failed: {err}")
        return vals, res[:, 0], res[:, 1], res[:, 2], res[:, 3]

    def checksum(keys, vals):
        out = torch.empty((keys.shape[0],), dtype=torch.int32,
                          device=keys.device)
        err = fns["checksum"](
            keys.data_ptr(), keys.stride(0), vals.data_ptr(), vals.stride(0),
            out.data_ptr(), keys.shape[0], keys.shape[1], vals.shape[1],
            stream())
        cs.check(err == 0, f"checksum launch failed: {err}")
        return out

    def probe(sk, sv, sm, sc, q, base, n_probe, validate):
        c, vw = q.shape[0], sv.shape[1]
        vals = torch.empty((c, vw), dtype=torch.int32, device=q.device)
        res = torch.empty((c, 2), dtype=torch.int32, device=q.device)
        err = fns["probe"](
            sk.data_ptr(), sv.data_ptr(), sm.data_ptr(), sc.data_ptr(),
            sk.shape[0], q.data_ptr(), base.data_ptr(), c, q.shape[1], vw,
            n_probe, int(bool(validate)), vals.data_ptr(), res.data_ptr(),
            stream())
        cs.check(err == 0, f"probe launch failed: {err}")
        return vals, res[:, 0], res[:, 1]

    def route_unpack(buf, slot, kept, fill):
        n, width = slot.shape[0], buf.shape[1]
        out = torch.empty((n, width), dtype=torch.int32, device=buf.device)
        err = fns["route_unpack"](
            buf.data_ptr(), slot.data_ptr(), kept.data_ptr(), fill.data_ptr(),
            out.data_ptr(), n, buf.shape[0], width, stream())
        cs.check(err == 0, f"route_unpack launch failed: {err}")
        return out

    def route_pack(mat, inv, fill):
        rows, width = inv.shape[0], mat.shape[1]
        out = torch.empty((rows, width), dtype=torch.int32, device=mat.device)
        err = fns["route_pack"](
            mat.data_ptr(), inv.data_ptr(), fill.data_ptr(), out.data_ptr(),
            mat.shape[0], rows, width, stream())
        cs.check(err == 0, f"route_pack launch failed: {err}")
        return out

    def hash64(keys):
        n, kw = keys.shape
        out = torch.empty((n, 2), dtype=torch.int32, device=keys.device)
        err = fns["hash64"](keys.data_ptr(), out.data_ptr(), n, kw, stream())
        cs.check(err == 0, f"hash64 launch failed: {err}")
        return out

    def stencil_keys(x, sig, kw, radius, coarse, n_buckets, n_probe):
        n, d = x.shape
        m = n_stencil(d, radius, coarse)
        keys = torch.empty((n, m, kw), dtype=torch.int32, device=x.device)
        base = torch.empty((n, m), dtype=torch.int32, device=x.device)
        span = max(n_buckets - n_probe + 1, 1)
        f = fns["stencil_keys"]
        if getattr(f, "takes_table", False):
            table = torch.tensor(stencil_offsets(d, radius, coarse),
                                 dtype=torch.int32, device=x.device)
            err = f(x.data_ptr(), table.data_ptr(), keys.data_ptr(),
                    base.data_ptr(), n, d, m, kw, sig, span, stream())
        else:
            err = f(x.data_ptr(), keys.data_ptr(), base.data_ptr(), n, d,
                    radius, int(coarse), kw, sig, span, stream())
        cs.check(err == 0, f"stencil_keys launch failed: {err}")
        return keys, base

    def round_sig(x, sig):
        out = torch.empty_like(x)
        err = fns["round_sig"](x.data_ptr(), out.data_ptr(), x.numel(), sig,
                               stream())
        cs.check(err == 0, f"round_sig launch failed: {err}")
        return out

    def l1_probe(lkeys, lvals, flags, q, set_idx):
        (sets, ways, kw), vw, n = lkeys.shape, lvals.shape[2], q.shape[0]
        hit = torch.empty((n,), dtype=torch.bool, device=q.device)
        vals = torch.empty((n, vw), dtype=torch.int32, device=q.device)
        err = fns["l1_probe"](
            lkeys.data_ptr(), lvals.data_ptr(), flags.data_ptr(), sets, ways,
            q.data_ptr(), set_idx.data_ptr(), n, kw, vw, hit.data_ptr(),
            vals.data_ptr(), stream())
        cs.check(err == 0, f"l1_probe launch failed: {err}")
        return hit, vals

    return {"shard_apply": shard_apply, "checksum": checksum, "probe": probe,
            "route_unpack": route_unpack, "route_pack": route_pack,
            "hash64": hash64, "stencil_keys": stencil_keys,
            "round_sig": round_sig, "l1_probe": l1_probe}


def interp_round(cfg):
    """The interp phase's round (a): a second full table holding the 2n
    points that bracket chip_smoke's 2,978 centres; returns the surrogate
    pieces and the captured ``stencil_keys`` arguments."""
    from repro_torch.core import (InterpConfig, SurrogateConfig,
                                  lookup_or_interpolate, store,
                                  surrogate_create)
    from repro_torch.kernels import ops

    scfg = SurrogateConfig(n_inputs=10, n_outputs=13, sig_digits=3, dht=cfg)
    icfg = InterpConfig(radius=1, coarse_tier=True)
    st = surrogate_create(scfg, device=cs.DEVICE)
    centres, nbrs = cs._bracketed(scfg, cs.INTERP_CENTRES, cs.DEVICE,
                                  seed=11)
    st, _ = store(scfg, st, nbrs, cs.interp_fn(nbrs))
    with cs.Capture(ops) as cap:
        lookup_or_interpolate(scfg, st, centres, icfg)
    return (scfg, st, centres, icfg), cap.calls["stencil_keys"][0]


def yardstick(kernel: str, a):
    """One PyTorch call that moves part of the kernel's bytes the same way,
    to read the kernel's time against: checksum, a sum over a buffer of
    its input's size (a streaming read); shard_apply and probe, the gather
    of the value rows they select (scattered rows of the slab); the route
    kernels, the row gather by their index without the fill rows;
    round_sig, an elementwise pass of its size (``torch.neg``); l1_probe,
    the gather of the flat (sets * ways, VW) value rows by the hit line
    (misses take line 0).  The sum is taken in float32, whose reduction
    streams at the card's rate (an int32 sum accumulates in int64 and is
    slower)."""
    import torch

    from repro_torch.kernels import ref

    if kernel == "round_sig":
        return (f"torch.neg of {a[0].numel()} float32 values",
                lambda x, *_: torch.neg(x), a)
    if kernel == "l1_probe":
        lkeys, lvals, flags, q, set_idx = a
        s = set_idx.long()
        ok = (lkeys[s] == q[:, None, :]).all(dim=-1) & (flags[s] != 0)
        line = torch.where(ok.any(dim=-1), s * lkeys.shape[1]
                           + torch.argmax(ok.to(torch.int32), dim=-1), 0)
        flat = lvals.reshape(-1, lvals.shape[2])
        return (f"index_select of {line.numel()} value rows of "
                f"{flat.shape[1]} words",
                lambda v, i: torch.index_select(v, 0, i), (flat, line))
    if kernel in ("checksum", "hash64"):
        n = sum(x.numel() for x in a)
        buf = torch.ones(n, dtype=torch.float32, device=a[0].device)
        return f"sum of {n} float32 words", lambda b: b.sum(), (buf,)
    if kernel == "stencil_keys":
        n, d = a[0].shape
        m = 1 + 2 * a[3] * d + int(a[4])
        buf = torch.empty(n * m * (a[2] + 1), dtype=torch.int32,
                          device=a[0].device)
        return (f"zero fill of {buf.numel()} int32 words",
                lambda b: b.zero_(), (buf,))
    if kernel in ("route_unpack", "route_pack"):
        src, idx = a[0], a[1].clamp(min=0).long()
        return (f"index_select of {idx.numel()} rows of {src.shape[1]} "
                "words", lambda b, i: torch.index_select(b, 0, i), (src, idx))
    sk, sv, sm, sc, q, base = a[:6]
    found, rsel = (ref.shard_apply(*a) if kernel == "shard_apply"
                   else ref.probe(*a))[1:3]
    idx = (base.long() + rsel.long())[found != 0]
    return (f"index_select of {idx.numel()} value rows",
            lambda v, i: torch.index_select(v, 0, i), (sv, idx))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="LABEL=DIR, in timing order")
    ap.add_argument("--flush", choices=("write", "read"), default="write",
                    help="clear the L2 before each launch by writing a "
                         "256 MB buffer (chip_smoke.py's timing) or by "
                         "reading one")
    ap.add_argument("--kernels", default="shard_apply,checksum",
                    help="comma-separated, of " + ", ".join(KERNELS))
    ap.add_argument("--misaligned", action="store_true",
                    help="shard_apply, probe, hash64, l1_probe and "
                         "round_sig read a copy of their key rows (the "
                         "slab's values; round_sig's values) one word off "
                         "16-byte alignment (their 4-byte paths)")
    ap.add_argument("--trace", action="store_true",
                    help="trace the event intervals of the kernels in "
                         "chip_smoke.TRACED and one neighbourhood round "
                         "with torch.profiler")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    unknown = sorted(set(kernels) - set(KERNELS))
    if unknown:
        ap.error(f"unknown kernels {unknown}")
    if not torch.cuda.is_available():
        print("torch_write_pass_ab: no CUDA device", file=sys.stderr)
        return 1
    trees = dict(t.split("=", 1) for t in args.tree)
    calls = {lbl: callers(build_tree(lbl, Path(d), kernels))
             for lbl, d in trees.items()}

    from repro_torch.core import DHTConfig
    from repro_torch.kernels import ref

    cfg = DHTConfig(key_words=20, val_words=26, n_shards=8,
                    buckets_per_shard=cs.BIG_BUCKETS, n_probe=6,
                    mode="lockfree")
    gen = torch.Generator().manual_seed(0)
    _st, wcalls, rcalls, lcalls = cs.main_path_capture(cfg, gen)
    captured = {"shard_apply": wcalls, "checksum": wcalls, "probe": rcalls,
                "route_unpack": rcalls, "route_pack": rcalls,
                "hash64": rcalls}
    # input label -> arguments; a label "kernel/case" times ``kernel`` on
    # another input
    inputs = {k: captured[k][k][0] for k in kernels if k in captured}
    if "stencil_keys" in kernels:
        surrogate, inputs["stencil_keys"] = interp_round(cfg)
    if "round_sig" in kernels:
        # the keys phase's 2 M values over 60 decades, and the same count
        # from one decade, [1, 10): the exponent-spread diagnostic
        inputs["round_sig"] = (cs.key_values(cs.KEY_VALUES).to(cs.DEVICE), 3)
        inputs["round_sig/one_decade"] = (
            cs.key_values(cs.KEY_VALUES, (0.0, 1.0)).to(cs.DEVICE), 3)
    if "l1_probe" in kernels:               # the second cached read's
        inputs["l1_probe"] = lcalls["l1_probe"][-1]
    if args.misaligned:
        for k in {"shard_apply", "probe"} & set(kernels):
            a = inputs[k]
            inputs[k] = (cs.off_by_one_word(a[0]), cs.off_by_one_word(a[1]),
                         *a[2:])
        for k in {"hash64", "round_sig"} & set(kernels):
            inputs[k] = (cs.off_by_one_word(inputs[k][0]), *inputs[k][1:])
        if "l1_probe" in kernels:
            a = inputs["l1_probe"]
            inputs["l1_probe"] = (*a[:3], cs.off_by_one_word(a[3]), a[4])
    plain = {"shard_apply": ref.shard_apply, "checksum": ref.checksum,
             "probe": ref.probe, "route_unpack": ref.route_unpack,
             "route_pack": ref.route_pack, "hash64": ref.hash64,
             "stencil_keys": ref.stencil_keys, "round_sig": ref.round_sig,
             "l1_probe": ref.l1_probe}
    wrong = {}
    for label, a in inputs.items():
        kernel = label.split("/")[0]
        for lbl in trees:
            try:
                cs.kernel_vs_plain(f"{lbl}/{label}", calls[lbl][kernel],
                                   plain[kernel], a)
            except RuntimeError as e:           # reported, never timed
                wrong[lbl] = str(e)
    print(json.dumps({"differs_from_plain": wrong}), flush=True)
    trees = {lbl: d for lbl, d in trees.items() if lbl not in wrong}
    cs.warm_card()
    order = list(trees) + list(reversed(trees))
    def timer(fn, fargs):
        return cs.time_cold(fn, fargs, dirty=args.flush == "write")

    result = {"card": cs.nvidia_smi(), "order": order, "flush": args.flush,
              "misaligned": args.misaligned,
              "differs_from_plain": sorted(wrong), "kernels": {}}
    bounds = {"route_unpack": cs.bound_route_unpack,
              "route_pack": cs.bound_route_pack, "hash64": cs.bound_hash64,
              "stencil_keys": cs.bound_stencil_keys,
              "checksum": cs.bound_checksum,
              "round_sig": cs.bound_round_sig,
              "l1_probe": cs.bound_l1_probe}
    for label, a in inputs.items():
        kernel = label.split("/")[0]
        if kernel == "shard_apply":
            _v, found, rsel, _w, _k = ref.shard_apply(*a)
            nbytes, nops = cs.bound_shard_apply(*a, (found, rsel))
        elif kernel == "probe":
            _v, found, rsel = ref.probe(*a)
            nbytes, nops = cs.bound_probe(*a, (found, rsel))
        else:
            nbytes, nops = bounds[kernel](*a)
        times = {lbl: [] for lbl in trees}
        for lbl in order:
            times[lbl].append(timer(calls[lbl][kernel], a))
        what, fn, fargs = yardstick(kernel, a)
        result["kernels"][label] = {
            "shapes": [list(x.shape) for x in a if hasattr(x, "shape")],
            "ms": times, "bound_ms": cs.bound_ms(nbytes, nops)[0],
            "yardstick": {"what": what, "ms": timer(fn, fargs)}}
        if args.trace and kernel in cs.TRACED:
            result["kernels"][label]["trace"] = {
                lbl: cs.trace_cold(calls[lbl][kernel], a) for lbl in trees}
    if args.trace and "stencil_keys" in kernels:
        result["stencil_round_profile"] = cs.stencil_round_profile(
            *surrogate)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
