#!/usr/bin/env python3
"""The write pass's two kernels, shard_apply and checksum, built from
several source trees and timed on the same inputs on one card, in turns.

    python benchmarks/torch_write_pass_ab.py --tree new=src/repro_torch/kernels/csrc \\
        --tree old=DIR [--out FILE]

Each DIR holds an ``apply.cu`` and a ``checksum.cu`` with the port's C
interface and the headers they include.  Both are built with the port's
nvcc flags (one nvcc per source, all at once).  The inputs are those of
``chip_smoke.py``'s timing phase: the full table (8 x 2^21 buckets of
192 B) holding 2^16 written keys, and the arguments of a write round's
first pass captured through the engine.  Every tree's outputs are held
bit for bit against the plain versions (a tree that differs is reported
and not timed); times are medians of cold-L2
launches (``chip_smoke.time_cold``; ``--flush read`` clears the L2 by
reading instead, so no dirty lines are written back during the launch),
taken in the order t1..tn, tn..t1, beside the byte bound
``chip_smoke.py`` computes and a yardstick: the time of one PyTorch call
that moves part of the same bytes the same way (a streaming float32 sum
of the checksum's input size; a gather of the value rows shard_apply selects).  Needs one NVIDIA GPU.
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
           "checksum": ("checksum", "repro_checksum")}


def build_tree(label: str, src_dir: Path) -> dict:
    """``{kernel: ctypes function}`` of the tree in ``src_dir``."""
    out = build.BUILD_DIR / "ab" / label
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lib, fn in KERNELS.values():
        so = out / f"{lib}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(src_dir),
               "-o", str(so), str(src_dir / build.LIBRARIES[lib][0])]
        procs[lib] = (so, fn, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for kernel, (lib, _fn) in KERNELS.items():
        so, fn, p = procs[lib]
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}/{lib}:\n{log}")
        print(json.dumps({"tree": label, "lib": lib, "ptxas": [
            ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
            if re.search(r"registers|spill|smem", ln)]}), flush=True)
        f = getattr(ctypes.CDLL(str(so)), fn)
        f.argtypes = list(build.LIBRARIES[lib][1][fn])
        f.restype = ctypes.c_int
        fns[kernel] = f
    return fns


def callers(fns: dict) -> dict:
    """The wrappers' launch sequences around one tree's C functions."""
    import torch

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

    return {"shard_apply": shard_apply, "checksum": checksum}


def yardstick(kernel: str, a):
    """One PyTorch call that moves part of the kernel's bytes the same way,
    to read the kernel's time against: checksum, a sum over a buffer of
    its input's size (a streaming read); shard_apply, the gather of the
    value rows it selects (scattered rows of the slab).  The sum is taken
    in float32, whose reduction streams at the card's rate (an int32 sum
    accumulates in int64 and is slower)."""
    import torch

    from repro_torch.kernels import ref

    if kernel == "checksum":
        n = a[0].numel() + a[1].numel()
        buf = torch.ones(n, dtype=torch.float32, device=a[0].device)
        return f"sum of {n} float32 words", lambda b: b.sum(), (buf,)
    sk, sv, sm, sc, q, base, n_probe = a
    _v, found, rsel, _w, _k = ref.shard_apply(*a)
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
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_write_pass_ab: no CUDA device", file=sys.stderr)
        return 1
    trees = dict(t.split("=", 1) for t in args.tree)
    calls = {lbl: callers(build_tree(lbl, Path(d))) for lbl, d in
             trees.items()}

    from repro_torch.core import DHTConfig
    from repro_torch.kernels import ref

    cfg = DHTConfig(key_words=20, val_words=26, n_shards=8,
                    buckets_per_shard=cs.BIG_BUCKETS, n_probe=6,
                    mode="lockfree")
    gen = torch.Generator().manual_seed(0)
    _st, wcalls, _r, _l = cs.main_path_capture(cfg, gen)
    inputs = {"shard_apply": wcalls["shard_apply"][0],
              "checksum": wcalls["checksum"][0]}
    plain = {"shard_apply": ref.shard_apply, "checksum": ref.checksum}
    wrong = {}
    for kernel, a in inputs.items():
        for lbl in trees:
            try:
                cs.kernel_vs_plain(f"{lbl}/{kernel}", calls[lbl][kernel],
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
              "differs_from_plain": sorted(wrong), "kernels": {}}
    for kernel, a in inputs.items():
        if kernel == "shard_apply":
            _v, found, rsel, _w, _k = ref.shard_apply(*a)
            nbytes, nops = cs.bound_shard_apply(*a, (found, rsel))
        else:
            nbytes, nops = cs.bound_checksum(*a)
        times = {lbl: [] for lbl in trees}
        for lbl in order:
            times[lbl].append(timer(calls[lbl][kernel], a))
        what, fn, fargs = yardstick(kernel, a)
        result["kernels"][kernel] = {
            "shapes": [list(x.shape) for x in a if hasattr(x, "shape")],
            "ms": times, "bound_ms": cs.bound_ms(nbytes, nops)[0],
            "yardstick": {"what": what, "ms": timer(fn, fargs)}}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
