#!/usr/bin/env python3
"""How a CUDA kernel issues its device-memory loads, read from its SASS.

    python benchmarks/torch_sass_loads.py SRC.cu [SRC.cu ...] [--out FILE]

Compiles each source for sm_90a with the port's nvcc flags (``-cubin``
instead of ``-shared``; headers from the source's own directory), dumps
the machine code with ``cuobjdump -sass`` and prints one JSON line per
kernel: the count of each memory instruction (LDG global loads, LDGSTS
cp.async copies, UBLKCP bulk/TMA copies, LDS/STS shared, STG global
stores, VOTE/SHFL warp exchanges, BAR barriers) and, for the LDGs, how
many are in flight when each one's result is first read: the LDGs
issued from it up to the first later instruction that reads one of its
destination registers, in listing order (``ldg_in_flight_max`` and
``_median``).  A load that is used before the next one is issued
counts 1: such loads pay their latencies in series.  LDGSTS and UBLKCP
copies hold no registers and complete at a wait.  Needs the CUDA
toolkit (nvcc, cuobjdump).
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COUNTED = ("LDG", "LDGSTS", "UBLKCP", "LDS", "STS", "STG", "VOTE", "SHFL",
           "BAR")


def _nvcc_flags() -> list[str]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    return [build.nvcc_path(), *flags, "-cubin"]


def sass(src: Path) -> str:
    nvcc = _nvcc_flags()
    cuobjdump = Path(nvcc[0]).with_name("cuobjdump")
    if not cuobjdump.exists():
        cuobjdump = Path(shutil.which("cuobjdump") or "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / (src.stem + ".cubin")
        subprocess.run([*nvcc, "-I", str(src.parent), "-o", str(cubin),
                        str(src)], check=True, capture_output=True, text=True)
        return subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                              check=True, capture_output=True,
                              text=True).stdout


INSN = re.compile(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)\s*([^;]*);")
REG = re.compile(r"\bR(\d+)\b")


def _instructions(part: str) -> list[tuple[str, str, str]]:
    """(opcode, suffixes, operands) of each instruction, in order."""
    return [m.groups() for m in map(INSN.search, part.splitlines()) if m]


def _reads(op: str, operands: str) -> set[int]:
    """Registers an instruction reads: all operands of a store, else all
    but the first (the destination)."""
    if not op.startswith(("ST", "RED", "ATOM")):
        operands = operands.split(",", 1)[1] if "," in operands else ""
    return {int(r) for r in REG.findall(operands)}


def _in_flight(insns) -> list[int]:
    """For each LDG: the LDGs issued from it until its result is read."""
    out = []
    for i, (op, suffix, operands) in enumerate(insns):
        m = REG.match(operands.strip())
        if op != "LDG" or not m:
            continue
        width = 4 if ".128" in suffix else 2 if ".64" in suffix else 1
        dest = set(range(int(m.group(1)), int(m.group(1)) + width))
        n = 1
        for op2, _s, operands2 in insns[i + 1:]:
            if dest & _reads(op2, operands2):
                break
            n += op2 == "LDG"
        out.append(n)
    return out


def summarize(text: str) -> list[dict]:
    """One record per ``Function :`` section of a cuobjdump listing."""
    out = []
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        insns = _instructions(part)
        counts = dict.fromkeys(COUNTED, 0)
        for op, _s, _o in insns:
            if op in counts:
                counts[op] += 1
        flight = sorted(_in_flight(insns)) or [0]
        out.append({"kernel": name, **counts,
                    "ldg_in_flight_max": flight[-1],
                    "ldg_in_flight_median": flight[len(flight) // 2]})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--out", type=Path, help="also write the lines here")
    args = ap.parse_args()
    lines = []
    for src in args.sources:
        for rec in summarize(sass(src)):
            lines.append(json.dumps({"source": str(src), **rec}))
    print("\n".join(lines))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
