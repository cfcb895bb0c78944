"""Run one cell of the DHT benchmark once, on the card this process sees.

    python3 dhtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; its last key, ``checks``, holds
each number the reference compared beside its limit, as do the last
lines of standard error.  No card, or fewer than the cell asks for: exit
2 and no result.  JAX or the JAX package loaded: exit 3 and no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Every cache the program or torch may write goes to a fixed
    directory inside the checkout; nothing pulls in JAX behind the
    program's back."""
    build = REPO / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(BENCH), str(REPO / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from dhtb import cell, manifest

    spec = manifest.cell_spec(manifest.load_manifest(), args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"dhtbench: the cell needs {chips} CUDA device(s); "
              f"this process sees {n}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, checks = cell.run(spec, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"dhtbench: loaded {', '.join(bad)}: the benchmark runs "
              "without JAX and the JAX package", file=sys.stderr)
        return 3
    for name, c in checks.items():
        bound = "at least" if name == "rounds_checked" else "at most"
        print(f"check {name}: {c['value']} ({bound} {c['limit']}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
