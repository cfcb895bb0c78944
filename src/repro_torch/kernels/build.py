"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/*.cu`` file becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <src>.cu

into ``build/repro_torch_kernels/`` at the root of the checkout, at first
use.  The library name carries a hash of its source, every shared header
and the flags, so a stale build is never loaded.  No ``--use_fast_math``:
the rounding kernels must call the same full-precision ``logf`` as
``torch.log``.  All missing libraries are compiled in parallel,
one ``nvcc`` per source.  A failed build raises; so does a launch whose
returned ``cudaError_t`` is not 0.  ``LAUNCHES`` counts successful
launches per kernel: :func:`launch` is the one place that increments it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library -> (source, {exported function: argument types})
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARIES = {
    "route": ("route.cu", {
        "repro_route_pack": (_P, _P, _P, _P, _L, _L, _I, _P),
        "repro_route_unpack": (_P, _P, _P, _P, _P, _L, _L, _I, _P),
    }),
    "hash": ("hash.cu", {
        "repro_hash64": (_P, _P, _L, _I, _P),
        "repro_hash64_max_kw": (),
    }),
    "apply": ("apply.cu", {
        "repro_shard_apply": (_P, _P, _P, _P, _L, _P, _P, _L, _I, _I, _I, _P,
                              _P, _P),
        "repro_shard_apply_max_width": (),
    }),
    "checksum": ("checksum.cu", {
        "repro_checksum": (_P, _L, _P, _L, _P, _L, _I, _I, _P),
        "repro_checksum_max_width": (),
    }),
    "round": ("round.cu", {
        "repro_round_sig": (_P, _P, _L, _I, _P),
    }),
    "stencil": ("stencil.cu", {
        "repro_stencil_keys": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _L, _P),
        "repro_stencil_keys_max_dims": (),
    }),
    "probe": ("probe.cu", {
        "repro_probe": (_P, _P, _P, _P, _L, _P, _P, _L, _I, _I, _I, _I, _P,
                        _P, _P),
    }),
    "l1": ("l1.cu", {
        "repro_l1_probe": (_P, _P, _P, _I, _I, _P, _P, _L, _I, _I, _P, _P,
                           _P),
    }),
    "local_attn": ("local_attn.cu", {
        "repro_local_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _L, _L, _L, _L, _L, _L, _L, _L, _L, _P),
    }),
}

LAUNCHES: dict[str, int] = {
    "route_pack": 0, "route_unpack": 0, "hash64": 0, "shard_apply": 0,
    "checksum": 0, "round_sig": 0, "stencil_keys": 0, "probe": 0,
    "l1_probe": 0, "local_attention": 0}

_loaded: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built
# by this process
PTXAS_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    """Build path of library ``name``: its hash covers the flags, its
    source and every shared header (``csrc/*.cuh``), so a change to any
    header a source may include gives a new name."""
    src = LIBRARIES[name][0]
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every library in ``names`` (default: all) that is not
    built yet, all ``nvcc`` processes at once.  Returns the paths."""
    names = list(LIBRARIES) if names is None else list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / LIBRARIES[n][0])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        PTXAS_LOG[n] = out
        if p.returncode != 0:
            failed.append(f"{n} (exit {p.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed (a first load
    builds every missing library in one parallel batch)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build_all([n for n in LIBRARIES if n not in _loaded])[name]
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in LIBRARIES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def launch(kernel: str, lib_name: str, fn: str, *args) -> None:
    """Call the C launcher ``fn`` of library ``lib_name``; raise if it
    reports an error, else count one launch of ``kernel``."""
    lib = load(lib_name)
    err = getattr(lib, fn)(*args)
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{kernel}: launch failed, cudaError {err}: {msg}")
    LAUNCHES[kernel] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
