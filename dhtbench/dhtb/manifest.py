"""``BENCHMARK.json`` and the files it names.

A cell ``<name>`` of ``workloads`` finds:

- its configuration: the ``file`` of the ``configs`` entry it names
  (``dhtbench/configs/<config>.json``);
- its traffic mix: ``dhtbench/traffic/<cell name>.json``, whose ``kind``
  names the generator ``dhtbench/traffic/<kind>.py``, the client of the
  program ``dhtbench/clients/<kind>.py`` and the plain reference
  ``dhtbench/reference/<kind>.py``;
- each per-layer metric ``<metric>``: the reader
  ``dhtbench/metrics/<metric>.py``, or, where there is none, that of the
  quantity the metric splits by the end-to-end metric it moves:
  ``engine.issue_ms.kv`` is read by ``dhtbench/metrics/engine.issue_ms.py``.

Nothing here lists a cell, a configuration or a metric by name: a new one
is new files plus new entries in ``BENCHMARK.json``.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]      # dhtbench/
REPO = BENCH_DIR.parent                              # the checkout's root
MANIFEST = REPO / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(manifest: dict, cell_name: str, bench: Path = BENCH_DIR) -> dict:
    """Everything one cell needs, read from the files the names point
    to: ``cell``, ``config`` (the file's contents), ``traffic`` (the mix
    file's contents), ``kind``, the metric entries it reports, and
    ``bench``, the benchmark's directory the files are found in."""
    cell = _by_name(manifest["workloads"], cell_name, "workload")
    centry = _by_name(manifest["configs"], cell["config"], "config")
    config = load_json(bench.parent / centry["file"])
    traffic = load_json(bench / "traffic" / f"{cell_name}.json")
    return {
        "bench": bench,
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "kind": traffic["kind"],
        "end_to_end": [m for m in manifest["end_to_end"]
                       if cell_name in m.get("workloads", [cell_name])],
        "per_layer": [m for m in manifest["per_layer"]
                      if _reports(manifest, m, cell_name)],
    }


def _reports(manifest: dict, metric: dict, cell_name: str) -> bool:
    """A per-layer metric is read in a cell it lists, or, with no list,
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    moved = _by_name(manifest["end_to_end"], metric["moves"], "metric")
    return cell_name in moved.get("workloads", [cell_name])


def metric_reader(name: str, bench: Path = BENCH_DIR):
    """The reader module of the per-layer metric ``name``: its own file,
    else that of ``name`` less its last dotted part."""
    if not (bench / "metrics" / f"{name}.py").is_file() and "." in name:
        return load_module("metrics", name.rsplit(".", 1)[0], bench)
    return load_module("metrics", name, bench)


def load_module(subdir: str, name: str, bench: Path = BENCH_DIR):
    """Import ``<bench>/<subdir>/<name>.py`` (names may hold dots and
    dashes, so it is loaded from its path, under a name of its own)."""
    path = bench / subdir / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    mod_name = "dhtbench_" + re.sub(r"\W", "_", str(path.with_suffix("")))
    mod = sys.modules.get(mod_name)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
