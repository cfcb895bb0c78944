"""BENCHMARK.json against the benchmark's rules: names, units, the
files each entry names, and which metrics each cell reports."""
import json
import re

import dhtbench_tiny as tiny
from dhtb import manifest

MAN = manifest.load_manifest()
LINE_RE = re.compile(r"^[^\t\n]{1,200}$")


def _metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["dhtbench"]
    assert all(LINE_RE.match(w) for w in MAN["command"])
    assert MAN["command"][1].startswith("dhtbench/")


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in MAN["configs"]]
             + [w["name"] for w in MAN["workloads"]]
             + [m["name"] for m in _metrics()]
             + [w["traffic"] for w in MAN["workloads"]]
             + [k for c in MAN["configs"] for k in c["reduced"]])
    for n in names:
        assert manifest.NAME_RE.match(n), n
    for group in (MAN["configs"], MAN["workloads"], _metrics()):
        assert len({e["name"] for e in group}) == len(group)
    for m in _metrics():
        assert manifest.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in MAN["workloads"]]
                 + [c["why"] for c in MAN["configs"]]
                 + [c["source"] for c in MAN["configs"]]
                 + [m["layer"] for m in MAN["per_layer"]]):
        assert LINE_RE.match(text), text


def test_entries_have_just_the_allowed_keys():
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }
    for group, keys in allowed.items():
        for e in MAN[group]:
            assert set(e) <= keys, (group, e)


def test_bounds_and_sources():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
            assert re.match(r"^[a-z0-9_]+_roofline(\.[a-z]+)?$", m["name"])


def test_every_named_file_exists():
    for c in MAN["configs"]:
        path = manifest.REPO / c["file"]
        assert path.is_file() and c["file"].startswith("dhtbench/")
        assert json.loads(path.read_text())["name"] == c["name"]
    for w in MAN["workloads"]:
        spec = manifest.cell_spec(MAN, w["name"])
        for sub in ("traffic", "clients", "reference"):
            assert (manifest.BENCH_DIR / sub / f"{spec['kind']}.py").is_file()
    for m in MAN["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]).read), m["name"]


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MAN["workloads"]:
        spec = manifest.cell_spec(MAN, w["name"])
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(MAN["workloads"]) // 4)


def test_layers_are_named_alike():
    assert {m["layer"] for m in MAN["per_layer"]} == {
        "engine round", "engine write passes", "routing", "kernels",
        "device"}
    assert tiny.CELLS == [w["name"] for w in MAN["workloads"]]
