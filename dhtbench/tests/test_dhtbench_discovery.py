"""A configuration, a traffic mix and a per-layer metric are added as new
files and new entries of BENCHMARK.json alone: the harness finds them
by name, with no edit to a file it has."""
import json
import shutil

import dhtbench_tiny as tiny
from dhtb import manifest


def test_new_config_mix_and_metric_by_file_name_alone(tmp_path):
    bench = tmp_path / "dhtbench"
    shutil.copytree(tiny.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}

    cfg = json.loads((bench / "configs" / "poet-kv.json").read_text())
    cfg["name"] = "poet-kv-w4"
    cfg["dht"]["n_probe"] = 4
    (bench / "configs" / "poet-kv-w4.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "poet-kv.ycsb-b.uniform.json")
                     .read_text())
    mix["read_frac"] = 0.9
    (bench / "traffic" / "poet-kv-w4.ycsb-b90.json").write_text(
        json.dumps(mix))
    (bench / "metrics" / "engine.rounds_seen.w4.py").write_text(
        "def read(ctx):\n    return float(ctx.window.rounds)\n")
    man["configs"].append({**man["configs"][0], "name": "poet-kv-w4",
                           "file": "dhtbench/configs/poet-kv-w4.json"})
    man["workloads"].append({"name": "poet-kv-w4.ycsb-b90",
                             "config": "poet-kv-w4", "traffic": "ycsb-b90",
                             "chips": 1, "why": "a window of 4"})
    for m in man["end_to_end"]:
        if "workloads" in m and "poet-kv.ycsb-b.uniform" in m["workloads"]:
            m["workloads"].append("poet-kv-w4.ycsb-b90")
    man["per_layer"].append({"name": "engine.rounds_seen.w4", "unit": "rounds",
                             "better": "higher", "source": "program_counter",
                             "layer": "engine round", "moves": "kv_ops_per_s",
                             "workloads": ["poet-kv-w4.ycsb-b90"]})
    # a quantity split anew is read by the reader it splits: no new file
    man["per_layer"].append({"name": "engine.issue_ms.w4", "unit": "ms",
                             "better": "lower", "source": "program_span",
                             "layer": "engine round", "moves": "kv_ops_per_s",
                             "workloads": ["poet-kv-w4.ycsb-b90"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    spec = tiny.tiny_spec("poet-kv-w4.ycsb-b90", bench=bench, man=man)
    assert spec["config"]["dht"]["n_probe"] == 4
    assert spec["traffic"]["read_frac"] == 0.9
    result, checks = tiny.run_tiny(spec, trace=True)
    assert result["correct"], checks
    assert result["metrics"]["engine.rounds_seen.w4"]["value"] >= 1
    assert result["metrics"]["engine.issue_ms.w4"]["value"] > 0
    result, _ = tiny.run_tiny(spec)
    assert set(result["metrics"]) == {"kv_ops_per_s", "round_ms_p95",
                                      "setup_s"}
    after = {p.relative_to(bench): p.read_bytes()
             for p in bench.rglob("*") if p.is_file() and
             "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
    assert manifest.load_manifest(tmp_path / "BENCHMARK.json") == man
