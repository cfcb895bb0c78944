"""The command around the card: no card, no result; a
checkout of the benchmark's files alone gives no result either; on the
card (``-m cuda``) a short run of each cell prints a correct line."""
import json
import shutil
import subprocess
import sys

import pytest

import dhtbench_tiny as tiny


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "dhtbench/run.py", "--workload", tiny.CELLS[0],
         "--seed", str(2**31 + 5), "--seconds", "2", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=900)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(tiny.REPO)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(tiny.BENCH, tmp_path / "dhtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.CELLS)
def test_card_run_is_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "dhtbench/run.py", "--workload", name, "--seed",
         str(2**31 + 7), "--seconds", "2", "--trace", "0"],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
