"""What the benchmark runs loads neither JAX nor the JAX package (by
whole top-level name: ``repro_torch`` is not ``repro``), and reads
nothing of ``benchmarks/`` or ``chip_smoke.py``; the reference takes
nothing of the program."""
import ast
import json
import subprocess
import sys

import dhtbench_tiny as tiny

SOURCES = [p for p in tiny.BENCH.rglob("*.py") if "tests" not in p.parts]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for p in SOURCES:
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks",
                           "chip_smoke"}, p
        text = p.read_text()
        assert "chip_smoke.py" not in text and "benchmarks/" not in text, p


def test_reference_imports_nothing_of_the_program():
    for p in (tiny.BENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(p)}
        assert tops <= {"__future__", "copy", "pathlib", "sys", "torch",
                       "table"}, (p, tops)


def test_a_run_loads_no_forbidden_module():
    """A whole tiny run of each cell in a fresh process, then every
    loaded module's top-level name."""
    code = f"""
import json, sys
sys.path.insert(0, {str(tiny.BENCH / 'tests')!r})
import dhtbench_tiny as tiny
import run
for name in tiny.CELLS:
    result, checks = tiny.run_tiny(tiny.tiny_spec(name), trace=True)
    assert result["correct"], checks
files = [getattr(m, "__file__", None) or "" for m in list(sys.modules.values())]
print(json.dumps({{"bad": run.forbidden_modules(),
                  "read": [f for f in files if "benchmarks" in f
                           or f.endswith("chip_smoke.py")]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tiny.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "read": []}


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(tiny.BENCH))
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_like"] = sys
        assert "repro" not in run.forbidden_modules()
        sys.modules["repro.core"] = sys
        assert "repro" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
