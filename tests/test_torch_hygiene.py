"""Import hygiene and device defaults of the port.

The port must stand alone: no file of ``src/repro_torch/``, no
``chip_smoke.py`` and no ``examples/torch_poet_reactive_transport.py``
imports ``jax`` or the JAX package ``repro`` (``repro_torch`` is the
port itself).  Its entry points run on the card unless the caller asks
for another device, and raise where there is no card."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "examples" / "torch_poet_reactive_transport.py",
]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_files_exist():
    assert len(FILES) > 10 and all(p.exists() for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path}: forbidden imports {bad}"


def test_entry_points_default_to_cuda():
    """``dht_create(cfg)`` with no device asks for CUDA: on a box without
    a card it raises instead of running on the CPU."""
    from repro_torch.core import DHTConfig, SurrogateConfig, dht_create
    from repro_torch.core import surrogate_create

    cfg = DHTConfig(n_shards=2, buckets_per_shard=64)
    if torch.cuda.is_available():
        assert dht_create(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        dht_create(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        surrogate_create(SurrogateConfig(dht=cfg))
    assert dht_create(cfg, device="cpu").device.type == "cpu"
