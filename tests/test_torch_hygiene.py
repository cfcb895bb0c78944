"""Import hygiene and device defaults of the port.

The port must stand alone: no file of ``src/repro_torch/``, no
``chip_smoke.py`` and no ``examples/torch_*.py`` twin imports ``jax`` or the JAX package ``repro`` (``repro_torch`` is the
port itself).  Its entry points run on the card unless the caller asks
for another device, and raise where there is no card."""
import ast
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "examples" / "torch_poet_reactive_transport.py",
    ROOT / "examples" / "torch_serve_prefix_cache.py",
    ROOT / "examples" / "torch_quickstart.py",
    ROOT / "examples" / "torch_train_lm.py",
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
    core = ROOT / "src" / "repro_torch" / "core"
    for name in ("pipeline.py", "async_sim.py"):
        assert core / name in FILES, name


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


def test_init_lm_defaults_to_cuda():
    """``init_lm(cfg, generator=...)`` with no device asks for CUDA, and
    so do the cache and the weight conversion."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import init_cache, init_lm

    cfg = reduced(get_config("gemma3-12b"))
    if torch.cuda.is_available():
        gen = torch.Generator(device="cuda").manual_seed(0)
        assert init_lm(cfg, generator=gen).embed.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        init_lm(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_numpy(cfg, {})
    lm = init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert lm.embed.device.type == "cpu"
