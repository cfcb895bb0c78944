"""Carry a table between the JAX package and the port as numpy arrays.

The JAX package's ``DHTState`` holds uint32 arrays; the port holds int32
bit-views of the same words in flat buffers with a dump row.  Nothing
here imports the JAX package: the caller hands over numpy arrays (for
example ``np.asarray(state.keys)``) and the config's fields as a dict
(``dataclasses.asdict(state.cfg)``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.layout import DHTConfig, DHTState, resolve_device


def cfg_from_dict(fields: dict) -> DHTConfig:
    """A port ``DHTConfig`` from the reference config's fields (unknown
    keys are an error)."""
    names = {f.name for f in dataclasses.fields(DHTConfig)}
    extra = set(fields) - names
    if extra:
        raise ValueError(f"unknown DHTConfig fields: {sorted(extra)}")
    return DHTConfig(**fields)


def _flat(arr: np.ndarray, rows: int, width: int | None,
          dev: torch.device) -> torch.Tensor:
    a = np.array(arr, dtype=np.uint32).view(np.int32)
    shape = (rows,) if width is None else (rows, width)
    if a.size != int(np.prod(shape)):
        raise ValueError(f"array of {a.size} words does not fit {shape}")
    a = a.reshape(shape)
    out = torch.zeros((rows + 1,) + shape[1:], dtype=torch.int32, device=dev)
    out[:rows] = torch.from_numpy(a).to(dev)
    return out


def state_from_numpy(cfg_fields: dict, keys: np.ndarray, vals: np.ndarray,
                     meta: np.ndarray, csum: np.ndarray, *,
                     device: str | torch.device | None = None) -> DHTState:
    """The port's state holding the same words as the reference's
    ``(S, B, KW)``/``(S, B, VW)``/``(S, B)``/``(S, B)`` uint32 arrays."""
    cfg = cfg_from_dict(cfg_fields)
    dev = resolve_device(device)
    rows = cfg.n_shards * cfg.buckets_per_shard
    return DHTState(cfg=cfg,
                    flat_keys=_flat(keys, rows, cfg.key_words, dev),
                    flat_vals=_flat(vals, rows, cfg.val_words, dev),
                    flat_meta=_flat(meta, rows, None, dev),
                    flat_csum=_flat(csum, rows, None, dev))


def state_to_numpy(state: DHTState) -> dict[str, np.ndarray]:
    """The table's words as uint32 numpy arrays in the reference's
    shapes: ``{"keys", "vals", "meta", "csum"}``."""
    return {name: getattr(state, name).cpu().numpy().view(np.uint32)
            for name in ("keys", "vals", "meta", "csum")}
