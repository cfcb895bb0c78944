"""Carry a table or an L1 cache between the JAX package and the port as
numpy arrays.

The JAX package's ``DHTState`` and ``L1State`` hold uint32 arrays; the
port holds int32 bit-views of the same words in flat buffers with a dump
row.  Nothing
here imports the JAX package: the caller hands over numpy arrays (for
example ``np.asarray(state.keys)``) and the config's fields as a dict
(``dataclasses.asdict(state.cfg)``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.l1cache import L1Config, L1State
from .core.layout import DHTConfig, DHTState, resolve_device


def cfg_from_dict(fields: dict, cls=DHTConfig):
    """A port config (``DHTConfig`` or ``L1Config``) from the reference
    config's fields (unknown keys are an error)."""
    names = {f.name for f in dataclasses.fields(cls)}
    extra = set(fields) - names
    if extra:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(extra)}")
    return cls(**fields)


def _flat(arr: np.ndarray, rows: int, width: int | None,
          dev: torch.device, dtype=np.uint32) -> torch.Tensor:
    """``arr`` as a flat ``rows (x width)`` buffer plus a zero dump row;
    uint32 words become their int32 bit-view, bool stays bool."""
    a = np.array(arr, dtype=dtype)
    if dtype == np.uint32:
        a = a.view(np.int32)
    shape = (rows,) if width is None else (rows, width)
    if a.size != int(np.prod(shape)):
        raise ValueError(f"array of {a.size} words does not fit {shape}")
    a = a.reshape(shape)
    t = torch.from_numpy(a)
    out = torch.zeros((rows + 1,) + shape[1:], dtype=t.dtype, device=dev)
    out[:rows] = t.to(dev)
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


def l1_from_numpy(cfg_fields: dict, keys: np.ndarray, vals: np.ndarray,
                  csum: np.ndarray, gen: np.ndarray, owner: np.ndarray,
                  wmark: np.ndarray, epoch: np.ndarray, live: np.ndarray,
                  shard_wmark: np.ndarray, *,
                  device: str | torch.device | None = None) -> L1State:
    """The port's cache holding the same lines as the reference's
    ``L1State`` arrays: ``keys (sets, ways, KW)``, ``vals (sets, ways,
    VW)``, ``csum``/``gen``/``wmark (sets, ways)`` uint32, ``owner``/
    ``epoch (sets, ways)`` int32, ``live (sets, ways)`` bool and
    ``shard_wmark (S,)`` uint32."""
    cfg = cfg_from_dict(cfg_fields, L1Config)
    dev = resolve_device(device)
    n = cfg.n_lines
    sw = np.array(shard_wmark, dtype=np.uint32).view(np.int32)
    return L1State(
        cfg=cfg,
        flat_keys=_flat(keys, n, cfg.key_words, dev),
        flat_vals=_flat(vals, n, cfg.val_words, dev),
        flat_csum=_flat(csum, n, None, dev),
        flat_gen=_flat(gen, n, None, dev),
        flat_owner=_flat(owner, n, None, dev, np.int32),
        flat_wmark=_flat(wmark, n, None, dev),
        flat_epoch=_flat(epoch, n, None, dev, np.int32),
        flat_live=_flat(live, n, None, dev, np.bool_),
        shard_wmark=torch.from_numpy(sw.copy()).to(dev))


def l1_to_numpy(l1: L1State) -> dict[str, np.ndarray]:
    """The cache's arrays in the reference's shapes and types: uint32
    ``keys``, ``vals``, ``csum``, ``gen``, ``wmark`` and ``shard_wmark``,
    int32 ``owner`` and ``epoch``, bool ``live``."""
    out = {name: getattr(l1, name).cpu().numpy()
           for name in ("keys", "vals", "csum", "gen", "owner", "wmark",
                        "epoch", "live")}
    out["shard_wmark"] = l1.shard_wmark.cpu().numpy()
    for name in ("keys", "vals", "csum", "gen", "wmark", "shard_wmark"):
        out[name] = out[name].view(np.uint32)
    return out
