"""Carry a table, an L1 cache or a language model's weights between the
JAX package and the port as numpy arrays.

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
from .core.layout import DHTConfig, DHTState, resolve_device, with_ring
from .models.config import ModelConfig
from .models.model import LM, init_lm
from .models.stack import find_period


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
                     meta: np.ndarray, csum: np.ndarray, *, ring=None,
                     device: str | torch.device | None = None) -> DHTState:
    """The port's state holding the same words as the reference's
    ``(S, B, KW)``/``(S, B, VW)``/``(S, B)``/``(S, B)`` uint32 arrays.
    ``ring`` is the port's ``membership.RingState`` to place keys by (the
    port's ``ring_create`` builds the reference's ring word for word)."""
    cfg = cfg_from_dict(cfg_fields)
    dev = resolve_device(device)
    rows = cfg.n_shards * cfg.buckets_per_shard
    st = DHTState(cfg=cfg,
                  flat_keys=_flat(keys, rows, cfg.key_words, dev),
                  flat_vals=_flat(vals, rows, cfg.val_words, dev),
                  flat_meta=_flat(meta, rows, None, dev),
                  flat_csum=_flat(csum, rows, None, dev))
    return st if ring is None else with_ring(st, ring)


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


def _load(dst: torch.Tensor, arr) -> None:
    a = np.asarray(arr, dtype=np.float32)
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"weight of shape {a.shape} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(a))


def _load_dict(dst, tree: dict) -> None:
    """Each entry of ``tree`` into the same name of ``dst`` (a norm's
    ``scale``/``bias``)."""
    if set(tree) != set(dst.keys()):
        raise ValueError(f"entries {sorted(tree)} differ from "
                         f"{sorted(dst.keys())}")
    for name, arr in tree.items():
        _load(dst[name], arr)


def _take(tree, i: int):
    """Period ``i`` of a tree of stacked ``(n_periods, ...)`` arrays."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def lm_params_from_numpy(cfg: ModelConfig, tree: dict, *,
                         device: str | torch.device | None = None) -> LM:
    """The port's model holding the weights of ``repro.models.init_lm``'s
    tree, given as numpy arrays (for example ``jax.tree.map(np.asarray,
    params)``): ``embed.table``, ``final_norm``, and the stack's ``scan``
    params stacked ``(n_periods, ...)`` per period position (layer
    ``i * p + j`` is period i, position j) followed by its ``tail`` list.
    Matrices are stored in ``cfg.dtype``, norm scales and the embedding
    table in float32."""
    dev = resolve_device(device)
    lm = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                 device=dev)
    p, n_full, _tail = find_period(cfg.block_pattern)
    stack = tree["stack"]
    with torch.no_grad():
        _load(lm.embed, tree["embed"]["table"])
        _load_dict(lm.final_norm, tree["final_norm"])
        for i, layer in enumerate(lm.stack.layers):
            if i < n_full * p:
                bt = _take(stack["scan"][f"b{i % p}"], i // p)
            else:
                bt = stack["tail"][i - n_full * p]
            for name in ("ln1", "ln2", "pn1", "pn2"):
                if name in bt:
                    _load_dict(getattr(layer, name), bt[name])
            at, attn = bt["attn"], layer.attn
            for name in ("q", "k", "v"):
                _load(getattr(attn, f"w{name}"), at[f"w{name}"]["w"])
                if "b" in at[f"w{name}"]:
                    _load(getattr(attn, f"b{name}"), at[f"w{name}"]["b"])
            _load(attn.wo, at["wo"]["w"])
            for name in ("q_norm", "k_norm"):
                if name in at:
                    _load_dict(getattr(attn, name), at[name])
            if set(bt["mlp"]) != set(layer.mlp.keys()):
                raise ValueError(f"layer {i}: mlp weights {sorted(bt['mlp'])}")
            for name, w in bt["mlp"].items():
                _load(layer.mlp[name], w["w"])
    lm.refresh_head()
    return lm
