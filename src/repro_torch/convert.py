"""Carry a table, an L1 cache, a language model's weights or its
optimizer state between the JAX package and the port as numpy arrays.

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
    """``arr`` (a numpy array, or a tensor of any float type on any
    device, as ``checkpoint.restore`` gives them) into ``dst``."""
    src = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.asarray(arr, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"weight of shape {tuple(src.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


def _take(tree, i: int):
    """Period ``i`` of a tree of stacked ``(n_periods, ...)`` arrays."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i] if isinstance(tree, torch.Tensor) else np.asarray(tree)[i]


def _load_tree(dst, tree: dict, what: str) -> None:
    """A nested tree of arrays into the container of the same names (a
    ``ParameterDict``, ``ParamTree`` or ``Block``: a norm, an MLP, the
    ``moe``, ``ssd`` and ``rec`` trees); names that differ raise.  A
    matrix the container holds bare (an MLP's) takes its ``{"w": W}``."""
    names = set(dst.keys())
    if set(tree) != names:
        raise ValueError(f"{what} weights {sorted(tree)} differ from "
                         f"{sorted(names)}")
    for name, sub in tree.items():
        target = dst[name]
        if isinstance(target, torch.Tensor):
            if isinstance(sub, dict):
                if set(sub) != {"w"}:
                    raise ValueError(f"{what}.{name} weights {sorted(sub)}")
                sub = sub["w"]
            _load(target, sub)
        elif name == "attn":
            _load_attn(target, sub, f"{what}.attn")
        else:
            _load_tree(target, sub, f"{what}.{name}")


def _load_attn(attn, at: dict, what: str) -> None:
    for name in ("q", "k", "v"):
        _load(getattr(attn, f"w{name}"), at[f"w{name}"]["w"])
        if "b" in at[f"w{name}"]:
            _load(getattr(attn, f"b{name}"), at[f"w{name}"]["b"])
    _load(attn.wo, at["wo"]["w"])
    for name in ("q_norm", "k_norm"):
        if name in at:
            _load_tree(getattr(attn, name), at[name], f"{what}.{name}")


def lm_params_from_numpy(cfg: ModelConfig, tree: dict, *,
                         device: str | torch.device | None = None) -> LM:
    """The port's model holding the weights of ``repro.models.init_lm``'s
    tree, given as numpy arrays (for example ``jax.tree.map(np.asarray,
    params)``) or as tensors (``checkpoint.restore`` of the reference's
    checkpoint): ``embed.table``, ``head.table`` where the head is untied,
    ``final_norm``, and the stack's ``scan`` params stacked
    ``(n_periods, ...)`` per period position (layer ``i * p + j`` is
    period i, position j) followed by its ``tail`` list.  A layer's tree
    has its block's names: ``ln1``, ``attn``, ``ln2``, ``mlp`` (a ``moe``
    block's ``moe`` tree in its place; ``pn1``/``pn2`` with post-norms),
    ``ln1`` and ``ssd`` for an ``ssd`` block, ``ln1``, ``rec``, ``ln2``
    and ``mlp`` for an ``rglru`` block; other names raise.  Matrices (an
    untied head, the experts, the SSD and RG-LRU projections and conv
    weights too) are stored in ``cfg.dtype``; norm scales, the MoE
    router, ``A_log``/``D``/``dt_bias``, ``lam`` and the embedding table
    in float32."""
    dev = resolve_device(device)
    lm = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                 device=dev)
    return load_lm_params(lm, tree)


def load_lm_params(lm: LM, tree: dict) -> LM:
    """``lm_params_from_numpy``'s loading into an existing model: the
    tree's arrays (or tensors) copied into ``lm``'s parameters, each cast
    to its type; the tied head refreshed.  Returns ``lm``."""
    cfg = lm.cfg
    p, n_full, _tail = find_period(cfg.block_pattern)
    stack = tree["stack"]
    with torch.no_grad():
        _load(lm.embed, tree["embed"]["table"])
        if ("head" in tree) == cfg.tie_embeddings:
            raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings}"
                             f" but the tree has entries {sorted(tree)}")
        if not cfg.tie_embeddings:
            _load(lm.head, tree["head"]["table"])
        _load_tree(lm.final_norm, tree["final_norm"], "final_norm")
        for i, layer in enumerate(lm.stack.layers):
            if i < n_full * p:
                bt = _take(stack["scan"][f"b{i % p}"], i // p)
            else:
                bt = stack["tail"][i - n_full * p]
            _load_tree(layer, bt, f"layer {i}: a {layer.kind} block's")
    lm.refresh_head()
    return lm


_MLP_TREES = ("mlp", "shared")   # the port holds their matrices bare


def lm_param_paths(lm: LM) -> dict[str, tuple[str, int | None]]:
    """Each parameter of ``lm`` (its ``named_parameters`` name) -> its
    reference path and period: ``("stack/scan/b0/attn/wq/b", 2)`` is
    period 2 of the reference's stacked ``(n_periods, ...)`` leaf,
    ``("stack/tail/0/ln1/scale", None)``, ``("embed/table", None)``.  The
    port's ``bq``/``bk``/``bv`` are the reference's ``wq/b``..., its MLP
    matrices the reference's ``{"w": W}`` entries."""
    p, n_full, _tail = find_period(lm.cfg.block_pattern)
    out = {}
    for name, _ in lm.named_parameters():
        parts = name.split(".")
        period = None
        if parts[0] in ("embed", "head"):
            path = [parts[0], "table"]
        elif parts[0] == "final_norm":
            path = parts
        else:                                     # stack.layers.<i>.<rest>
            i, rest = int(parts[2]), parts[3:]
            if i < n_full * p:
                path, period = ["stack", "scan", f"b{i % p}"], i // p
            else:
                path = ["stack", "tail", str(i - n_full * p)]
            if rest[0] == "attn" and rest[1][0] == "b" and len(rest) == 2:
                rest = ["attn", "w" + rest[1][1:], "b"]          # bq -> wq/b
            elif rest[0] == "attn" and rest[1] in ("wq", "wk", "wv", "wo"):
                rest = rest + ["w"]
            elif len(rest) >= 2 and rest[-2] in _MLP_TREES:
                rest = rest + ["w"]
            path += rest
        out[name] = ("/".join(path), period)
    return out


def _nest(flat: dict[str, np.ndarray]) -> dict:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``; the stack's
    ``tail`` becomes a list, as in the reference's tree."""
    tree: dict = {}
    for path, x in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = x
    tail = tree.get("stack", {}).get("tail")
    if tail is not None:
        tree["stack"]["tail"] = [tail[str(i)] for i in range(len(tail))]
    return tree


def lm_tree(lm: LM, values: dict) -> dict:
    """``values`` ({parameter name: tensor}) as the reference's nested
    tree of float32 numpy arrays, periods stacked on axis 0."""
    paths = lm_param_paths(lm)
    flat: dict[str, list] = {}
    for name, (path, period) in paths.items():
        x = values[name].detach().to(torch.float32).cpu().numpy()
        if period is None:
            flat[path] = x
        else:
            flat.setdefault(path, []).append((period, x))
    return _nest({k: (np.stack([x for _, x in sorted(v)])
                      if isinstance(v, list) else v)
                  for k, v in flat.items()})


def lm_params_to_numpy(lm: LM, masters: dict | None = None) -> dict:
    """The port's weights as ``repro.models.init_lm``'s tree of float32
    numpy arrays (the inverse of ``lm_params_from_numpy``).  ``masters``
    ({parameter name: float32 tensor}, an optimizer state's ``"master"``)
    replaces the working copies it holds: the float32 parameters the
    reference's trainer updates."""
    masters = masters or {}
    return lm_tree(lm, {n: masters.get(n, p)
                         for n, p in lm.named_parameters()})


def opt_state_to_numpy(lm: LM, state: dict) -> dict:
    """An optimizer state of ``lm`` (``optim.init_opt_state`` over its
    named parameters) as the reference's: ``{"mu", "nu"}`` trees and
    ``"step"`` (int32).  Masters are the reference's float32 parameters:
    ``lm_params_to_numpy(lm, state["master"])``."""
    return {"mu": lm_tree(lm, state["mu"]), "nu": lm_tree(lm, state["nu"]),
            "step": np.asarray(int(state["step"]), dtype=np.int32)}


def opt_state_from_numpy(lm: LM, tree: dict) -> dict:
    """The reference's optimizer state (``{"mu", "nu", "step"}`` and
    optionally ``"master"``, trees of arrays) as the port's state over
    ``lm``'s named parameters, on their devices: the moments float32,
    a master for each parameter that is not float32."""
    paths = lm_param_paths(lm)
    params = dict(lm.named_parameters())
    dev = next(iter(params.values())).device

    def leaf(t, name) -> torch.Tensor:
        """The float32 value of parameter ``name``'s entry of tree ``t`` on
        its device (a restored tensor is sliced where it lies)."""
        path, period = paths[name]
        node = t
        for k in path.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        if not isinstance(node, torch.Tensor):
            node = np.asarray(node, dtype=np.float32)
            node = torch.from_numpy(np.ascontiguousarray(
                node if period is None else node[period]))
        elif period is not None:
            node = node[period]
        return node.to(device=params[name].device,
                       dtype=torch.float32).clone()

    st = {"mu": {n: leaf(tree["mu"], n) for n in params},
          "nu": {n: leaf(tree["nu"], n) for n in params},
          "step": torch.tensor(int(tree["step"]), dtype=torch.int32,
                               device=dev)}
    if "master" in tree:
        st["master"] = {n: leaf(tree["master"], n)
                        for n, p in params.items() if p.dtype != torch.float32}
    return st
