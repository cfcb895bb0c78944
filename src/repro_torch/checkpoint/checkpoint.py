"""Fault-tolerant checkpointing with elastic restart: the port of
``repro/checkpoint/checkpoint.py``, in its on-disk format word for word.

    <dir>/step_<N>/manifest.json   {"step", "leaves": {path: {part, shape, dtype}}}
    <dir>/step_<N>/part_<k>.npz    leaf payloads, a new part after 512 MB
    <dir>/LATEST                   the committed step (atomic replace)

Write protocol: stage into ``step_<N>.tmp``, rename it to ``step_<N>``,
then replace ``LATEST``: a crash at any point leaves the previous or the
new checkpoint whole, never a torn one.

Trees are nested ``dict``/``list``/``tuple`` of tensors (a
``state_dict()`` is a flat dict); numpy arrays and scalars are leaves
too, and ``None`` is an empty subtree.  Leaf paths are built as the
reference's ``jax.tree_util`` builds them (dict keys in sorted order,
sequence items by index, joined with ``/``), so a tree gives the same
``manifest.json`` in both packages and either reads the other's
checkpoint.  bfloat16 is stored as its uint16 bits with the logical
dtype ``"bfloat16"``.

``rehash_dht`` re-inserts the live entries of a table into one of
another shape: the paper's "resize the table on restart" future-work
item.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Mapping

import numpy as np
import torch

from ..core import DHTConfig, DHTState, dht_create, dht_write
from ..core.layout import INVALID, OCCUPIED, resolve_device

_PART_BYTES = 512 << 20
REHASH_BATCH = 8192   # rows a re-insert round (the reference's)


def _flatten(tree, prefix: tuple = ()) -> list[tuple[str, object]]:
    """``[(path, leaf)]`` in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        done = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return type(tree)((k, done[k]) for k in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf's payload and its logical dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        return arr.view(np.uint16), "bfloat16"  # an ml_dtypes array
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest, part, part_idx, part_bytes = {}, {}, 0, 0
    for p, leaf in _flatten(tree):
        arr, logical_dtype = _to_numpy(leaf)
        manifest[p] = {"part": part_idx, "shape": list(arr.shape),
                       "dtype": logical_dtype}
        part[p.replace("/", "__")] = arr
        part_bytes += arr.nbytes
        if part_bytes >= _PART_BYTES:
            np.savez(os.path.join(tmp, f"part_{part_idx}.npz"), **part)
            part, part_idx, part_bytes = {}, part_idx + 1, 0
    if part:
        np.savez(os.path.join(tmp, f"part_{part_idx}.npz"), **part)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # commit point 1: the payload
    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))  # commit point 2
    return final


def latest_step(directory: str) -> int | None:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore(directory: str, target_tree, step: int | None = None, *,
            device=None):
    """Restore into the *structure* of ``target_tree`` (its leaves are
    replaced by tensors of the stored dtypes, on the card unless
    ``device`` names another).  Returns ``(step, tree)``."""
    dev = resolve_device(device)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    parts: dict[int, np.lib.npyio.NpzFile] = {}
    new_leaves = []
    try:
        for p, _leaf in _flatten(target_tree):
            meta = manifest["leaves"][p]
            k = meta["part"]
            if k not in parts:
                parts[k] = np.load(os.path.join(d, f"part_{k}.npz"))
            arr = parts[k][p.replace("/", "__")]
            if list(arr.shape) != meta["shape"]:
                raise ValueError(f"{p}: stored shape {list(arr.shape)} is "
                                 f"not the manifest's {meta['shape']}")
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            new_leaves.append(t.to(dev))
    finally:
        for npz in parts.values():
            npz.close()
    return step, _rebuild(target_tree, iter(new_leaves))


# ---------------------------------------------------------------------------
# elastic DHT resize (the paper's §6 future work: "resizing could be
# managed during HPC application checkpointing, adjusting the table size
# on restart")
# ---------------------------------------------------------------------------

def rehash_dht(state: DHTState, new_cfg: DHTConfig) -> DHTState:
    """Re-insert every live entry of ``state`` into a fresh table of
    ``new_cfg`` on the same device: the live mask is computed there, the
    live rows are gathered once in flat-row order (the reference's
    C-order over ``(S, B)``) and written in rounds of ``REHASH_BATCH``."""
    old = state.cfg
    if (new_cfg.key_words, new_cfg.val_words) != (old.key_words, old.val_words):
        raise ValueError(
            f"rehash keeps the row widths: ({old.key_words}, "
            f"{old.val_words}) words, not ({new_cfg.key_words}, "
            f"{new_cfg.val_words})")
    meta = state.flat_meta[:-1]
    live = ((meta & OCCUPIED) != 0) & ((meta & INVALID) == 0)
    rows = torch.nonzero(live).squeeze(1)
    keys = state.flat_keys[rows]
    vals = state.flat_vals[rows]
    new_state = dht_create(new_cfg, device=state.device)
    for i in range(0, keys.shape[0], REHASH_BATCH):
        new_state, _ = dht_write(new_state, keys[i:i + REHASH_BATCH],
                                 vals[i:i + REHASH_BATCH])
    return new_state
