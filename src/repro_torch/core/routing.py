"""Capacity-binned routing (PyTorch port of ``repro.core.routing``).

A round bins its requests by destination shard into fixed-capacity send
bins, moves every payload through ONE fused (n, L) int32 lane matrix, and
returns the replies the same way:

- sort-based binning (:func:`bin_by_dest`): the within-bin position comes
  from one sort of a packed int64 key (group << index_bits | index), the
  same order as the reference's packed uint32 key, with
  :func:`bin_by_dest_onehot` kept as the parity oracle;
- count-driven capacity (:func:`plan_capacity`): the per-destination
  histogram's max, rounded up the power-of-two lattice.  It reads one
  number back to the host per round;
- fused pack/unpack: ``dispatch``/``collect`` run the route kernels
  (``kernels/ops.route_pack``/``route_unpack``; plain torch on the CPU);
- multi-key fan-out (:func:`flatten_fanout`): the m probes per query of
  a neighbourhood read, or the two epochs of a dual-epoch read
  (:func:`merge_dual_epoch` combines their replies), go out as one flat
  batch.

Two backends.  With ``axis_name=None`` the S shards are virtual and the
exchange is a reshape.  With ``axis_name`` a ``torch.distributed``
process group of S ranks, one shard each, every leg is ONE
``all_to_all_single`` of the (S * capacity, L) int32 lane matrix in
equal splits; the incoming rows are source-major.  Overflow beyond
capacity is dropped and reported, exactly as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..kernels import ops as kops
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .layout import MASK32


@dataclasses.dataclass
class Binned:
    """A request batch binned by destination."""

    pos: torch.Tensor        # (n,) int32 position within the dest bin
    kept: torch.Tensor       # (n,) bool, False = overflowed or invalid
    dest: torch.Tensor       # (n,) int32 destination shard
    capacity: int
    n_dest: int
    n_dropped: torch.Tensor  # () int32
    epoch: int = 0           # membership epoch (0: static modulo placement)


def process_group(axis_name, device: torch.device | None = None):
    """``axis_name`` as a ``torch.distributed`` process group (None stays
    None).  Anything else raises ``TypeError``; a group whose backend
    cannot move tensors of ``device`` raises ``ValueError`` (NCCL takes
    CUDA tensors, gloo CPU ones here), so nothing is copied through the
    host on the quiet."""
    if axis_name is None:
        return None
    import torch.distributed as dist

    if not isinstance(axis_name, dist.ProcessGroup):
        raise TypeError(
            "axis_name must be a torch.distributed ProcessGroup of the "
            f"multi-rank backend, got {type(axis_name).__name__}")
    if device is not None:
        backend = str(dist.get_backend(axis_name))
        if (backend == "nccl") != (device.type == "cuda"):
            raise ValueError(
                f"a {backend} group cannot exchange {device.type} tensors: "
                "use NCCL for CUDA tensors and gloo for CPU ones")
    return axis_name


def stable_rank_by_group(group: torch.Tensor, valid=None,
                         n_groups: int | None = None) -> torch.Tensor:
    """Rank of each item among items of the same group, stable in item
    order, from one sort.  Invalid items sort to a sentinel group and
    report rank 0.  With ``n_groups`` (ids in [0, n_groups)) group and
    item index pack into one int64 key; otherwise a stable argsort."""
    n = group.shape[0]
    dev = group.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    ibits = max(n - 1, 1).bit_length()
    g = group.to(torch.int64)
    if n_groups and int(n_groups).bit_length() + ibits <= 62:
        if valid is not None:
            g = torch.where(valid, g, int(n_groups))     # sentinel group
        ks = torch.sort((g << ibits) | iota).values
        order = ks & ((1 << ibits) - 1)
        gs = ks >> ibits
    else:
        if valid is not None:
            g = torch.where(valid, g, 2**30)
        order = torch.argsort(g, stable=True)
        gs = g[order]
    new_run = torch.ones(n, dtype=torch.bool, device=dev)
    new_run[1:] = gs[1:] != gs[:-1]
    run_start = torch.cummax(torch.where(new_run, iota, 0), dim=0).values
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = iota - run_start
    if valid is not None:
        rank = torch.where(valid, rank, 0)
    return rank.to(torch.int32)


def _binned(pos, dest, n_dest, capacity, epoch, valid) -> Binned:
    in_cap = pos < capacity
    kept = in_cap if valid is None else valid & in_cap
    dropped = ~kept if valid is None else valid & ~in_cap
    return Binned(pos=pos, kept=kept, dest=dest.to(torch.int32),
                  capacity=capacity, n_dest=n_dest,
                  n_dropped=dropped.sum().to(torch.int32),
                  epoch=0 if epoch is None else int(epoch))


def bin_by_dest(dest: torch.Tensor, n_dest: int, capacity: int, epoch=None,
                valid=None) -> Binned:
    """Within-bin positions in stable item order.  ``valid`` False items
    take no bin slot and come back ``kept=False`` (not counted dropped)."""
    pos = stable_rank_by_group(dest, valid, n_groups=n_dest)
    return _binned(pos, dest, n_dest, capacity, epoch, valid)


def bin_by_dest_onehot(dest: torch.Tensor, n_dest: int, capacity: int,
                       epoch=None, valid=None) -> Binned:
    """O(n x n_dest) one-hot/cumsum binning: the parity oracle."""
    onehot = dest[:, None] == torch.arange(n_dest, dtype=dest.dtype,
                                           device=dest.device)[None, :]
    if valid is not None:
        onehot = onehot & valid[:, None]
    oh = onehot.to(torch.int32)
    pos = ((torch.cumsum(oh, dim=0) - 1) * oh).sum(dim=1).to(torch.int32)
    return _binned(pos, dest, n_dest, capacity, epoch, valid)


def _histogram(idx: torch.Tensor, size: int) -> torch.Tensor:
    """(size,) int64 counts of ``idx`` values in [0, size): ``bincount``
    without its host reads of the index range (two syncs on the card)."""
    out = torch.zeros(size, dtype=torch.int64, device=idx.device)
    return out.scatter_add_(0, idx, torch.ones_like(idx))


def bin_counts(b: Binned) -> torch.Tensor:
    """Per-destination count of kept items, (n_dest,) int32."""
    idx = torch.where(b.kept, b.dest, b.n_dest).to(torch.int64)
    return _histogram(idx, b.n_dest + 1)[:b.n_dest].to(torch.int32)


# ---------------------------------------------------------------------------
# count-driven capacity
# ---------------------------------------------------------------------------

def capacity_bucket(max_load: int, floor: int = 16,
                    limit: int | None = None) -> int:
    """Round a max bin load up the power-of-two lattice."""
    c = max(int(max_load), 1)
    b = max(floor, 1 << (c - 1).bit_length())
    if limit is not None:
        b = min(b, max(int(limit), 1))
    return b


def plan_capacity(dest: torch.Tensor, n_dest: int, *, n_src: int = 1,
                  floor: int = 16, valid=None, group=None) -> int:
    """Count-exchange prologue: per-destination histogram -> max bin load
    -> power-of-two capacity.  ``dest`` viewed as ``n_src`` rows, one per
    source; ``valid`` False items are left out.  With a process
    ``group`` each rank brings its own rows: the largest bin of every
    rank and its batch length meet in one ``all_reduce(MAX)``, the max
    over all (source, destination) pairs that the reference's count
    exchange agrees on.  Reads one pair of integers back to the host."""
    d = dest.reshape(n_src, -1).to(torch.int64)
    if valid is not None:
        d = torch.where(valid.reshape(n_src, -1), d, n_dest)
    width = n_dest + 1
    off = torch.arange(n_src, dtype=torch.int64, device=d.device)[:, None]
    counts = _histogram((d + off * width).reshape(-1),
                        n_src * width).reshape(n_src, width)
    if group is None:
        max_load = (obs_trace.host_read("capacity", int,
                                        counts[:, :n_dest].max())
                    if d.numel() else 0)
        limit = d.shape[1]
    else:
        import torch.distributed as dist

        agreed = torch.stack([counts[:, :n_dest].max(),
                              torch.full((), d.shape[1], dtype=torch.int64,
                                         device=d.device)])
        dist.all_reduce(agreed, op=dist.ReduceOp.MAX, group=group)
        max_load, limit = obs_trace.host_read(
            "capacity", torch.Tensor.tolist, agreed)
    return capacity_bucket(max(max_load, 1), floor=floor, limit=limit)


def auto_capacity(n_local: int, n_dest: int, factor: float = 4.0,
                  floor: int = 16) -> int:
    """Static heuristic: expected n/S load x safety factor."""
    c = int(math.ceil(n_local / max(n_dest, 1) * factor))
    return min(max(c, floor), max(n_local, 1))


# ---------------------------------------------------------------------------
# fused multi-lane pack/unpack
# ---------------------------------------------------------------------------

def _to_lanes(p: torch.Tensor) -> torch.Tensor:
    """(n, *tail) payload -> (n, w) int32 lane view (bit-exact)."""
    q = p.reshape(p.shape[0], math.prod(p.shape[1:]))   # 0 rows too
    if q.dtype == torch.bool:
        return q.to(torch.int32)
    if q.element_size() != 4:
        raise TypeError(f"need 4-byte or bool lanes, got {q.dtype}")
    return q.contiguous().view(torch.int32)


def _from_lanes(lanes: torch.Tensor, dtype, tail: tuple) -> torch.Tensor:
    out = lanes != 0 if dtype == torch.bool else lanes.view(dtype)
    return out.reshape((lanes.shape[0],) + tuple(tail))


def _fill_word(fill, dtype) -> int:
    """One payload's fill value as a signed int32 lane word, cast through
    the payload dtype first (the one definition shared by both legs)."""
    if dtype == torch.bool:
        return int(bool(fill))
    if dtype.is_floating_point:
        return int(torch.tensor(fill, dtype=dtype).view(torch.int32))
    v = int(fill) & MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


def _pad_fills(fills, n: int) -> list:
    fills = list(fills) if fills is not None else []
    return fills + [0] * (n - len(fills))


def _encode(payloads: Sequence[torch.Tensor], tail_from: int, fills):
    """Bit-pack payloads into one (rows, L) int32 matrix + lane specs +
    the (L,) fill row.  ``tail_from`` is where the per-item tail starts
    (1 for flat (n, *tail) payloads, 2 for (n_dest, cap, *tail))."""
    mats, specs, fill_parts = [], [], []
    for p, fill in zip(payloads, _pad_fills(fills, len(payloads))):
        tail = tuple(p.shape[tail_from:])
        lanes = _to_lanes(p.reshape((-1,) + tail))
        mats.append(lanes)
        specs.append((p.dtype, tail, lanes.shape[1]))
        fill_parts.append(torch.full((lanes.shape[1],),
                                     _fill_word(fill, p.dtype),
                                     dtype=torch.int32, device=p.device))
    return torch.cat(mats, dim=1), specs, torch.cat(fill_parts)


def _decode(mat: torch.Tensor, specs) -> list[torch.Tensor]:
    out, off = [], 0
    for dtype, tail, w in specs:
        out.append(_from_lanes(mat[:, off:off + w], dtype, tail))
        off += w
    return out


def lane_width(payloads: Sequence[torch.Tensor]) -> int:
    """Total int32 lanes a payload list occupies on the wire."""
    return sum(math.prod(p.shape[1:]) or 1 for p in payloads)


def _slots(b: Binned) -> tuple[torch.Tensor, int]:
    """Per-item send-buffer row; dropped items get the out-of-range row
    ``rows`` (the dump row of the inverse-permutation scatter)."""
    rows = b.n_dest * b.capacity
    slot = b.dest * b.capacity + torch.clamp(b.pos, max=b.capacity - 1)
    return torch.where(b.kept, slot, rows), rows


def _scatter_to_bins(b: Binned, mat: torch.Tensor,
                     fill_row: torch.Tensor) -> torch.Tensor:
    """(n, L) lane matrix -> (n_dest * capacity, L) send buffer: a scatter
    of one int32 per item into the inverse permutation, then the pack
    kernel's row gather."""
    n = mat.shape[0]
    slot, rows = _slots(b)
    inv = torch.full((rows + 1,), -1, dtype=torch.int32, device=mat.device)
    inv.scatter_(0, slot.to(torch.int64),
                 torch.arange(n, dtype=torch.int32, device=mat.device))
    return kops.route_pack(mat, inv[:rows], fill_row)


def _gather_from_bins(b: Binned, buf: torch.Tensor,
                      fill_row: torch.Tensor) -> torch.Tensor:
    """(n_dest * capacity, L) -> (n, L) in original item order."""
    slot, rows = _slots(b)
    slot = torch.clamp(slot, max=rows - 1).to(torch.int32)
    return kops.route_unpack(buf, slot, b.kept.to(torch.int32), fill_row)


def _exchange(buf: torch.Tensor, group) -> torch.Tensor:
    """One ``all_to_all_single`` of a (S * capacity, L) buffer in equal
    splits: block d goes to rank d, and block s of the result came from
    rank s."""
    import torch.distributed as dist

    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out


def dispatch(b: Binned, payloads: Sequence[torch.Tensor], axis_name=None,
             fills: Sequence = ()) -> list[torch.Tensor]:
    """Send payloads to their destination shards through one fused lane
    matrix.  Returns each payload as an (n_dest, capacity, *tail) buffer
    (the virtual shards' incoming bins), or, with a process group, this
    rank's incoming (n_src * capacity, *tail) rows, source-major; empty
    slots hold ``fills``."""
    group = process_group(axis_name)
    obs_metrics.inc("routing.dispatches")
    mat, specs, fill_row = _encode(payloads, 1, fills)
    buf = _scatter_to_bins(b, mat, fill_row)
    if group is not None:
        return _decode(_exchange(buf, group), specs)
    return [p.reshape((b.n_dest, b.capacity) + tuple(p.shape[1:]))
            for p in _decode(buf, specs)]


def collect(b: Binned, replies: Sequence[torch.Tensor], axis_name=None,
            fills: Sequence = (0,), block_rows: bool = False):
    """Inverse of :func:`dispatch`: replies shaped (n_dest, capacity,
    *tail), or with a process group this rank's (n_src * capacity,
    *tail) rows, return to item order; overflowed items get ``fills``.

    ``block_rows=True`` also returns, per reply, row 0 of each shard's
    block of the reply buffer, an (n_dest, *tail) tensor: a handler that
    writes a shard-wide word (its slab watermark) into every row of its
    block, padding included, hands it to every caller this way with no
    extra exchange (the L1 coherence piggyback).  Returns ``(items,
    blocks)`` then."""
    group = process_group(axis_name)
    obs_metrics.inc("routing.collects")
    mat, specs, fill_row = _encode(replies, 2 if group is None else 1,
                                   fills)
    if group is not None:
        mat = _exchange(mat, group)
    items = _decode(_gather_from_bins(b, mat, fill_row), specs)
    if not block_rows:
        return items
    return items, _decode(mat[::b.capacity], specs)


def flatten_fanout(keys: torch.Tensor, valid: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(n, m, ...) per-query fan-out (e.g. stencil keys) -> one flat batch
    of n*m items, so the m probes of every query ride ONE routing round."""
    n, m = keys.shape[0], keys.shape[1]
    flat = keys.reshape((n * m,) + tuple(keys.shape[2:]))
    vflat = None if valid is None else valid.reshape(n * m)
    return flat, vflat


def unflatten_fanout(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Inverse of :func:`flatten_fanout` for replies: (n*m, ...) ->
    (n, m, ...)."""
    return x.reshape((n, m) + tuple(x.shape[1:]))


def merge_dual_epoch(found_new: torch.Tensor, vals_new: torch.Tensor,
                     found_old: torch.Tensor, vals_old: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine the replies of a dual-epoch read: the new epoch's owner is
    authoritative (it sees writes made during the migration), the old
    epoch's owner backfills entries still in flight.  Returns ``(vals,
    found)``."""
    found = found_new | found_old
    vals = torch.where(found_new[:, None], vals_new, vals_old)
    return torch.where(found[:, None], vals, 0), found


def wire_stats(b: Binned, send_lanes: int, reply_lanes: int, *,
               prologue_words: int = 0, n_self_rows: int = 0) -> dict:
    """Per-round wire accounting: buffer words on both legs (plus the
    count-exchange histogram words) and the padding fraction of the
    buffer rows.  ``n_self_rows`` leaves out buffer rows that never cross
    the fabric: with self-traffic elision the local shard's block holds
    only padding, so both legs drop ``capacity`` rows."""
    rows = b.n_dest * b.capacity - n_self_rows
    kept = b.kept.sum().to(torch.float32)
    denom = torch.full((), float(max(rows, 1)), dtype=torch.float32,
                       device=kept.device)
    return {
        "wire_words": rows * (send_lanes + reply_lanes) + prologue_words,
        "wire_send_words": rows * send_lanes + prologue_words,
        "wire_reply_words": rows * reply_lanes,
        "fill_frac": 1.0 - kept / denom,
    }
