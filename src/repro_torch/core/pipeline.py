"""Pipelining support for the issue/commit engine (PyTorch port of
``repro.core.pipeline``).

:class:`PendingWrites` is the read-after-promised-write hazard table.
Rounds that are *issued* are ordered by the card's stream: a read issued
after a write round was issued runs after it.  The one hazard left is a
write the driver has *promised* (it knows the keys) but not issued yet,
because its values are still being computed: a read issued in that
window would probe a table that does not hold them.  The table closes
the gap with store-to-load forwarding, like a CPU store buffer:
``promise`` registers the keys at miss time, ``conflicts`` masks matching
read rows out of the probe at issue time (no bin slot, no wire),
``publish`` attaches the computed values, ``resolve`` serves the masked
rows at commit time, and ``retire`` drops keys once their write round has
been issued.

The reference keeps the table in a host dict and loops over rows.  Here
it lives on the device of the keys it is given, and every call matches
rows exactly, all at once, through ``torch.unique(dim=0)``: equal rows
get equal ids.  The host waits for the sizes this needs (the match's,
a masked selection's): once in ``conflicts``, a few times in the
others.

:class:`RoundQueue` is a depth-D FIFO of in-flight rounds (depth 2 =
double buffering): ``push`` enqueues a handle and, once D rounds are in
flight, commits and returns the oldest, so commit order is issue order,
which the forwarding protocol needs.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["PendingWrites", "RoundQueue"]


def _words(x: Any, device=None) -> torch.Tensor:
    """uint32 numpy words or an int32 tensor -> 2-D int32 tensor."""
    if not torch.is_tensor(x):
        a = np.ascontiguousarray(np.asarray(x).astype(np.uint32, copy=False))
        x = torch.from_numpy(a.view(np.int32))
    x = x.to(device=device, dtype=torch.int32)
    return x[:, None] if x.dim() == 1 else x


def _flags(mask: Any, n: int, device) -> torch.Tensor:
    if mask is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    if not torch.is_tensor(mask):
        mask = torch.from_numpy(np.asarray(mask, dtype=bool))
    return mask.to(device=device, dtype=torch.bool)


class PendingWrites:
    """Store buffer for promised-but-unissued writes.

    Keys are ``(KW,)`` word rows and values ``(VW,)`` word rows, given as
    uint32 numpy arrays or int32 tensors; ``val_words`` fixes the width
    :meth:`resolve` returns.  The table holds each key once, with its
    value and whether it was published.
    """

    def __init__(self, val_words: int):
        self.val_words = int(val_words)
        self._keys: torch.Tensor | None = None   # (P, KW) distinct rows
        self._vals: torch.Tensor | None = None   # (P, val_words)
        self._pub: torch.Tensor | None = None    # (P,) published

    def __len__(self) -> int:
        return 0 if self._keys is None else self._keys.shape[0]

    def _rows(self, keys: Any) -> torch.Tensor:
        dev = None if self._keys is None else self._keys.device
        rows = _words(keys, dev)
        if self._keys is None:
            self._keys = rows.new_zeros((0, rows.shape[1]))
            self._vals = rows.new_zeros((0, self.val_words))
            self._pub = torch.zeros(0, dtype=torch.bool, device=rows.device)
        return rows

    def _ids(self, rows: torch.Tensor):
        """Shared ids of the table's rows and ``rows`` (equal rows, equal
        ids): ``(n_ids, table ids, row ids)``."""
        p = len(self)
        uniq, inv = torch.unique(torch.cat([self._keys, rows]), dim=0,
                                 return_inverse=True)
        return uniq.shape[0], inv[:p], inv[p:]

    def _marks(self, n_ids: int, ids: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(n_ids, dtype=torch.bool, device=ids.device)
        out[ids] = True
        return out

    def _append(self, keys, vals, pub: bool) -> None:
        self._keys = torch.cat([self._keys, keys])
        self._vals = torch.cat([self._vals, vals])
        self._pub = torch.cat([self._pub, torch.full(
            (keys.shape[0],), pub, dtype=torch.bool, device=keys.device)])

    def promise(self, keys: Any, mask: Any = None) -> None:
        """Register keys the driver WILL write (values not known yet)."""
        rows = self._rows(keys)
        rows = rows[_flags(mask, rows.shape[0], rows.device)]
        if rows.shape[0] == 0:
            return
        n_ids, tid, rid = self._ids(rows)
        fresh = self._marks(n_ids, rid) & ~self._marks(n_ids, tid)
        first = torch.full((n_ids,), rows.shape[0], dtype=torch.int64,
                           device=rows.device)
        first.scatter_reduce_(0, rid, torch.arange(
            rows.shape[0], device=rows.device), "amin")
        new = rows[first[fresh]]
        self._append(new, new.new_zeros((new.shape[0], self.val_words)),
                     False)

    def publish(self, keys: Any, vals: Any, mask: Any = None) -> None:
        """Attach computed values to promised keys (or add new ones):
        from here the keys are forwardable.  A key given twice takes its
        last value."""
        rows = self._rows(keys)
        v = _words(vals, rows.device).reshape(rows.shape[0], -1)
        if v.shape[1] < self.val_words:
            raise ValueError(f"values are {v.shape[1]} words wide, the "
                             f"table's {self.val_words}")
        m = _flags(mask, rows.shape[0], rows.device)
        rows, v = rows[m], v[m, :self.val_words]
        if rows.shape[0] == 0:
            return
        n_ids, tid, rid = self._ids(rows)
        last = torch.full((n_ids,), -1, dtype=torch.int64, device=rows.device)
        last.scatter_reduce_(0, rid, torch.arange(
            rows.shape[0], device=rows.device), "amax")
        at = last[tid]
        hit = at >= 0
        self._vals = torch.where(hit[:, None], v[at.clamp(min=0)], self._vals)
        self._pub = self._pub | hit
        new = last[(last >= 0) & ~self._marks(n_ids, tid)]
        self._append(rows[new], v[new], True)

    def retire(self, keys: Any, mask: Any = None) -> None:
        """Drop keys whose write round has been ISSUED: the stream orders
        any later read after it."""
        if len(self) == 0:
            return
        rows = self._rows(keys)
        rows = rows[_flags(mask, rows.shape[0], rows.device)]
        if rows.shape[0] == 0:
            return
        n_ids, tid, rid = self._ids(rows)
        keep = ~self._marks(n_ids, rid)[tid]
        self._keys, self._vals, self._pub = (
            self._keys[keep], self._vals[keep], self._pub[keep])

    def conflicts(self, keys: Any, valid: Any = None) -> torch.Tensor:
        """Bool mask of read rows whose key is currently pending: these
        must not probe the table (it is stale for them)."""
        rows = self._rows(keys)
        v = _flags(valid, rows.shape[0], rows.device)
        if len(self) == 0:
            return torch.zeros_like(v)
        n_ids, tid, rid = self._ids(rows)
        return self._marks(n_ids, tid)[rid] & v

    def resolve(self, keys: Any, mask: Any) -> torch.Tensor:
        """Forwarded values for the masked rows: ``(n, val_words)`` int32,
        zeros where the mask is off.  A masked key whose value was never
        published is a driver ordering bug and raises."""
        rows = self._rows(keys)
        m = _flags(mask, rows.shape[0], rows.device)
        out = rows.new_zeros((rows.shape[0], self.val_words))
        if len(self) == 0:
            ok = torch.zeros_like(m)
            at = torch.zeros(rows.shape[0], dtype=torch.int64,
                             device=rows.device)
        else:
            n_ids, tid, rid = self._ids(rows)
            pos = torch.full((n_ids,), -1, dtype=torch.int64,
                             device=rows.device)
            pos[tid] = torch.arange(len(self), device=rows.device)
            at = pos[rid]
            ok = (at >= 0) & self._pub[at.clamp(min=0)]
        if bool((m & ~ok).any()):
            raise RuntimeError(
                "PendingWrites.resolve: conflicted key was never "
                "published; commit ran before the producer published "
                "its value (driver ordering bug)")
        if len(self) == 0:
            return out
        return torch.where(m[:, None], self._vals[at.clamp(min=0)], out)


class RoundQueue:
    """Depth-D FIFO of in-flight rounds (depth 2 = double buffering).

    ``commit`` retires one handle (default: the engine's
    :func:`~repro_torch.core.op_engine.dht_commit`; wrappers pass their
    own commit half).  ``push(rnd)`` enqueues and, once D rounds are in
    flight, commits and returns the oldest (else ``None``); ``drain()``
    commits whatever is left, in issue order.
    """

    def __init__(self, depth: int = 2,
                 commit: Callable[[Any], Any] | None = None):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        if commit is None:
            from .op_engine import dht_commit as commit
        self.depth = int(depth)
        self.commit = commit
        self._q: deque[Any] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, rnd: Any) -> Any | None:
        """Enqueue an issued round; returns the committed result of the
        oldest round iff the queue was full (FIFO), else ``None``."""
        self._q.append(rnd)
        if len(self._q) > self.depth - 1:
            return self.commit(self._q.popleft())
        return None

    def drain(self) -> list[Any]:
        """Commit every still-in-flight round, in issue order."""
        out = []
        while self._q:
            out.append(self.commit(self._q.popleft()))
        return out
