"""Plain reference of the ``kv_mix`` cells: the answers a lock-free DHT of
the configuration's geometry owes each checked round, worked out from
the benchmark's own inputs (the records' key words and the values each
write carried) by ``reference/table.py``'s model, with nothing taken
from the program.

The reference replays the whole log of rounds the program's table saw,
set-up writes and warm-up included, in order, each round drawn again
from the traffic's pool by its index.  For every round the
window kept it compares each row with what it owes:

- a read: ``found`` where the record sits in its window at the round's
  start, and then the value words of the write that put it there (the
  version, the record, the writing row and the words mixed from them);
- an update: its result code (update, insert or evict), no value and
  ``found`` false.

``control=True`` answers the kept rounds' reads from the table as it
stood one round earlier, as a store that acknowledges writes before
they are visible would: the guarantee that a read sees every write
acknowledged before its round, broken.
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from table import Table  # noqa: E402

# Limits of the numbers compared.  Both are exact comparisons: the
# program owes every row's words, flags and codes bit for bit.
LIMITS = {"wrong_reads": 0, "wrong_writes": 0}


def _src(ver: int, rows: torch.Tensor) -> torch.Tensor:
    return (int(ver) << 32) | rows


def _snapshot(tab: Table) -> Table:
    snap = copy.copy(tab)
    snap.rid, snap.src = tab.rid.clone(), tab.src.clone()
    return snap


def _reads(tab: Table, pool, rid, start, is_w):
    """What the round's rows owe as reads of ``tab``: ``(found, vals)``,
    false and zeros on the update rows."""
    found, slot = tab.find_rid(start, rid)
    found = found & ~is_w
    src = tab.src[slot]
    vals = pool.values(rid, src & 0xFFFFFFFF, src >> 32)
    return found, torch.where(found[:, None], vals, 0)


def check(config: dict, pool, log: list, kept: dict, *, control=False) -> dict:
    """Replay ``log`` and compare the kept rounds' answers ``kept[i] =
    (vals, found, code)``.  Returns the numbers compared."""
    d = config["dht"]
    dev = pool.keys.device
    tab = Table(d["n_shards"], d["buckets_per_shard"], d["n_probe"], dev)
    chunks = pool.prewrite_chunks(dev)
    starts = torch.cat([tab.window_start(pool.record_keys(c)) for c in chunks])
    checked = {k for k, e in enumerate(log) if e[0] == "round" and e[3] in kept}
    wrong_reads = wrong_writes = rows = 0
    stale = tab
    for k, entry in enumerate(log[:max(checked, default=-1) + 1]):
        if entry[0] == "prewrite":
            rid = chunks[entry[1]]
            tab.write(starts[rid], rid,
                      _src(0, torch.arange(rid.shape[0], device=dev)))
            continue
        _, i, ver, widx = entry
        rid, op = pool.draw(i)
        start = starts[rid]
        is_w = op == 1
        w_rows = torch.nonzero(is_w)[:, 0]
        if k in checked:
            found, vals = _reads(tab, pool, rid, start, is_w)
            if control:
                got_found, got_vals = _reads(stale, pool, rid, start, is_w)
        if control and k + 1 in checked:
            stale = _snapshot(tab)
        code_w = tab.write(start[w_rows], rid[w_rows], _src(ver, w_rows))
        if k not in checked:
            continue
        code = torch.zeros_like(op)
        code[w_rows] = code_w
        if control:
            got_code = code
        else:
            got_vals, got_found, got_code = kept[widx]
        bad = ((got_found.to(torch.bool) != found)
               | (got_vals.to(torch.int32) != vals).any(dim=1)
               | (got_code.to(torch.int32) != code))
        wrong_reads += int((bad & ~is_w).sum())
        wrong_writes += int((bad & is_w).sum())
        rows += int(op.shape[0])
    return {"wrong_reads": wrong_reads, "wrong_writes": wrong_writes,
            "rows_checked": rows, "rounds_checked": len(checked)}
