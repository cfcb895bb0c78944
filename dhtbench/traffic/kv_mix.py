"""Generator of the key-value mixes (YCSB core workloads A and B, the
paper's Fig. 6 read/update mixes): seed and parameters in, a pool out,
made on the device in set-up, from which every round of a run is drawn.

Records are numbered ``0 .. records - 1`` and all of them are written in
set-up.  A record's 20 key words are a fixed function of its id (word 0
is the id itself, so distinct records have distinct keys), and so is the
zipfian mix's scramble of ranks over records, as YCSB's keys and its
scrambled zipfian are fixed functions of the record number: every seed
fills the same table and has the same hot records, on the same shards
and in the same windows, and the seed draws the rounds.  A written
value's words are a function of the record, the row that wrote it, the
seed and a version (word 0): every round writes the next version, so a
stale read cannot pass.

Round ``i`` is drawn afresh from the seed and ``i`` alone (its own
generator state), over all the records, as YCSB's client draws each
request: no round repeats, so what a rare round does (an update of a
record that set-up evicted, whose reinsertion collides with another
writer and takes a second write pass) happens as rarely as it would,
and every seed sees the same mix.  The pool holds what the draws share:
every record's key words, the value words of each row, and for the
zipfian mix its distribution and scramble.  The reference draws the
same rounds from the same pool.

Parameters (``dhtbench/traffic/<cell>.json``):

- ``records``: records pre-written in set-up, in rounds of ``round_rows``;
- ``round_rows``: requests a round;
- ``read_frac``: share of reads; the rest are updates;
- ``dist``: ``"uniform"`` or ``"zipf"`` (``zipf_s``: the constant; ranks
  are scrambled over the records by a fixed permutation, as YCSB's
  scrambled zipfian does);
- ``warm_rounds``: rounds drawn and run in set-up, before the window;
- ``depth``: rounds in flight (issued before the oldest is committed);
- ``sample_every``: the window's rounds whose answers the reference
  checks are every ``sample_every``-th from an offset drawn from the
  seed, and the last.
"""
from __future__ import annotations

import dataclasses

import torch

MASK = 0xFFFFFFFF
CHUNK = 1 << 22
KEY_SEED = 0x2545F491        # the records' keys, the same for every seed
SCRAMBLE_SEED = 0x6A09E667   # the zipfian ranks' records, likewise


def _fmix(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 holding [0, 2^32) values."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK
    return h ^ (h >> 16)


def _i32(h: torch.Tensor) -> torch.Tensor:
    return (((h + 0x80000000) & MASK) - 0x80000000).to(torch.int32)


def _mixed(a: torch.Tensor, first: int, last: int, seed: int) -> torch.Tensor:
    """(n,) int64 in [0, 2^31) -> (n, last - first) int32: column j a
    fixed mix of a, j and the seed (the products stay under 2^63)."""
    j = torch.arange(first, last, dtype=torch.int64, device=a.device)
    return _i32(_fmix((a[:, None] * 0x5BD1E995 + j[None, :] * 0x27D4EB2F
                       + seed) & MASK))


def key_words(rid: torch.Tensor, kw: int, seed: int) -> torch.Tensor:
    """(n,) record ids -> (n, kw) int32 key words."""
    r = rid.to(torch.int64)
    return torch.cat([_i32(r)[:, None], _mixed(r, 1, kw, seed)], dim=1)


def row_words(n: int, vw: int, seed: int, device) -> torch.Tensor:
    """(n, vw) int32: the value words row ``r`` writes, words 0 and 1
    (version and record) left 0, word 2 the row, the rest mixed from it."""
    rows = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros(n, 2, dtype=torch.int32, device=device)
    return torch.cat([zero, _i32(rows)[:, None],
                      _mixed(rows, 3, vw, seed ^ 0x5F356495)], dim=1)


def zipf_cdf(universe: int, s: float, device) -> torch.Tensor:
    """Unnormalised CDF of Zipf(s) ranks over [0, universe), float64."""
    w = torch.arange(1, universe + 1, dtype=torch.float64,
                     device=device) ** -s
    return torch.cumsum(w, 0)


def zipf_ids(gen: torch.Generator, n: int, cdf: torch.Tensor) -> torch.Tensor:
    """(n,) int64 Zipf ranks, by inverse CDF over a seeded torch
    generator's uniforms (not ``numpy.random.zipf``, whose stream
    depends on numpy's version)."""
    u = torch.rand(n, generator=gen, dtype=torch.float64,
                   device=cdf.device) * cdf[-1]
    return torch.searchsorted(cdf, u).clamp(max=cdf.shape[0] - 1)


@dataclasses.dataclass
class Round:
    """One round: ``op`` 0 read / 1 update, the records it names, their
    key words, and the value lane (what the update rows write)."""

    rid: torch.Tensor      # (n,) int64
    op: torch.Tensor       # (n,) int32
    keys: torch.Tensor     # (n, KW) int32
    vals: torch.Tensor     # (n, VW) int32
    valid: torch.Tensor    # (n,) bool, all True


@dataclasses.dataclass
class Pool:
    seed: int
    key_words: int
    val_words: int
    records: int
    round_rows: int
    read_frac: float
    depth: int
    warm_rounds: int
    sample_every: int
    sample_offset: int
    keys: torch.Tensor          # (records, KW) int32, every record's key
    rows: torch.Tensor          # (round_rows, VW) int32, ``row_words``
    valid: torch.Tensor         # (round_rows,) bool, all True
    cdf: torch.Tensor | None    # zipf: the ranks' CDF
    scramble: torch.Tensor | None   # zipf: rank -> record
    gen: torch.Generator

    def record_keys(self, rid: torch.Tensor) -> torch.Tensor:
        return key_words(rid, self.key_words, KEY_SEED)

    def values(self, rid, row, ver) -> torch.Tensor:
        """The value words row ``row`` of a round of version ``ver``
        writes for record ``rid``."""
        v = self.rows[row.long()].clone()
        v[:, 0] = torch.as_tensor(ver, device=v.device).to(torch.int32)
        v[:, 1] = rid.to(torch.int32)
        return v

    def prewrite_chunks(self, device) -> list:
        """Record ids of each set-up write round, in order."""
        return [torch.arange(lo, min(lo + self.round_rows, self.records),
                             dtype=torch.int64, device=device)
                for lo in range(0, self.records, self.round_rows)]

    def draw(self, i: int) -> tuple:
        """Round ``i``'s records and ops, from the seed and ``i`` alone."""
        self.gen.manual_seed((self.seed * 0x9E3779B97F4A7C15 + i + 1)
                             & 0x7FFFFFFFFFFFFFFF)
        n = self.round_rows
        if self.cdf is None:
            rid = torch.randint(0, self.records, (n,), generator=self.gen,
                                device=self.keys.device)
        else:
            rid = self.scramble[zipf_ids(self.gen, n, self.cdf)]
        op = (torch.rand(n, generator=self.gen, device=self.keys.device)
              >= self.read_frac).to(torch.int32)
        return rid, op

    def round(self, i: int, ver: int) -> Round:
        """Round ``i`` as issued, writing version ``ver``."""
        rid, op = self.draw(i)
        vals = self.rows.clone()
        vals[:, 0] = ver
        vals[:, 1] = rid.to(torch.int32)
        return Round(rid=rid, op=op, keys=self.keys[rid], vals=vals,
                     valid=self.valid)


def make_pool(params: dict, config: dict, seed: int, device) -> Pool:
    kw, vw = config["dht"]["key_words"], config["dht"]["val_words"]
    n, records = int(params["round_rows"]), int(params["records"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    mseed = seed & MASK
    keys = torch.empty(records, kw, dtype=torch.int32, device=device)
    for lo in range(0, records, CHUNK):
        hi = min(lo + CHUNK, records)
        keys[lo:hi] = key_words(torch.arange(lo, hi, device=device), kw,
                                KEY_SEED)
    cdf = scramble = None
    if params["dist"] == "zipf":
        fixed = torch.Generator(device=device)
        fixed.manual_seed(SCRAMBLE_SEED)
        scramble = torch.randperm(records, generator=fixed, device=device)
        cdf = zipf_cdf(records, float(params["zipf_s"]), device)
    elif params["dist"] != "uniform":
        raise ValueError(f"unknown dist {params['dist']!r}")
    every = int(params["sample_every"])
    offset = int(torch.randint(0, every, (1,), generator=gen,
                               device=device).item())
    return Pool(seed=mseed, key_words=kw, val_words=vw, records=records,
                round_rows=n, read_frac=float(params["read_frac"]),
                depth=int(params["depth"]),
                warm_rounds=int(params["warm_rounds"]), sample_every=every,
                sample_offset=offset, keys=keys,
                rows=row_words(n, vw, mseed, device),
                valid=torch.ones(n, dtype=torch.bool, device=device),
                cdf=cdf, scramble=scramble,
                gen=torch.Generator(device=device))
