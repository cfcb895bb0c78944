"""Drives the program's key-value rounds for the ``kv_mix`` traffic: a
``dht_create`` table pre-written with ``dht_write`` in set-up, then
mixed read/update rounds through ``dht_issue``/``dht_commit`` on the
single-device virtual-shard backend, ``depth`` rounds in flight."""
from __future__ import annotations

import torch


def dht_config(config: dict):
    from repro_torch.core import DHTConfig

    d = config["dht"]
    return DHTConfig(key_words=d["key_words"], val_words=d["val_words"],
                     n_shards=d["n_shards"],
                     buckets_per_shard=d["buckets_per_shard"],
                     n_probe=d["n_probe"], mode=d["mode"])


class Client:
    """``log`` records every round the table saw, in order, for the
    reference: ``("prewrite", chunk)`` and ``("round", round index,
    version, window index or None)``."""

    def __init__(self, config: dict, pool, device):
        from repro_torch.core import dht_create

        self.pool, self.device = pool, torch.device(device)
        self.state = dht_create(dht_config(config), device=self.device)
        self.depth = pool.depth
        self.log = []
        self.drawn = 0      # rounds drawn so far: each run draws anew

    def fill(self) -> None:
        from repro_torch.core import dht_write

        for i, rid in enumerate(self.pool.prewrite_chunks(self.device)):
            rows = torch.arange(rid.shape[0], device=self.device)
            dht_write(self.state, self.pool.record_keys(rid),
                      self.pool.values(rid, rows, 0))
            self.log.append(("prewrite", i))
        self.sync()

    def issue(self, i: int, window_idx):
        from repro_torch.core import dht_issue, mixed_ops

        ver = len(self.log) + 1
        rd = self.pool.round(self.drawn, ver)
        self.log.append(("round", self.drawn, ver, window_idx))
        self.drawn += 1
        return dht_issue(self.state, mixed_ops(rd.op, rd.keys, rd.vals,
                                               rd.valid),
                         kinds=("read", "write"))

    def commit(self, rnd):
        from repro_torch.core import dht_commit

        _, _, vals, found, code, es = dht_commit(rnd)
        return (vals, found, code), {"issue_us": rnd.telemetry["issue_us"],
                                     "write_passes": es["rounds"]}

    def ops(self, i: int) -> int:
        return self.pool.round_rows

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self) -> None:
        from repro_torch.core import dht_free

        dht_free(self.state)
