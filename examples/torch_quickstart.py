"""Quickstart on the PyTorch port (twin of ``examples/quickstart.py``):
the paper's 4-call DHT API, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    DHTConfig,
    dht_create,
    dht_free,
    dht_read,
    dht_write,
    occupancy,
)


def main(verbose: bool = True, device: str | None = None):
    # 80-byte keys / 104-byte values — the POET sizes the paper benchmarks
    cfg = DHTConfig(key_words=20, val_words=26,
                    n_shards=8, buckets_per_shard=4096, mode="lockfree")
    table = dht_create(cfg, device=device)

    rng = np.random.default_rng(0)
    n = 1000
    # uint32 words go in as their int32 bit-views
    keys = torch.from_numpy(rng.integers(0, 2**31, size=(n, 20)).astype(
        np.uint32).view(np.int32)).to(table.device)
    vals = torch.from_numpy(rng.integers(0, 2**31, size=(n, 26)).astype(
        np.uint32).view(np.int32)).to(table.device)

    table, wstats = dht_write(table, keys, vals)
    table, out, found, rstats = dht_read(table, keys)

    stats = {
        "n_items": n,
        "inserted": int(wstats["inserted"]),
        "read_hits": int(rstats["hits"]),
        "values_match": bool((out == vals).all()),
        "occupancy": float(occupancy(table).mean()),
    }
    if verbose:
        for k, v in stats.items():
            print(f"{k:14s} {v}")
    dht_free(table)
    return stats


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(device=ap.parse_args().device)
