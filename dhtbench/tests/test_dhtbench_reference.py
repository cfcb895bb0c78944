"""The plain reference against the program at a tiny size on the CPU:
for each cell, at the cells' load and at a load high enough
that windows fill, evict and writers of one round collide."""
import pytest
import torch

import dhtbench_tiny as tiny
from dhtb import manifest

table = manifest.load_module("reference", "table")


def test_reference_hash_is_the_programs_key_hash():
    from repro_torch.core.hashing import hash64

    g = torch.Generator().manual_seed(5)
    keys = torch.randint(-2**31, 2**31, (257, 20), generator=g,
                         dtype=torch.int64).to(torch.int32)
    hi, lo = hash64(keys)
    assert torch.equal(table.murmur3(keys, table.SEED_HI), hi.long() & 0xFFFFFFFF)
    assert torch.equal(table.murmur3(keys, table.SEED_LO), lo.long() & 0xFFFFFFFF)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_program_matches_reference(name):
    result, checks = tiny.run_tiny(tiny.tiny_spec(name))
    assert result["correct"], checks
    assert checks["rounds_checked"]["value"] >= 1, checks


@pytest.mark.parametrize("name,traffic", [
    ("poet-kv.ycsb-a.zipf", dict(records=7000, round_rows=1024,
                                 sample_every=1)),
    ("poet-kv.ycsb-b.uniform", dict(records=7600, round_rows=1024,
                                    read_frac=0.2, sample_every=1)),
])
def test_program_matches_reference_when_windows_fill(name, traffic):
    """At 85-93% load set-up evicts many records, and the rounds, over
    every record, update evicted ones: they insert again and evict
    others, and writers of one round collide."""
    result, checks = tiny.run_tiny(tiny.tiny_spec(name, **traffic),
                                   seconds=0.3)
    assert result["correct"], checks


def test_rounds_reach_records_set_up_evicted():
    """At a load where windows fill, the program's table holds fewer
    records than set-up wrote, and the rounds still name the others."""
    spec = tiny.tiny_spec("poet-kv.ycsb-b.uniform", records=7000,
                          round_rows=1024)
    kv = manifest.load_module("traffic", "kv_mix")
    drv = manifest.load_module("clients", "kv_mix")
    pool = kv.make_pool(spec["traffic"], spec["config"], 17, "cpu")
    client = drv.Client(spec["config"], pool, "cpu")
    client.fill()
    live = (client.state.flat_meta[:-1] & 1) != 0
    held = set(client.state.flat_keys[:-1][live][:, 0].tolist())
    assert len(held) < 7000
    rids = set(torch.cat([pool.draw(i)[0] for i in range(4)]).tolist())
    assert rids - held


def test_reference_table_evicts_and_resolves_collisions():
    """At 7/8 load the model evicts, and rows of one round that pick one
    bucket are settled over more than one pass."""
    t = table.Table(1, 64, 6, "cpu")
    start = torch.randint(0, 59, (56,), generator=torch.Generator()
                          .manual_seed(1))
    rid = torch.arange(56)
    code = t.write(start, rid, rid)
    assert (code == table.INSERT).sum() > 0
    assert (code == table.EVICT).sum() > 0
    assert int((t.rid >= 0).sum()) <= 56
    found, _ = t.find_rid(start, rid)
    assert found[code == table.INSERT].float().mean() > 0.5
