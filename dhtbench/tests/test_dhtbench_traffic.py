"""The traffic generators: the same seed gives the same pool and rounds,
another seed others; every round is drawn afresh; and the rounds have
the mix their file asks for."""
import pytest
import torch

import dhtbench_tiny as tiny
from dhtb import manifest


def _pool(name, seed, **traffic):
    spec = tiny.tiny_spec(name, **traffic)
    gen = manifest.load_module("traffic", spec["kind"])
    return gen.make_pool(spec["traffic"], spec["config"], seed, "cpu")


def _tensors(pool, rounds=3):
    out = [pool.keys, pool.rows]
    for i in range(rounds):
        r = pool.round(i, i + 1)
        out += [r.rid, r.op, r.keys, r.vals]
    return out


@pytest.mark.parametrize("name", tiny.CELLS)
def test_same_seed_same_pool(name):
    big = 2**31 + 12_345
    a, b, c = _pool(name, big), _pool(name, big), _pool(name, big + 1)
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))
    assert a.sample_offset == b.sample_offset
    assert torch.equal(a.keys, c.keys)      # the table, as in YCSB, is the seed's alone in order
    assert not all(torch.equal(x, y) for x, y in zip(_tensors(a),
                                                     _tensors(c)))


@pytest.mark.parametrize("name", tiny.CELLS)
def test_rounds_are_drawn_afresh_and_again_alike(name):
    """No two rounds of a run repeat, and round ``i`` drawn again (as
    the reference draws it) is the round the program was given."""
    pool = _pool(name, 2**31 + 99)
    draws = [pool.draw(i) for i in range(6)]
    assert all(not torch.equal(draws[i][0], draws[j][0])
               for i in range(6) for j in range(i))
    rid, op = pool.draw(3)
    assert torch.equal(rid, draws[3][0]) and torch.equal(op, draws[3][1])


@pytest.mark.parametrize("name,read_frac", [
    ("poet-kv.ycsb-b.uniform", 0.95), ("poet-kv.ycsb-a.zipf", 0.5)])
def test_kv_mix_shares_and_versions(name, read_frac):
    pool = _pool(name, 7, round_rows=1 << 14)
    op = torch.cat([pool.draw(i)[1] for i in range(4)]).float()
    assert abs(1 - op.mean().item() - read_frac) < 0.02
    r = pool.round(0, 5)
    assert torch.equal(r.keys[:, 0].long(), r.rid)      # distinct records, distinct keys
    assert torch.equal(r.keys, pool.record_keys(r.rid))
    w = r.op == 1
    assert torch.equal(r.vals[w], pool.values(r.rid[w], torch.nonzero(w)[:, 0], 5))
    assert (r.vals[:, 0] == 5).all()


def test_uniform_rounds_cover_every_record():
    pool = _pool("poet-kv.ycsb-b.uniform", 8, round_rows=1 << 14)
    seen = torch.cat([pool.draw(i)[0] for i in range(4)])
    assert seen.min() == 0 and seen.max() == pool.records - 1
    assert torch.unique(seen).numel() == pool.records


def test_zipf_is_skewed_and_uniform_is_not():
    z = _pool("poet-kv.ycsb-a.zipf", 7, round_rows=1 << 14)
    u = _pool("poet-kv.ycsb-b.uniform", 7, round_rows=1 << 14)
    top = lambda p: torch.bincount(p.draw(0)[0]).max().item()  # noqa: E731
    assert top(z) > 20 * top(u)
