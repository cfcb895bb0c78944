"""Card-only tests of the port: every CUDA kernel against its plain
version, the engine on the card against the engine on the CPU, and the
launch counts.  Marked ``cuda``; each skips where there is no NVIDIA GPU
(decided inside the fixture, never at import).  Run them on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import state_to_numpy
from repro_torch.core import (
    DHTConfig,
    dht_create,
    dht_execute,
    dht_read,
    dht_write,
    migrate_ops,
    mixed_ops,
)
from repro_torch.kernels import (
    apply_kernel,
    hash_kernel,
    ops,
    ref,
    route_kernel,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator().manual_seed(0)


def _words(gen, n, w, device="cuda"):
    x = torch.randint(-2**31, 2**31, (n, w), generator=gen, dtype=torch.int64)
    return x.to(torch.int32).to(device)


@pytest.mark.parametrize("n,kw", [(1, 20), (7, 4), (300, 33), (65536, 20)])
def test_hash64_kernel_matches_plain(gen, n, kw):
    keys = _words(gen, n, kw)
    assert torch.equal(hash_kernel.hash64(keys), ref.hash64(keys))


@pytest.mark.parametrize("n,rows,width", [(1, 16, 1), (80, 64, 22),
                                          (65536, 131072, 48)])
def test_route_kernels_match_plain(gen, n, rows, width):
    mat = _words(gen, n, width)
    inv = torch.randint(-1, n, (rows,), generator=gen).to(torch.int32).cuda()
    fill = _words(gen, 1, width)[0]
    assert torch.equal(route_kernel.route_pack(mat, inv, fill),
                       ref.route_pack(mat, inv, fill))
    buf = _words(gen, rows, width)
    slot = torch.randint(0, rows, (n,), generator=gen).to(torch.int32).cuda()
    kept = torch.randint(0, 2, (n,), generator=gen).to(torch.int32).cuda()
    assert torch.equal(route_kernel.route_unpack(buf, slot, kept, fill),
                       ref.route_unpack(buf, slot, kept, fill))


@pytest.mark.parametrize("n_probe", [1, 6])
def test_shard_apply_kernel_matches_plain(gen, n_probe):
    cfg = DHTConfig(n_shards=2, buckets_per_shard=256, n_probe=n_probe)
    st = dht_create(cfg, device="cuda")
    keys = _words(gen, 300, cfg.key_words)
    st, _ = dht_write(st, keys, _words(gen, 300, cfg.val_words))
    live = torch.nonzero(st.flat_meta[:-1] & 1)[:, 0]
    st.flat_meta[live[0::7]] |= 2
    st.flat_meta[live[3::11]] = 0
    st.flat_csum[live[5::9]] ^= 1
    q = torch.cat([keys, _words(gen, 50, cfg.key_words)])
    base = torch.randint(0, 2 * 256 - n_probe + 1, (q.shape[0],),
                         generator=gen).to(torch.int32).cuda()
    slab = (st.flat_keys[:-1], st.flat_vals[:-1], st.flat_meta[:-1],
            st.flat_csum[:-1])
    a = apply_kernel.shard_apply(*slab, q, base, n_probe)
    b = ref.shard_apply(*slab, q, base, n_probe)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_engine_on_card_matches_cpu(gen):
    """Write, read, mixed and migrate rounds leave the same slab words
    and return the same items on the card as on the CPU; every kernel
    of the path launches."""
    cfg = DHTConfig(n_shards=4, buckets_per_shard=256)
    keys, vals = _words(gen, 600, 20, "cpu"), _words(gen, 600, 26, "cpu")
    op = (torch.rand(600, generator=gen) < 0.05).to(torch.int32)
    out = {}
    for device in ("cuda", "cpu"):
        ops.reset_launches()
        st = dht_create(cfg, device=device)
        k, v = keys.to(device), vals.to(device)
        st, ws = dht_write(st, k, v)
        st.flat_csum[:40] ^= 1
        st, rv, rf, rs = dht_read(st, k)
        st, _, mv, mf, mc, _ = dht_execute(
            st, mixed_ops(op.to(device), k, v + 1), kinds=("read", "write"))
        st, _, gv, gf, gc, _ = dht_execute(st, migrate_ops(k, v),
                                           kinds=("migrate",))
        out[device] = (state_to_numpy(st),
                       [t.cpu() for t in (ws["code"], rv, rf, mv, mf, mc,
                                          gv, gf, gc)])
        if device == "cuda":
            assert all(n > 0 for n in ops.launches().values())
    for name in out["cpu"][0]:
        np.testing.assert_array_equal(out["cuda"][0][name],
                                      out["cpu"][0][name], name)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert torch.equal(a, b)


def test_kernel_wrappers_reject_bad_inputs(gen):
    with pytest.raises(ValueError):
        hash_kernel.hash64(_words(gen, 4, 200))          # key too wide
    with pytest.raises(ValueError):
        hash_kernel.hash64(_words(gen, 4, 20, "cpu"))    # not on the card
    with pytest.raises(ValueError):
        ops.hash64(_words(gen, 4, 20)[:, ::2])           # not contiguous
