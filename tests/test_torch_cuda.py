"""Card-only tests of the port: every CUDA kernel against its plain
version, the engine on the card against the engine on the CPU, and the
launch counts.  Marked ``cuda``; each skips where there is no NVIDIA GPU
(decided inside the fixture, never at import).  Run them on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

from repro_torch.convert import l1_to_numpy, state_to_numpy
from repro_torch.core import (
    PROV_INTERP,
    DHTConfig,
    InterpConfig,
    L1Config,
    SurrogateConfig,
    PendingWrites,
    dht_create,
    dht_execute,
    dht_read,
    dht_read_async,
    dht_read_cached,
    dht_read_commit,
    dht_write,
    dht_write_async,
    dht_write_commit,
    l1_create,
    lookup_interpolate_or_compute,
    migrate_ops,
    mixed_ops,
    store,
    surrogate_create,
)
from repro_torch.core.neighbors import lattice_step, round_significant
from repro_torch.kernels import (
    apply_kernel,
    checksum_kernel,
    hash_kernel,
    l1_kernel,
    local_attn_kernel,
    ops,
    probe_kernel,
    ref,
    round_kernel,
    route_kernel,
    stencil_kernel,
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


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("n,kw", [(65536 + 77, 20), (129, 1), (129, 3),
                                  (129, 4), (129, 8), (1000, 33), (257, 0)])
def test_hash64_kernel_edges(gen, n, kw, misaligned):
    """Bit for bit on the 16-byte paths (KW % 4 == 0, aligned rows; KW 20
    unrolled), the 4-byte path (other widths, and rows one word off
    alignment), N off the block and the widest key the wrapper takes
    (kw 0 here)."""
    kw = kw or hash_kernel.max_kw()
    keys = _words(gen, n, kw)
    if misaligned:
        keys = _off_by_one_word(keys)
    assert torch.equal(hash_kernel.hash64(keys), ref.hash64(keys))


@pytest.mark.parametrize("n,rows,width", [(1, 16, 1), (80, 64, 22),
                                          (65536, 131072, 48), (50, 77, 21),
                                          (300, 513, 28), (9, 1001, 48),
                                          (131072, 131072, 22), (0, 64, 22)])
def test_route_kernels_match_plain(gen, n, rows, width):
    """Bit for bit, with fill rows (-1) and an index past n, which the
    kernel clamps to the last row; route_pack also from a matrix one word
    off its 16-byte alignment (the 4-byte path), and from no rows at all
    (a rank with nothing to send: every row is fill)."""
    mat = _words(gen, n, width)
    inv = torch.randint(-1, n, (rows,), generator=gen).to(torch.int32).cuda()
    inv[:3] = -1
    inv[-1] = n + 5
    fill = _words(gen, 1, width)[0]
    clamped = inv.clamp(max=n - 1)
    assert torch.equal(route_kernel.route_pack(mat, inv, fill),
                       ref.route_pack(mat, clamped, fill))
    flat = torch.empty(n * width + 1, dtype=torch.int32, device="cuda")
    shifted = flat[1:].view(n, width)
    shifted.copy_(mat)
    assert torch.equal(route_kernel.route_pack(shifted, inv, fill),
                       ref.route_pack(mat, clamped, fill))
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


def _window_slab(gen, nb, kw, vw, n_probe, c):
    """A slab of ``nb`` rows drawn from six keys (so windows hold equal
    keys, some equal in every word but the last), with empty, INVALID and
    corrupted buckets, and ``c`` >= 5 queries whose first windows are fully
    occupied by other keys, all empty, ending at the slab's last row, cut
    by the clamp, and the F6 window (the key INVALID, then failing its
    checksum, then valid).  CPU tensors."""
    pool = _words(gen, 6, kw, "cpu")
    sk = pool[torch.randint(0, 6, (nb,), generator=gen)]
    sk[torch.rand(nb, generator=gen) < 0.15, -1] ^= 1
    sv = _words(gen, nb, vw, "cpu")
    kinds = torch.tensor([0, 1, 3, 2, 1 | (3 << 8)], dtype=torch.int32)
    sm = kinds[torch.multinomial(torch.tensor([0.25, 0.4, 0.15, 0.05, 0.15]),
                                 nb, replacement=True, generator=gen)]
    sk[:n_probe] = _words(gen, n_probe, kw, "cpu")
    sm[:n_probe] = 1
    sm[nb // 2:nb // 2 + n_probe] = 0
    f = nb // 4
    sk[f:f + 3] = pool[0]
    sm[f:f + 3] = torch.tensor([3, 1, 1], dtype=torch.int32)
    good = ref.checksum(sk, sv)
    sc = good ^ (torch.rand(nb, generator=gen) < 0.1).to(torch.int32)
    sc[f + 1:f + 3] = good[f + 1:f + 3] ^ torch.tensor([1, 0],
                                                       dtype=torch.int32)
    q = pool[torch.randint(0, 6, (c,), generator=gen)]
    q[::5] = _words(gen, len(range(0, c, 5)), kw, "cpu")
    q[4] = pool[0]
    base = torch.randint(-2, nb - n_probe + 3, (c,), generator=gen).to(
        torch.int32)
    base[:5] = torch.tensor([0, nb // 2, nb - n_probe, -3, f])
    return sk, sv, sm, sc, q, base


def _off_by_one_word(t):
    """A contiguous copy of ``t`` whose first word sits 4 bytes past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("kw,vw,n_probe,c", [
    (20, 26, 6, 203),            # the engine's widths, C off the block size
    (7, 5, 4, 77),               # widths not multiples of 4 (4-byte paths)
    (23, 33, 6, 1000),
    (4, 1, 1, 33),               # one candidate, one-chunk keys
    (20, 26, 40, 5),             # two 32-candidate segments
    (300, 200, 6, 100)])         # 64.5 KB of shared memory (opt-in)
def test_shard_apply_kernel_edge_windows(gen, kw, vw, n_probe, c,
                                         misaligned):
    """Bit for bit against the plain version on windows that are full,
    empty, clamped, at the slab's end, near-equal in the last key word and
    F6-shaped; with ``misaligned`` the slab's keys and values start one
    word off a 16-byte boundary (the kernel's 4-byte paths)."""
    sk, sv, sm, sc, q, base = (t.cuda() for t in _window_slab(
        gen, 3 * n_probe + 40, kw, vw, n_probe, c))
    if misaligned:
        sk, sv = _off_by_one_word(sk), _off_by_one_word(sv)
    a = apply_kernel.shard_apply(sk, sv, sm, sc, q, base, n_probe)
    b = ref.shard_apply(sk, sv, sm, sc, q, base, n_probe)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    found, wkind = b[1], b[4]
    assert {-1, 0, 1} <= set(found.tolist()) or n_probe == 1
    assert {1, 2, 3} <= set(wkind.tolist())


def test_shard_apply_rejects_rows_wider_than_shared_memory(gen):
    width = apply_kernel.max_width()
    keys = _words(gen, 8, width - 25)
    vals = _words(gen, 8, 26)
    meta = torch.zeros(8, dtype=torch.int32, device="cuda")
    base = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        apply_kernel.shard_apply(keys, vals, meta, meta, keys, base, 6)


@pytest.mark.parametrize("validate", [True, False])
@pytest.mark.parametrize("n_probe", [1, 4, 6])
def test_probe_kernel_matches_plain(gen, n_probe, validate):
    """A roughened two-shard slab (INVALID, emptied and corrupted
    buckets), random and edge windows (the last one at S*B - n_probe), a
    window holding one key twice with its first copy corrupted."""
    cfg = DHTConfig(n_shards=2, buckets_per_shard=256, n_probe=n_probe)
    st = dht_create(cfg, device="cuda")
    keys = _words(gen, 300, cfg.key_words)
    st, _ = dht_write(st, keys, _words(gen, 300, cfg.val_words))
    live = torch.nonzero(st.flat_meta[:-1] & 1)[:, 0]
    st.flat_meta[live[0::7]] |= 2
    st.flat_meta[live[3::11]] = 0
    st.flat_csum[live[5::9]] ^= 1
    st.flat_keys[9] = st.flat_keys[8]
    st.flat_meta[8:10] = 1 | (1 << 8)
    st.flat_csum[8] ^= 1
    q = torch.cat([keys, _words(gen, 50, cfg.key_words), st.flat_keys[8:9]])
    base = torch.randint(0, 2 * 256 - n_probe + 1, (q.shape[0],),
                         generator=gen).to(torch.int32).cuda()
    base[-2] = 2 * 256 - n_probe
    base[-1] = 8
    slab = (st.flat_keys[:-1], st.flat_vals[:-1], st.flat_meta[:-1],
            st.flat_csum[:-1])
    a = probe_kernel.probe(*slab, q, base, n_probe, validate)
    b = ref.probe(*slab, q, base, n_probe, validate)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a[1][-1]) == (-1 if validate else 1)


@pytest.mark.parametrize("validate", [True, False])
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("kw,vw,n_probe,c", [
    (20, 26, 6, 203),            # the engine's widths, C off the block size
    (20, 26, 6, 1),              # one query: the F6 window
    (7, 5, 4, 77),               # widths not multiples of 4 (4-byte paths)
    (23, 33, 6, 1000),
    (4, 1, 1, 33),               # one candidate, one-chunk keys
    (20, 26, 40, 203),           # two 32-candidate segments, early stop
    (900, 1000, 6, 40)])         # rows past shared memory (unstaged)
def test_probe_kernel_edge_windows(gen, kw, vw, n_probe, c, misaligned,
                                   validate):
    """Bit for bit against the plain version on windows that are full,
    empty, clamped at both ends, at the slab's end, near-equal in the last
    key word and F6-shaped; with ``misaligned`` the slab's keys and values
    start one word off a 16-byte boundary (the kernel's 4-byte paths)."""
    sk, sv, sm, sc, q, base = (t.cuda() for t in _window_slab(
        gen, 3 * n_probe + 40, kw, vw, n_probe, max(c, 5)))
    if c == 1:
        q, base = q[4:5], base[4:5]
    if misaligned:
        sk, sv = _off_by_one_word(sk), _off_by_one_word(sv)
    a = probe_kernel.probe(sk, sv, sm, sc, q, base, n_probe, validate)
    b = ref.probe(sk, sv, sm, sc, q, base, n_probe, validate)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert set(b[1].tolist()) <= ({-1, 0, 1} if validate else {0, 1})
    if validate and c > 1 and n_probe > 1:
        assert {-1, 0, 1} <= set(b[1].tolist())


@pytest.mark.parametrize("case", ["odd", "one", "misaligned", "dropped",
                                  "past_end"])
@pytest.mark.parametrize("n,rows,width", [(37, 29, 3), (300, 513, 1),
                                          (65536, 131072, 28),
                                          (101, 64, 130)])
def test_route_unpack_kernel_edges(gen, case, n, rows, width):
    """Bit for bit against the plain version with an odd width, one word,
    a reply buffer and fill row one word off their 16-byte alignment (the
    8- and 4-byte paths), every item dropped, and slots before the first
    and past the last row (the kernel clamps them)."""
    if case == "odd":
        width += 1 - width % 2
    elif case == "one":
        width = 1
    buf = _words(gen, rows, width)
    fill = _words(gen, 1, width)[0]
    if case == "misaligned":
        buf, fill = _off_by_one_word(buf), _off_by_one_word(fill)
    slot = torch.randint(0, rows, (n,), generator=gen).to(torch.int32).cuda()
    kept = torch.randint(0, 2, (n,), generator=gen).to(torch.int32).cuda()
    if case == "dropped":
        kept.zero_()
    if case == "past_end":
        kept.fill_(1)
        slot[::3] = rows + torch.arange(0, n, 3, device="cuda",
                                        dtype=torch.int32) % 5
        slot[1::7] = -1 - torch.arange(1, n, 7, device="cuda",
                                       dtype=torch.int32) % 3
    out = route_kernel.route_unpack(buf, slot, kept, fill)
    assert torch.equal(out, ref.route_unpack(buf, slot.clamp(0, rows - 1),
                                             kept, fill))
    if case == "dropped":
        assert torch.equal(out, fill.expand(n, width))


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("sets,ways,n,kw,vw", [
    (1024, 4, 65536, 20, 26), (5, 1, 40, 20, 26), (16, 8, 300, 20, 26),
    (16, 8, 300, 7, 25), (64, 4, 1000, 20, 28), (7, 40, 200, 20, 26)])
def test_l1_probe_kernel_matches_plain(gen, sets, ways, n, kw, vw, misaligned):
    """Bit for bit on the 16-byte key chunks (KW % 4 == 0) and the 4-byte
    ones (KW 7, or query rows one word off 16-byte alignment), value rows
    of 25, 26 and 28 words (the 4-, 8- and 16-byte copies), more ways
    than a group's four lanes (8, and 40: two mask segments), a key in two
    ways whose first is incoherent, and set indices out of range (the
    kernel clamps them)."""
    lkeys = _words(gen, sets * ways, kw).reshape(sets, ways, kw)
    lvals = _words(gen, sets * ways, vw).reshape(sets, ways, vw)
    flags = torch.randint(0, 2, (sets, ways), generator=gen).bool().cuda()
    set_idx = torch.randint(0, sets, (n,), generator=gen).to(
        torch.int32).cuda()
    way = torch.randint(0, ways, (n,), generator=gen).cuda()
    q = lkeys[set_idx.long(), way].clone()
    q[::2] = _words(gen, (n + 1) // 2, kw)
    flags[set_idx[3].long(), way[3]] = True      # query 3 hits
    if ways > 1:             # key in two ways, the first one incoherent
        s = int(set_idx[1])
        lkeys[s, 1] = lkeys[s, 0]
        q[1] = lkeys[s, 0]
        flags[s, 0], flags[s, 1] = False, True
    if misaligned:
        q = _off_by_one_word(q)
    for f in (flags, flags.to(torch.uint8)):
        a = l1_kernel.l1_probe(lkeys, lvals, f, q, set_idx)
        b = ref.l1_probe(lkeys, lvals, flags, q, set_idx)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert bool(a[0].any()) and not bool(a[0].all())
    past = set_idx.clone()
    past[::3] = sets + torch.arange(0, n, 3, device="cuda",
                                    dtype=torch.int32) % 5
    past[1::7] = -1
    a = l1_kernel.l1_probe(lkeys, lvals, flags, q, past)
    b = ref.l1_probe(lkeys, lvals, flags, q, past.clamp(0, sets - 1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cached_read_on_card_matches_cpu(gen):
    """A mixed write / cached-read stream on the card and on the CPU:
    the same values, found flags, l1_hits and wire words per read, the
    same slab and L1 words; both kernels of the tier launch."""
    cfg = DHTConfig(n_shards=8, buckets_per_shard=512)
    keys, vals = _words(gen, 256, 20, "cpu"), _words(gen, 256, 26, "cpu")
    picks = [torch.randint(0, 256, (n,), generator=gen)
             for n in (48, 128, 128) * 4]
    out = {}
    for device in ("cuda", "cpu"):
        ops.reset_launches()
        st = dht_create(cfg, device=device)
        l1 = l1_create(L1Config(n_sets=128, n_ways=4), 8, device=device)
        res = []
        for i, p in enumerate(picks):
            k = keys[p].to(device)
            if i % 3 == 0:
                st, _ = dht_write(st, k, (vals[p] + i).to(device))
                continue
            st, l1, v, f, s = dht_read_cached(st, l1, k)
            res.append((v.cpu(), f.cpu(), int(s["l1_hits"]),
                        int(s["wire_words"])))
        out[device] = (state_to_numpy(st), l1_to_numpy(l1), res)
        if device == "cuda":
            n = ops.launches()
            assert n["l1_probe"] == 8 and n["probe"] == 8
    for i in (0, 1):
        for name in out["cpu"][i]:
            np.testing.assert_array_equal(out["cuda"][i][name],
                                          out["cpu"][i][name], name)
    for (av, af, ah, aw), (bv, bf, bh, bw) in zip(out["cuda"][2],
                                                  out["cpu"][2]):
        assert torch.equal(av, bv) and torch.equal(af, bf)
        assert (ah, aw) == (bh, bw)
    assert sum(r[2] for r in out["cpu"][2]) > 0


@pytest.mark.parametrize("n,kw,vw", [(1, 20, 26), (7, 4, 1), (300, 33, 17),
                                     (65536, 20, 26)])
def test_checksum_kernel_matches_plain(gen, n, kw, vw):
    keys, vals = _words(gen, n, kw), _words(gen, n, vw)
    assert torch.equal(checksum_kernel.checksum(keys, vals),
                       ref.checksum(keys, vals))
    wide = torch.cat([keys, vals, _words(gen, n, 3)], dim=1)
    assert torch.equal(ops.checksum(wide[:, :kw], wide[:, kw:kw + vw]),
                       ref.checksum(keys, vals))


@pytest.mark.parametrize("n,kw,vw", [
    (1, 1, 0), (7, 0, 1),        # the narrowest rows
    (129, 20, 75), (300, 48, 47),  # the widest (95 words), N off the tile
    (1000, 7, 5),                # widths not multiples of 4 or 2
    (131077, 20, 26)])           # the write pass's widths, a ragged tile
def test_checksum_kernel_edge_views(gen, n, kw, vw):
    """Bit for bit against the plain version on contiguous rows (the bulk
    copies), a row-strided slice starting at column 1 (misaligned, ld !=
    width) and contiguous rows one word off a 16-byte boundary."""
    keys, vals = _words(gen, n, kw), _words(gen, n, vw)
    want = ref.checksum(keys, vals)
    assert torch.equal(checksum_kernel.checksum(keys, vals), want)
    wide = torch.cat([_words(gen, n, 1), keys, vals, _words(gen, n, 2)], 1)
    assert torch.equal(checksum_kernel.checksum(
        wide[:, 1:1 + kw], wide[:, 1 + kw:1 + kw + vw]), want)
    assert torch.equal(checksum_kernel.checksum(
        _off_by_one_word(keys), _off_by_one_word(vals)), want)


@pytest.mark.parametrize("sig", [1, 3, 4])
def test_round_sig_kernel_matches_plain(gen, sig):
    """Bit for bit on the card, the band around each power of ten
    included: both call CUDA's logf."""
    mag = 10.0 ** (torch.rand(1_000_000, generator=gen,
                              dtype=torch.float64) * 76 - 38)
    sign = torch.where(torch.rand(1_000_000, generator=gen) < 0.5, -1.0, 1.0)
    p = torch.tensor([10.0 ** k for k in range(-37, 38)],
                     dtype=torch.float32).view(torch.int32)
    band = (p[:, None] + torch.arange(-64, 65, dtype=torch.int32)[None, :]
            ).view(torch.float32).reshape(-1)
    edges = torch.tensor([0.0, -0.0, 1e-40, -1e-45, float("inf"),
                          -float("inf"), float("nan"), 1.0])
    x = torch.cat([edges, band, -band, (mag * sign).to(torch.float32)])
    x = x.cuda().reshape(-1, 1)
    a = round_kernel.round_sig(x, sig)
    b = round_significant(x, sig)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (a[:4].view(torch.int32) == 0).all()            # +0
    # the 4-byte path (a view one word off 16-byte alignment), the n % 4
    # tail and inputs shorter than a vector, and one decade, [1, 10)
    one_decade = (10.0 ** torch.rand(4099, generator=gen)).cuda()
    flat = x.reshape(-1)
    for y in (flat[1:], flat[1:4098], one_decade, one_decade[1:],
              *(flat[o:o + m] for m in (1, 3, 5, 4097) for o in (0, 1))):
        assert torch.equal(round_kernel.round_sig(y, sig).view(torch.int32),
                           round_significant(y, sig).view(torch.int32))


@pytest.mark.parametrize("radius,coarse,n", [(1, True, 2978), (2, False, 64),
                                             (3, True, 64)])
def test_stencil_keys_kernel_matches_plain(gen, radius, coarse, n):
    """Radius 3 makes ``off * step`` inexact: the kernel must not fuse it
    into the add."""
    x = (10.0 ** (torch.rand((n, 10), generator=gen) * 6 - 3)).cuda()
    x[0, :3] = torch.tensor([9.99, 0.0999, 0.0])
    args = (3, 20, radius, coarse, 1 << 16, 6)
    a = stencil_kernel.stencil_keys(x, *args)
    b = ref.stencil_keys(x, *args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _stencil_rows(gen, n, d):
    """Queries over 1e-3..1e3 of either sign whose first words are 0, -0,
    denormals, +-inf, nan and values within 3 ulps of 10^-3..10^3."""
    x = (10.0 ** (torch.rand((n, d), generator=gen) * 6 - 3)
         * torch.where(torch.rand((n, d), generator=gen) < 0.5, -1.0, 1.0))
    x = x.to(torch.float32)
    p = torch.tensor([10.0 ** k for k in range(-3, 4)],
                     dtype=torch.float32).view(torch.int32)
    band = (p[:, None] + torch.arange(-3, 4, dtype=torch.int32)[None, :]
            ).view(torch.float32).reshape(-1)
    head = torch.cat([torch.tensor([0.0, -0.0, 1e-40, -1e-45, float("inf"),
                                    -float("inf"), float("nan")]),
                      band, -band])
    flat = x.reshape(-1)
    k = min(head.numel(), flat.numel())
    flat[:k] = head[:k]
    return x.cuda()


@pytest.mark.parametrize("coarse", [True, False])
@pytest.mark.parametrize("radius", [0, 1, 3])
@pytest.mark.parametrize("d", [1, 10, 17])
def test_stencil_keys_kernel_edges(gen, d, radius, coarse):
    """Bit for bit against the plain version on the card, specials and the
    F1 band included, for KW below 2D (truncated), 2D, above it (padding)
    and odd, n = 1 and 64, span 1 and sig 1, 3 and 4."""
    x = _stencil_rows(gen, 64, d)
    for kw in sorted({7, 20, 23, 2 * d}):
        for args in ((x, 3, kw, radius, coarse, 1 << 16, 6),
                     (x[:1], 3, kw, radius, coarse, 1 << 16, 6),
                     (x, 1, kw, radius, coarse, 6, 6),
                     (x, 4, kw, radius, coarse, 1000, 6)):
            a = stencil_kernel.stencil_keys(*args)
            b = ref.stencil_keys(*args)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), (
                kw, tuple(args[0].shape), args[1], args[5])


def test_stencil_keys_second_call_makes_no_host_copy(gen):
    """A second call on the same shapes copies nothing from the host and
    does not wait for the card: torch.profiler finds no Memcpy HtoD and no
    memcpy or synchronize runtime call inside it, and does find its
    kernel."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = _stencil_rows(gen, 2978, 10)
    args = (x, 3, 20, 1, True, 1 << 21, 6)
    stencil_kernel.stencil_keys(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("second_call"):
            stencil_kernel.stencil_keys(*args)
        torch.cuda.synchronize()
    events = prof.events()
    (rng,) = [e for e in events if e.name == "second_call"
              and e.device_type == torch.autograd.DeviceType.CPU]
    inside = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CPU
              and e is not rng and e.name.startswith("cu")
              and rng.time_range.start <= e.time_range.start
              and e.time_range.end <= rng.time_range.end]
    ids = {e.id for e in inside}
    device = [e.name for e in events
              if e.device_type != torch.autograd.DeviceType.CPU
              and e.id in ids]
    assert any("stencil_keys_kernel" in n for n in device), device
    assert not [n for n in device if "HtoD" in n], device
    assert not [e.name for e in inside
                if "Memcpy" in e.name or "Synchronize" in e.name]


def test_interp_on_card_matches_cpu(gen):
    """The bracketed near-miss construction through both forms of
    ``lookup_interpolate_or_compute`` on the card and on the CPU: the
    same keys, provenance and slab words; outputs at rtol 1e-5."""
    cfg = SurrogateConfig(sig_digits=3, dht=DHTConfig(
        n_shards=4, buckets_per_shard=4096))
    x = (torch.rand((64, 10), generator=gen) * 8 + 1.5)
    center = round_significant(x, 3)
    step = lattice_step(center, 3)

    def compute(v):
        return torch.cat([v * 2.0, v[:, :3]], dim=-1)

    out = {}
    for device in ("cuda", "cpu"):
        st = surrogate_create(cfg, device=device)
        for k in (-1, 1):
            p = center.clone()
            p[:, 0] += k * step[:, 0]
            st, _ = store(cfg, st, p.to(device), compute(p).to(device))
        res = []
        for one_round in (False, True):
            q = torch.cat([center[:40], x[40:] * 7]).to(device)
            st, o, prov, s = lookup_interpolate_or_compute(
                cfg, st, q, compute, InterpConfig(), one_round=one_round)
            res.append((o.cpu(), prov.cpu(), int(s["stored"])))
        out[device] = (state_to_numpy(st), res)
    for name in out["cpu"][0]:
        np.testing.assert_array_equal(out["cuda"][0][name],
                                      out["cpu"][0][name], name)
    for (ao, ap, an), (bo, bp, bn) in zip(out["cuda"][1], out["cpu"][1]):
        assert torch.equal(ap, bp) and an == bn
        np.testing.assert_allclose(ao.numpy(), bo.numpy(), rtol=1e-5)
    assert (out["cpu"][1][0][1][:40] == PROV_INTERP).all()


def test_engine_on_card_matches_cpu(gen):
    """Write, read, mixed and migrate rounds leave the same slab words
    and return the same items on the card as on the CPU; every kernel
    of the path launches, the checksum once per write pass."""
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
            n = ops.launches()
            engine = ("route_pack", "route_unpack", "hash64", "shard_apply",
                      "checksum", "probe")
            assert all(n[k] > 0 for k in engine)
            # four rounds: one probe pass in read, mixed and migrate;
            # every write pass launches the slot choice and the checksum
            assert n["probe"] == 3
            assert n["checksum"] == n["shard_apply"]
    for name in out["cpu"][0]:
        np.testing.assert_array_equal(out["cuda"][0][name],
                                      out["cpu"][0][name], name)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert torch.equal(a, b)


def test_migration_on_card_matches_cpu(gen):
    """A ring table grows from 4 to 8 shards in steps of 64 rows, with a
    dual read after each step (a few old-epoch checksums corrupted, so
    the read flags them INVALID in the old slab): both epochs' words,
    the reads and the stats equal the CPU's; a dual read launches the
    probe kernel once over each epoch's slab."""
    from repro_torch.core import (migration_begin, migration_finish,
                                  migration_read, migration_step,
                                  ring_create, ring_resize)

    cfg = DHTConfig(n_shards=4, buckets_per_shard=256)
    keys, vals = _words(gen, 300, 20, "cpu"), _words(gen, 300, 26, "cpu")
    out = {}
    for device in ("cuda", "cpu"):
        st = dht_create(cfg, ring_create(4), device=device)
        k = keys.to(device)
        dht_write(st, k, vals.to(device))
        mig = migration_begin(st, ring_resize(st.ring, 8), batch=64)
        mig.old.flat_csum[:64] ^= 1
        rows = []
        while not mig.done:
            mig, step = migration_step(mig)
            ops.reset_launches()
            mig, v, f, ds = migration_read(mig, k)
            if device == "cuda":
                assert ops.launches()["probe"] == 2
            rows.append((v.cpu(), f.cpu(), step,
                         {n: int(ds[n]) for n in ("hits", "mismatches",
                                                  "hits_old_epoch")},
                         {n: a.copy() for n, a in
                          state_to_numpy(mig.old).items()}))
        st, stats = migration_finish(mig)
        out[device] = (state_to_numpy(st), rows, stats)
    card, cpu = out["cuda"], out["cpu"]
    for name in cpu[0]:
        np.testing.assert_array_equal(card[0][name], cpu[0][name], name)
    assert card[2] == cpu[2]
    for a, b in zip(card[1], cpu[1]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert a[2:4] == b[2:4]
        for name in b[4]:
            np.testing.assert_array_equal(a[4][name], b[4][name], name)
    assert card[1][0][3]["hits_old_epoch"] > 0


def test_replication_on_card_matches_cpu(gen):
    """k=2 on a ring of 4: a replicated write, the crash of shard 1, a
    failover read, a write during the outage, the recovery, the repair
    plan and run: every slab word, code, count and the plan's sources
    equal the CPU's.  The replica select reads the ring's device twin of
    the liveness bits: a replicated read issue half syncs the host no
    more often than an unreplicated one."""
    import warnings

    from repro_torch.core import (crash_shard, dht_write_replicated,
                                  plan_repair, recover_shard, repair_run,
                                  ring_create)

    keys, vals = _words(gen, 512, 20, "cpu"), _words(gen, 512, 26, "cpu")
    out = {}
    for device in ("cuda", "cpu"):
        cfg = DHTConfig(n_shards=4, n_replicas=2, buckets_per_shard=1024,
                        capacity=256)
        st = dht_create(cfg, ring_create(4), device=device)
        k, v = keys.to(device), vals.to(device)
        rows, counts = [], []
        st, ws = dht_write_replicated(st, k[:256], v[:256])
        rows.append(ws["code"].cpu())
        counts.append({n: int(ws[n]) for n in ("acked", "replica_writes")})
        st = crash_shard(st, 1)
        st, o, f, rs = dht_read(st, k[:256])
        rows += [o.cpu(), f.cpu()]
        counts.append(int(rs["fallback_reads"]))
        st, ws = dht_write_replicated(st, k[256:], v[256:])
        rows.append(ws["code"].cpu())
        st = recover_shard(st, 1)
        rows.append(plan_repair(st, 1).src.cpu())
        st, rep = repair_run(st, 1, batch=64)
        counts.append(rep)
        st, o, f, rs = dht_read(st, k)
        rows += [o.cpu(), f.cpu()]
        out[device] = (state_to_numpy(st), rows, counts)
    card, cpu = out["cuda"], out["cpu"]
    for name in cpu[0]:
        np.testing.assert_array_equal(card[0][name], cpu[0][name], name)
    assert all(torch.equal(a, b) for a, b in zip(card[1], cpu[1]))
    assert card[2] == cpu[2] and card[2][1] > 0

    def syncs(st):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                dht_read_commit(dht_read_async(st, keys.cuda()))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in caught)

    plain = DHTConfig(n_shards=4, buckets_per_shard=1024)
    rep2 = DHTConfig(n_shards=4, n_replicas=2, buckets_per_shard=1024)
    st1 = dht_create(plain, ring_create(4), device="cuda")
    st2 = crash_shard(dht_create(rep2, ring_create(4), device="cuda"), 1)
    syncs(st1), syncs(st2)          # first calls set up torch's state
    assert syncs(st2) <= syncs(st1)


def test_commit_waits_on_its_round_not_the_device(gen):
    """A read round is issued, then ~50 ms of sleep is queued on the same
    stream: dht_read_commit returns while the sleep still runs (it waits
    on the round's event, not on the device), and the values it returned
    are the table's."""
    cfg = DHTConfig(n_shards=8, buckets_per_shard=1 << 12)
    keys, vals = _words(gen, 4096, 20), _words(gen, 4096, 26)
    st = dht_create(cfg)
    st, _ = dht_write(st, keys, vals)
    torch.cuda.synchronize()
    rnd = dht_read_async(st, keys)
    torch.cuda._sleep(100_000_000)           # ~50 ms at ~2 GHz
    slept = torch.cuda.Event()
    slept.record()
    _, out, found, _ = dht_read_commit(rnd)
    assert rnd.event.query(), "commit returned before its round ended"
    assert not slept.query(), "commit waited for work queued after it"
    torch.cuda.synchronize()
    assert bool(found.all()) and torch.equal(out, vals)
    assert rnd.telemetry["commit_wait_us"] < 40_000


def test_issue_commit_on_card_matches_cpu(gen):
    """The split halves at B = 2^12 on the card and on the CPU: a write
    issued and committed late, a read issued after it, a read that
    forwards promised writes, and a write of the promised keys leave the
    same slab words and return the same items."""
    cfg = DHTConfig(n_shards=8, buckets_per_shard=1 << 12)
    keys, vals = _words(gen, 2048, 20, "cpu"), _words(gen, 2048, 26, "cpu")
    fresh = _words(gen, 512, 20, "cpu")
    out = {}
    for device in ("cuda", "cpu"):
        st = dht_create(cfg, device=device)
        k, v, f = keys.to(device), vals.to(device), fresh.to(device)
        w = dht_write_async(st, k, v)
        r = dht_read_async(st, k[:1024])
        _, rv, rf, rs = dht_read_commit(r)
        _, ws = dht_write_commit(w)
        pend = PendingWrites(cfg.val_words)
        pend.promise(f)
        q = torch.cat([k[1024:1536], f])
        r2 = dht_read_async(st, q, pending=pend)
        pend.publish(f, v[:512])
        w2 = dht_write_async(st, f, v[:512])
        _, fv, ff, fs = dht_read_commit(r2)
        _, ws2 = dht_write_commit(w2)
        out[device] = (state_to_numpy(st), [
            t.cpu() for t in (rv, rf, ws["code"], fv, ff, ws2["code"],
                              r2.conflict)])
    for name in out["cpu"][0]:
        np.testing.assert_array_equal(out["cuda"][0][name],
                                      out["cpu"][0][name], name)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert torch.equal(a, b)
    assert bool(out["cuda"][1][4].all())
    assert int(out["cuda"][1][6].sum()) == 512


def test_kernel_wrappers_reject_bad_inputs(gen):
    with pytest.raises(ValueError):
        hash_kernel.hash64(_words(gen, 4, 200))          # key too wide
    with pytest.raises(ValueError):
        hash_kernel.hash64(_words(gen, 4, 20, "cpu"))    # not on the card
    with pytest.raises(ValueError):
        ops.hash64(_words(gen, 4, 20)[:, ::2])           # not contiguous
    with pytest.raises(ValueError):                      # row too wide
        checksum_kernel.checksum(_words(gen, 4, 60), _words(gen, 4, 60))
    with pytest.raises(ValueError):                      # rows differ
        checksum_kernel.checksum(_words(gen, 4, 20), _words(gen, 5, 26))
    with pytest.raises(ValueError):                      # not float32
        round_kernel.round_sig(torch.ones(4, dtype=torch.float64).cuda(), 3)
    with pytest.raises(ValueError):                      # mixed devices
        ops.checksum(_words(gen, 4, 20), _words(gen, 4, 26, "cpu"))
    with pytest.raises(ValueError):                      # not 2-d
        stencil_kernel.stencil_keys(torch.ones(4).cuda(), 3, 20)
    wide = stencil_kernel.max_dims() + 1                 # key too wide
    with pytest.raises(ValueError):
        stencil_kernel.stencil_keys(torch.ones(2, wide).cuda(), 3, 2 * wide)
    keys = _words(gen, 8, 20)
    with pytest.raises(ValueError):                      # base rows differ
        probe_kernel.probe(keys, _words(gen, 8, 26), keys[:, 0].contiguous(),
                           keys[:, 1].contiguous(), keys,
                           torch.zeros(7, dtype=torch.int32).cuda(), 6)
    with pytest.raises(ValueError):                      # int32 flags
        l1_kernel.l1_probe(keys.reshape(2, 4, 20), _words(gen, 8, 26).reshape(
            2, 4, 26), torch.ones((2, 4), dtype=torch.int32).cuda(), keys,
            torch.zeros(8, dtype=torch.int32).cuda())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hk,d,w", [
    (1, 300, 4, 2, 256, 64),     # gemma3's head dim, ragged S
    (2, 100, 2, 2, 16, 1024),    # window >= S
    (1, 77, 2, 1, 64, 5),        # window below a tile
    (1, 40, 2, 2, 128, 1),       # window 1
    (3, 1, 2, 1, 32, 8),         # S = 1
    (2, 64, 1, 1, 8, 16),
    (1, 130, 2, 2, 128, 64),     # S past the 128- and 64-row query tiles
    (1, 160, 2, 1, 64, 31),      # windows one below, at and one above
    (1, 160, 2, 1, 64, 32),      # the key tile: 32 keys in float32,
    (1, 160, 2, 1, 64, 33),      # 64 in bf16
    (1, 200, 2, 1, 64, 63),
    (1, 200, 2, 1, 64, 64),
    (1, 200, 2, 1, 64, 65),
    (2, 520, 4, 2, 256, 200),    # G = 2 at D = 256 over many key tiles
    (1, 150, 2, 1, 8, 40)])      # D = 8, zero-padded to 64 in bf16
def test_local_attention_kernel_matches_plain(gen, dtype, b, s, h, hk, d, w):
    q = torch.randn((b, s, h, d), generator=gen).to(dtype).cuda()
    k = torch.randn((b, s, hk, d), generator=gen).to(dtype).cuda()
    v = torch.randn((b, s, hk, d), generator=gen).to(dtype).cuda()
    out = local_attn_kernel.local_attention(q, k, v, w)
    plain = ref.local_attention(q, k, v, w)
    assert out.dtype == dtype and out.shape == (b, s, h, d)
    err = float((out.float() - plain.float()).abs().max())
    assert err <= local_attn_kernel.tolerance(plain), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hk,d,w", [
    (1, 300, 4, 2, 256, 64), (2, 100, 2, 2, 16, 1024), (1, 40, 2, 2, 128, 1),
    (3, 1, 2, 1, 32, 8), (1, 130, 2, 1, 256, 65), (2, 520, 4, 2, 256, 200)])
def test_local_attention_kernel_lse_matches_plain(gen, dtype, b, s, h, hk, d,
                                                  w):
    """The forward asked for each row's log-sum-exp: the lse against the
    plain ``ref.local_attention_lse`` within ``lse_tolerance``, and the
    output the same bits as without it."""
    q = torch.randn((b, s, h, d), generator=gen).to(dtype).cuda()
    k = torch.randn((b, s, hk, d), generator=gen).to(dtype).cuda()
    v = torch.randn((b, s, hk, d), generator=gen).to(dtype).cuda()
    out, lse = local_attn_kernel.local_attention(q, k, v, w, with_lse=True)
    assert torch.equal(out, local_attn_kernel.local_attention(q, k, v, w))
    plain = ref.local_attention_lse(q, k, v, w)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    err = float((lse - plain).abs().max())
    assert err <= local_attn_kernel.lse_tolerance(plain), err


def test_local_attention_kernel_takes_strided_views(gen):
    """Heads sliced out of a wider projection: no copy, same result."""
    wide = torch.randn((2, 50, 6, 32), generator=gen).cuda()
    q, k, v = wide[:, :, :4], wide[:, :, 4:5], wide[:, :, 5:6]
    before = ops.launches()["local_attention"]
    out = ops.local_attention(q, k, v, window=9)
    assert ops.launches()["local_attention"] == before + 1
    plain = ref.local_attention(q, k, v, 9)
    assert float((out - plain).abs().max()) <= 1e-5
    # rows one float off 16-byte alignment: copied, then the kernel
    flat = torch.randn(1 + wide.numel(), generator=gen).cuda()[1:]
    odd_q = flat.view(wide.shape)[:, :, :4]
    out = ops.local_attention(odd_q, k, v, window=9)
    assert ops.launches()["local_attention"] == before + 2
    plain = ref.local_attention(odd_q, k, v, 9)
    assert float((out - plain).abs().max()) <= 1e-5
    with pytest.raises(ValueError):                     # mixed devices
        ops.local_attention(q, k.cpu(), v, window=9)
    odd = torch.zeros((1, 8, 2, 48), device="cuda")
    with pytest.raises(ValueError):                     # head dim 48
        local_attn_kernel.local_attention(odd, odd, odd, 4)


def _bwd_inputs(gen, dtype, b, s, h, hk, d):
    q = torch.randn((b, s, h, d), generator=gen).to(dtype).cuda()
    k = torch.randn((b, s, hk, d), generator=gen).to(dtype).cuda()
    v = torch.randn((b, s, hk, d), generator=gen).to(dtype).cuda()
    dout = torch.randn((b, s, h, d), generator=gen).to(dtype).cuda()
    return q, k, v, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hk,d,w", [
    (1, 300, 4, 2, 256, 64),     # gemma3's head dim, ragged S
    (2, 100, 2, 2, 16, 1024),    # window >= S
    (1, 77, 2, 1, 64, 5),        # window below a tile
    (1, 40, 2, 2, 128, 1),       # window 1
    (3, 1, 2, 1, 32, 8),         # S = 1
    (2, 64, 1, 1, 8, 16),
    (1, 160, 2, 1, 64, 31),      # windows one below, at and one above the
    (1, 160, 2, 1, 64, 32),      # 32-key tiles
    (1, 160, 2, 1, 64, 33),
    (1, 130, 2, 1, 256, 63),     # windows one below, at and one above the
    (1, 130, 2, 1, 256, 64),     # 64-key and 64-row tiles of the bf16
    (1, 130, 2, 1, 256, 65),     # path, S past two of them
    (2, 520, 4, 2, 256, 200),    # G = 2 at D = 256 over many tiles
    (1, 300, 10, 1, 256, 100)])  # recurrentgemma's G = 10
def test_local_attention_bwd_kernel_matches_plain(gen, dtype, b, s, h, hk, d,
                                                  w):
    """The backward kernel's (dq, dk, dv), from the forward's output and
    lse, against autograd through the plain version within
    ``bwd_tolerance``, and the same bits on a second run (no atomics)."""
    q, k, v, dout = _bwd_inputs(gen, dtype, b, s, h, hk, d)
    out, lse = local_attn_kernel.local_attention(q, k, v, w, with_lse=True)
    got = local_attn_kernel.local_attention_bwd(q, k, v, out, dout, w, lse)
    again = local_attn_kernel.local_attention_bwd(q, k, v, out, dout, w, lse)
    plain = ref.local_attention_bwd(q, k, v, out, dout, w)
    tols = local_attn_kernel.bwd_tolerance(plain)
    for name, x, y, z, tol in zip(("dq", "dk", "dv"), got, plain, again, tols):
        assert x.dtype == dtype and x.shape == y.shape, name
        err = float((x.float() - y.float()).abs().max())
        assert err <= tol, (name, err, tol)
        assert torch.equal(x, z), name


def test_local_attention_autograd_launches_both_kernels(gen):
    """Through ``ops.local_attention`` with inputs that need a gradient:
    one forward and one backward launch, gradients equal to the backward
    kernel called by hand; strided views of a wider projection go in;
    without a graph (serving) the forward kernel alone."""
    wide = torch.randn((2, 70, 6, 32), generator=gen).cuda().requires_grad_()
    q, k, v = wide[:, :, :4], wide[:, :, 4:5], wide[:, :, 5:6]
    before = ops.launches()
    out = ops.local_attention(q, k, v, window=9)
    dout = torch.randn(out.shape, generator=gen).cuda()
    (grad,) = torch.autograd.grad(out, wide, dout)
    after = ops.launches()
    assert after["local_attention"] == before["local_attention"] + 1
    assert after["local_attention_bwd"] == before["local_attention_bwd"] + 1
    with torch.no_grad():
        ops.local_attention(q, k, v, window=9)
    served = ops.launches()
    assert served["local_attention"] == after["local_attention"] + 1
    assert served["local_attention_bwd"] == after["local_attention_bwd"]
    _, lse = local_attn_kernel.local_attention(
        q.detach(), k.detach(), v.detach(), 9, with_lse=True)
    dq, dk, dv = local_attn_kernel.local_attention_bwd(
        q.detach(), k.detach(), v.detach(), out.detach(), dout, 9, lse)
    torch.testing.assert_close(grad, torch.cat([dq, dk, dv], dim=2),
                               rtol=0, atol=0)
    odd = torch.zeros((1, 8, 2, 48), device="cuda")
    lse8 = torch.zeros((1, 2, 8), device="cuda")
    with pytest.raises(ValueError):                     # head dim 48
        local_attn_kernel.local_attention_bwd(odd, odd, odd, odd, odd, 4, lse8)
    x = torch.zeros((1, 8, 2, 32), device="cuda")
    with pytest.raises(ValueError):                     # types differ
        local_attn_kernel.local_attention_bwd(x, x, x, x, x.bfloat16(), 4,
                                              lse8)
    with pytest.raises(ValueError):                     # lse (B, S, H)
        local_attn_kernel.local_attention_bwd(x, x, x, x, x, 4,
                                              lse8.transpose(1, 2))


def test_lm_on_card_matches_cpu(gen):
    """The reduced gemma3-12b on the card (local layers through the
    kernel) against the same weights on the CPU (plain version): forward
    logits and 24 decode steps at rtol 1e-4 (float32)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import decode_step, forward, init_cache, init_lm

    cfg = reduced(get_config("gemma3-12b"))
    lm_cpu = init_lm(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    lm_gpu = init_lm(cfg, generator=torch.Generator("cuda").manual_seed(5))
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    lm_gpu.refresh_head()
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    ops.reset_launches()
    on_card = forward(lm_gpu, {"tokens": toks.cuda()})
    n_local = sum(k == "attn_local" for k in cfg.block_pattern)
    assert ops.launches()["local_attention"] == n_local
    on_cpu = forward(lm_cpu, {"tokens": toks})
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-4, atol=1e-4)
    cg = init_cache(cfg, 2, 32, torch.float32)
    cc = init_cache(cfg, 2, 32, torch.float32, device="cpu")
    for t in range(24):
        a, cg = decode_step(lm_gpu, cg, toks[:, t:t + 1].cuda(), t)
        b, cc = decode_step(lm_cpu, cc, toks[:, t:t + 1], t)
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_sharded_nccl_world_one_matches_virtual(gen):
    """The multi-rank backend on the card: NCCL at world size 1 (one
    rank, one shard).  A sharded write and read, cached and uncached, in
    all three modes, equal the virtual-shard backend with the same cfg
    on the card: slab words, values, found flags and codes.  Every row
    is self-owned, so a read crosses the exchange with nothing but the
    capacity prologue's 2 words."""
    import datetime
    import socket

    import torch.distributed as dist

    from repro_torch.core.distributed import ShardedDHT

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=dev,
                            timeout=datetime.timedelta(seconds=120))
    try:
        keys, vals = _words(gen, 600, 20, "cuda"), _words(gen, 600, 26,
                                                          "cuda")
        for mode in ("lockfree", "fine", "coarse"):
            cfg = DHTConfig(n_shards=1, buckets_per_shard=2048, mode=mode)
            d = ShardedDHT.create(cfg, device=dev,
                                  l1cfg=L1Config(n_sets=64, n_ways=4))
            ws = d.write(keys, vals)
            o1, f1, s1 = d.read(keys)
            o2, f2, s2 = d.read(keys)
            st = dht_create(cfg, device="cuda")
            st, vws = dht_write(st, keys, vals)
            st, vo, vf, _ = dht_read(st, keys)
            assert torch.equal(ws["code"], vws["code"])
            for o, f in ((o1, f1), (o2, f2)):
                assert torch.equal(o, vo) and torch.equal(f, vf)
            assert int(s2["l1_hits"]) > 0
            assert int(s1["wire_words"]) == 2
            ref = state_to_numpy(st)
            for name, words in state_to_numpy(d.state).items():
                np.testing.assert_array_equal(words, ref[name], name)
    finally:
        dist.destroy_process_group()


def test_recorded_rounds_on_card_match_cpu(gen):
    """The engine's self-record on the card: the same write, read and
    95/5 rounds at B = 2^12 on the card and on the CPU leave equal
    counters and equal events but the host-clock lanes and what only
    the card records (device spans, timed host reads); the card's
    lanes came through the pinned copy made at issue, and a commit of
    the recorded read waits for its round's event only."""
    from repro_torch import obs

    cfg = DHTConfig(n_shards=8, buckets_per_shard=1 << 12)
    keys, vals = _words(gen, 4096, 20), _words(gen, 4096, 26)
    op = (torch.rand(4096, generator=gen) < 0.05).to(torch.int32)
    got = {}
    for device in ("cuda", "cpu"):
        reg = obs.metrics.MetricRegistry()
        prev = obs.metrics.set_registry(reg)
        obs.get_tracer().clear()
        try:
            st = dht_create(cfg, device=device)
            k, v, o = keys.to(device), vals.to(device), op.to(device)
            st, _ = dht_write(st, k, v)
            rnd = dht_read_async(st, k)
            if device == "cuda":
                assert rnd.lanes.packs[0][1].is_pinned()
            dht_read_commit(rnd)
            dht_execute(st, mixed_ops(o, k, v), kinds=("read", "write"))
            # the card's own: its device spans, the timed host reads
            got[device] = ({k: v for k, v in
                            reg.snapshot()["counters"].items()
                            if k != "engine.host_syncs"}, [
                (e.source, e.ops, {s: x for s, x in e.stats.items()
                                   if s not in ("issue_us", "hidden_us",
                                                "commit_wait_us",
                                                "overlap_frac",
                                                "issue_wait_us")
                                   and not s.startswith("device_us.")})
                for e in obs.get_tracer().events()])
        finally:
            obs.metrics.set_registry(prev)
            obs.get_tracer().clear()
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][0]["engine.rounds"] == 3


def test_device_spans_of_a_round_on_card(gen):
    """A 95/5 round of 2^16 rows on the card records its five device
    spans (the write schedule's inside ``apply``), no more device time
    than the round's wall time, and one timed host read at each sync:
    the capacity plan, a write flag before each pass and after the last,
    the commit's wait."""
    from repro_torch import obs

    cfg = DHTConfig(n_shards=8, buckets_per_shard=1 << 14)
    n = 1 << 16
    keys, vals = _words(gen, n, 20), _words(gen, n, 26)
    op = (torch.rand(n, generator=gen) < 0.05).to(torch.int32).cuda()
    st = dht_create(cfg)
    st, _ = dht_write(st, keys, vals)
    torch.cuda.synchronize()
    reg = obs.metrics.MetricRegistry()
    prev = obs.metrics.set_registry(reg)
    obs.get_tracer().clear()
    try:
        es = dht_execute(st, mixed_ops(op, keys, vals),
                         kinds=("read", "write"))[-1]
        (ev,) = obs.get_tracer().events()
    finally:
        obs.metrics.set_registry(prev)
        obs.get_tracer().clear()
    dev = {s: ev.stats["device_us." + s] for s in obs.trace.DEVICE_SPANS}
    phases = ("bin", "dispatch", "apply", "collect")
    assert all(dev[s] > 0 for s in phases) and dev["write"] >= 0
    assert dev["write"] <= dev["apply"]
    assert sum(dev[s] for s in phases) <= ev.dur * 1e6
    passes = es["rounds"]
    assert passes >= 1
    assert reg.counter("engine.host_syncs") == 1 + (1 + passes) + 1
    hists = reg.snapshot()["histograms"]
    for s in obs.trace.DEVICE_SPANS:
        assert hists["engine.device_us." + s]["count"] == 1
    counts = {site: hists["engine.sync_wait_us." + site]["count"]
              for site in ("capacity", "write_flag", "commit")}
    assert counts == {"capacity": 1, "write_flag": 1 + passes, "commit": 1}
    assert ev.stats["issue_wait_us"] == pytest.approx(
        hists["engine.sync_wait_us.capacity"]["sum"]
        + hists["engine.sync_wait_us.write_flag"]["sum"])
