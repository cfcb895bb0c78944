"""The port's plain kernel versions (what the CPU path runs, and what each
CUDA kernel is held against on the card) against the JAX package's Pallas
kernels in interpret mode, bit for bit.  Same seeded numpy inputs on both
sides; words compared as uint32."""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

from repro.core import DHTConfig as JConfig
from repro.core import dht_create as j_create
from repro.core import dht_write as j_write
from repro.core.hashing import base_bucket as j_base_bucket
from repro.core.hashing import checksum32 as j_checksum32
from repro.core.hashing import hash64 as j_hash64
from repro.core.hashing import probe_indices as j_probe_indices
from repro.core.op_engine import _probe_window as j_probe_window
from repro.kernels.apply_kernel import shard_apply_pallas
from repro.kernels.checksum_kernel import checksum_pallas
from repro.kernels.hash_kernel import hash64_pallas
from repro.kernels.local_attn_kernel import local_attention_pallas
from repro.kernels.probe_kernel import probe_pallas
from repro.kernels.ref import ref_local_attention, ref_probe
from repro.kernels.round_kernel import round_sig_pallas
from repro.kernels.route_kernel import route_pack_pallas, route_unpack_pallas
from repro.kernels.stencil_kernel import stencil_keys_pallas
from repro_torch.kernels import local_attn_kernel, ops, ref


def _words(rng, n, w):
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    """uint32 numpy -> int32 bit-view torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u(t):
    """torch int32 bit-view -> uint32 numpy."""
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("n", [1, 7, 300])
@pytest.mark.parametrize("kw", [4, 20, 33])
def test_hash64_matches_pallas(n, kw):
    keys = _words(np.random.default_rng(n * 31 + kw), n, kw)
    expect = np.asarray(hash64_pallas(jnp.asarray(keys), interpret=True))
    np.testing.assert_array_equal(_u(ref.hash64(_t(keys))), expect)
    np.testing.assert_array_equal(_u(ops.hash64(_t(keys))), expect)


@pytest.mark.parametrize("n,rows,width", [(1, 16, 1), (80, 64, 22),
                                          (37, 96, 48), (50, 40, 28)])
def test_route_pack_matches_pallas(n, rows, width):
    """Fill rows (inv == -1), more rows than items and ragged widths."""
    rng = np.random.default_rng(rows + width)
    mat = _words(rng, n, width)
    inv = rng.integers(-1, n, size=rows).astype(np.int32)
    inv[:3] = -1
    fill = _words(rng, 1, width)[0]
    expect = np.asarray(route_pack_pallas(
        jnp.asarray(mat), jnp.asarray(inv), jnp.asarray(fill),
        interpret=True))
    out = ops.route_pack(_t(mat), torch.from_numpy(inv), _t(fill))
    np.testing.assert_array_equal(_u(out), expect)


@pytest.mark.parametrize("n,rows,width", [(1, 16, 1), (80, 64, 22),
                                          (61, 32, 28)])
def test_route_unpack_matches_pallas(n, rows, width):
    """Overflowed items (kept == 0) get the fill row."""
    rng = np.random.default_rng(rows * width)
    buf = _words(rng, rows, width)
    slot = rng.integers(0, rows, size=n).astype(np.int32)
    kept = rng.integers(0, 2, size=n).astype(np.int32)
    kept[0] = 0
    fill = _words(rng, 1, width)[0]
    expect = np.asarray(route_unpack_pallas(
        jnp.asarray(buf), jnp.asarray(slot), jnp.asarray(kept),
        jnp.asarray(fill), interpret=True))
    out = ops.route_unpack(_t(buf), torch.from_numpy(slot),
                           torch.from_numpy(kept), _t(fill))
    np.testing.assert_array_equal(_u(out), expect)


def _emulate_route_rows(index, n_out, width, align, blocks=None,
                        threads=256, rows_per_group=4):
    """``csrc/route.cu``'s row-group mapping, lane by lane: the vector width
    (16, 8 or 4 bytes, as ``width`` and the buffers' common alignment
    ``align`` in bytes allow), groups of G lanes owning ``rows_per_group``
    output rows each, lane u loading row u's index and the group sharing it
    by a width-G shuffle, chunks c = lane, lane + G, ... of each row, and
    the grid-stride loop over warps (``blocks`` of ``threads``; default the
    launcher's grid).  ``index`` maps output rows to source rows (-1: fill).
    Returns ``(vw, loads, writes, source)``: loads (n_out,) counts the
    index loads of each row, writes (n_out, width) the stores to each word,
    source holds the flat source word each one copied (-1 - w for fill
    word w)."""
    vw = next(v for v in (4, 2, 1) if width % v == 0 and align % (4 * v) == 0)
    nv = width // vw
    lg = 2
    while (1 << lg) < nv and lg < 5:
        lg += 1
    n_groups = -(-n_out // rows_per_group)
    if blocks is None:
        blocks = min(-(-(n_groups << lg) // threads), 1 << 20)
    warps, per_warp = blocks * (threads // 32), 32 >> lg
    lane = np.arange(32)
    gl = lane & ((1 << lg) - 1)
    loads = np.zeros(n_out, np.int64)
    writes = np.zeros((n_out, width), np.int64)
    source = np.full((n_out, width), -(1 << 40), np.int64)
    for warp in range(warps):
        for wg in range(warp * per_warp, n_groups, warps * per_warp):
            r0 = (wg + (lane >> lg)) * rows_per_group
            own = (gl < rows_per_group) & (r0 + gl < n_out)
            np.add.at(loads, (r0 + gl)[own], 1)
            mine = np.where(own, index(np.where(own, r0 + gl, 0)), -1)
            first = lane & ~((1 << lg) - 1)          # the group's lane 0
            frm = [mine[first + u] for u in range(rows_per_group)]
            for c in range(nv):
                at = gl == c % (1 << lg)             # lanes on chunk c
                for u in range(rows_per_group):
                    for ln in np.nonzero(at & (r0 + u < n_out))[0]:
                        row, cols = r0[ln] + u, np.arange(c * vw, c * vw + vw)
                        writes[row, cols] += 1
                        src = frm[u][ln]
                        source[row, cols] = (src * width + cols if src >= 0
                                             else -1 - cols)
    return vw, loads, writes, source


@pytest.mark.parametrize("width", [1, 2, 3, 22, 28, 48, 130])
@pytest.mark.parametrize("align,grid", [(16, None), (4, None), (16, 1)])
def test_route_unpack_row_groups_cover_once(width, align, grid):
    """The row-group kernel that route_unpack shares with route_pack
    writes every output word exactly once, with the widest vector the
    width and alignment allow, and the words ``ref.route_unpack`` gives
    (slot clamped into the buffer, fill where kept == 0); n is not a
    multiple of a group's rows, and ``grid`` = 1 block of 64 threads
    drives the grid-stride loop through several turns."""
    rng = np.random.default_rng(width * 10 + align)
    n, rows = 37, 29
    buf = _words(rng, rows, width)
    slot = rng.integers(-2, rows + 3, size=n).astype(np.int32)
    kept = rng.integers(0, 2, size=n).astype(np.int32)
    kept[:2] = 0
    fill = _words(rng, 1, width)[0]

    def index(r):
        s = np.clip(slot[r], 0, rows - 1)
        return np.where(kept[r] == 0, -1, s)

    vw, loads, writes, source = _emulate_route_rows(
        index, n, width, align, blocks=grid,
        threads=256 if grid is None else 64)
    assert vw == next(v for v in (4, 2, 1)
                      if width % v == 0 and align >= 4 * v)
    np.testing.assert_array_equal(loads, np.ones_like(loads))
    np.testing.assert_array_equal(writes, np.ones_like(writes))
    flat = np.concatenate([buf.reshape(-1), fill[::-1]])   # -1 - w -> fill[w]
    out = flat[np.where(source >= 0, source, flat.size + source)]
    expect = ref.route_unpack(_t(buf), torch.from_numpy(
        np.clip(slot, 0, rows - 1)), torch.from_numpy(kept), _t(fill))
    np.testing.assert_array_equal(out, _u(expect))


def _apply_case(n_probe, seed):
    """A one-shard slab written by the JAX package, then roughened: some
    buckets INVALID, some emptied, some checksums corrupted.  Queries mix
    stored keys and fresh keys; one window starts at B - n_probe."""
    rng = np.random.default_rng(seed)
    cfg = JConfig(n_shards=1, buckets_per_shard=128, n_probe=n_probe)
    keys = _words(rng, 96, cfg.key_words)
    vals = _words(rng, 96, cfg.val_words)
    st, _ = j_write(j_create(cfg), jnp.asarray(keys), jnp.asarray(vals))
    sk, sv = np.array(st.keys[0]), np.array(st.vals[0])
    sm, sc = np.array(st.meta[0]), np.array(st.csum[0])
    live = np.nonzero(sm & 1)[0]
    sm[live[0::7]] |= 2                       # INVALID
    sm[live[3::11]] = 0                       # emptied
    sc[live[5::9]] ^= 1                       # corrupted checksum
    q = np.concatenate([keys[:40], _words(rng, 16, cfg.key_words),
                        keys[40:48]])
    _, lo = j_hash64(jnp.asarray(q))
    base = np.array(j_base_bucket(lo, cfg.buckets_per_shard, n_probe))
    base[-1] = cfg.buckets_per_shard - n_probe
    return sk, sv, sm, sc, q, base


@pytest.mark.parametrize("n_probe,seed", [(6, 0), (6, 1), (1, 2), (4, 3)])
def test_shard_apply_matches_pallas_and_engine(n_probe, seed):
    sk, sv, sm, sc, q, base = _apply_case(n_probe, seed)
    j = [jnp.asarray(a) for a in (sk, sv, sm, sc, q, base)]
    v_p, f_p, w_p, k_p = shard_apply_pallas(*j, n_probe=n_probe,
                                            interpret=True)
    val, found, rsel, wsel, wkind = ops.shard_apply(
        _t(sk), _t(sv), _t(sm), _t(sc), _t(q), torch.from_numpy(base),
        n_probe)
    np.testing.assert_array_equal(_u(val), np.asarray(v_p))
    np.testing.assert_array_equal(found.numpy() == 1, np.asarray(f_p))
    np.testing.assert_array_equal(wsel.numpy(), np.asarray(w_p))
    np.testing.assert_array_equal(wkind.numpy(), np.asarray(k_p))

    # the extra outputs against the JAX engine's own probe: the selected
    # candidate, and "selected but checksum-failed" as found == -1
    idx = j_probe_indices(j[5], n_probe)
    win = {"keys": j[0][idx], "vals": j[1][idx], "meta": j[2][idx],
           "csum": j[3][idx]}
    has, sel, pval, stored = j_probe_window(win, j[4])
    ok = j_checksum32(j[4], pval) == stored
    tri = np.where(np.asarray(has), np.where(np.asarray(ok), 1, -1), 0)
    np.testing.assert_array_equal(found.numpy(), tri)
    np.testing.assert_array_equal(rsel.numpy(), np.asarray(sel))
    assert (tri == -1).any() and (tri == 1).any() and (tri == 0).any()


def test_shard_apply_checksum_reject_no_fallthrough():
    """A corrupted selected bucket reads as not-found (found == -1) even
    when a later candidate holds the same key with a valid checksum; the
    write lane still reports the same-key UPDATE slot."""
    from repro_torch.core.hashing import checksum32
    from repro_torch.core.op_engine import W_UPDATE

    rng = np.random.default_rng(5)
    kw, vw, b, p = 20, 26, 16, 6
    key = _words(rng, 1, kw)
    sk = np.zeros((b, kw), np.uint32)
    sv = _words(rng, b, vw)
    sm = np.zeros(b, np.uint32)
    sk[3] = sk[5] = key[0]
    sm[3] = sm[5] = 1 | (1 << 8)
    sc = _u(checksum32(_t(sk), _t(sv)))
    sc[3] ^= 1
    base = np.array([2], np.int32)
    args = [jnp.asarray(a) for a in (sk, sv, sm, sc, key, base)]
    v_p, f_p, w_p, k_p = shard_apply_pallas(*args, n_probe=p, interpret=True)
    val, found, rsel, wsel, wkind = ops.shard_apply(
        _t(sk), _t(sv), _t(sm), _t(sc), _t(key), torch.from_numpy(base), p)
    assert int(found[0]) == -1 and int(rsel[0]) == 1
    assert not bool(f_p[0])
    assert int(wsel[0]) == int(w_p[0]) == 1
    assert int(wkind[0]) == int(k_p[0]) == W_UPDATE
    np.testing.assert_array_equal(_u(val), np.asarray(v_p))



def _roughened_windows(rng, nb, kw, vw, n_probe, c):
    """A slab of ``nb`` rows drawn from six keys (so windows hold equal
    keys, some equal in every word but the last), with empty, INVALID and
    corrupted buckets, and ``c`` queries whose windows cover the edge
    cases: fully occupied by other keys, all empty, ending at the slab's
    last row, cut by the clamp at both ends, and query 4's window holding
    its key INVALID, then with a failing checksum, then valid (F6)."""
    from repro_torch.core.hashing import checksum32

    pool = _words(rng, 6, kw)
    sk = pool[rng.integers(0, 6, nb)]
    sk[rng.random(nb) < 0.15, -1] ^= 1                 # last word differs
    sv = _words(rng, nb, vw)
    sm = rng.choice(np.array([0, 1, 3, 2, 1 | (3 << 8)], np.uint32), nb,
                    p=[0.25, 0.4, 0.15, 0.05, 0.15])
    sk[:n_probe] = _words(rng, n_probe, kw)          # full of other keys
    sm[:n_probe] = 1
    sm[nb // 2:nb // 2 + n_probe] = 0                  # all empty
    f = nb // 4                 # F6: INVALID copy, failing copy, good copy
    sk[f:f + 3] = pool[0]
    sm[f:f + 3] = [3, 1, 1]
    good = _u(checksum32(_t(sk), _t(sv)))
    sc = good ^ (rng.random(nb) < 0.1).astype(np.uint32)
    sc[f + 1:f + 3] = good[f + 1:f + 3] ^ np.array([1, 0], np.uint32)
    q = pool[rng.integers(0, 6, c)]
    q[::5] = _words(rng, len(q[::5]), kw)
    q[4] = pool[0]
    base = rng.integers(-2, nb - n_probe + 3, c).astype(np.int32)
    base[:5] = [0, nb // 2, nb - n_probe, -3, f]
    return sk, sv, sm, sc, q, base


def _ffs(x):
    """__ffs(x) - 1 per element: the lowest set bit's index, -1 for 0."""
    low = x & (~x + np.uint64(1))
    return np.where(x == 0, -1,
                    np.log2(np.maximum(low, 1).astype(np.float64))).astype(
                        np.int64)


def _emulate_window(sk, sm, q, base, n_probe, kvec, probe=False, group=4):
    """The window steps of ``csrc/apply.cu`` (``probe=False``) and
    ``csrc/probe.cu``, lane by lane: warps of 32 lanes, a
    group of ``group`` lanes a query; per 32-candidate segment, ballot words
    of the meta bits, each lane's flat key chunks ``lane + group * t``
    (``kvec`` words each, stepped as the kernel steps them) for the
    candidates the kernel asks for (shard-apply: occupied; probe: live =
    occupied & ~INVALID), the shuffle-XOR OR of the not-equal bits, and
    __ffs picks.  The probe's groups stop asking after the segment with
    their hit, and a warp leaves the loop when none asks (``__any_sync``).
    Returns ``(rsel, wmatch, wfree)`` per query, -1 where none, and the
    meta words (C, n_probe) and key words (C, n_probe) each query loaded."""
    nb, kw = sk.shape
    c = q.shape[0]
    qpw, batch = 32 // group, 32 // group
    lane32 = np.arange(32)
    g, lane = lane32 // group, lane32 % group
    qi = np.arange(-(-c // qpw))[:, None] * qpw + g[None, :]     # (warps, 32)
    live = qi < c
    qi = np.minimum(qi, c - 1)
    b0 = np.where(live, base[qi].astype(np.int64), 0)
    u64 = np.uint64
    gshift = (g * group).astype(u64)
    kwc = kw // kvec
    rsel, wmatch, wfree = (np.full(qi.shape, -1) for _ in range(3))
    metas = np.zeros((c, n_probe), np.int64)
    kwords = np.zeros((c, n_probe), np.int64)
    for s0 in range(0, n_probe, 32):
        want = live & (rsel < 0) if probe else live
        if not want.any():                      # every warp left the loop
            break
        nseg = min(32, n_probe - s0)
        occ = np.zeros(qi.shape, u64)
        inv = np.zeros(qi.shape, u64)
        for u in range(32 // group):
            j = lane + group * u
            ask = want & (j < nseg)
            np.add.at(metas, (qi[ask], (s0 + j[None, :] + 0 * qi)[ask]), 1)
            m = np.where(ask, sm[np.clip(b0 + s0 + j, 0, nb - 1)],
                         0).astype(u64)
            for bit, acc in ((1, occ), (2, inv)):
                ballot = np.bitwise_or.reduce(
                    ((m & u64(bit)) != 0).astype(u64) << lane32.astype(u64),
                    axis=1)
                acc |= ((ballot[:, None] >> gshift) & u64((1 << group) - 1)
                        ) << u64(group * u)
        need = occ & ~inv if probe else occ
        neq = np.zeros(qi.shape, u64)
        nch = nseg * kwc
        for c0 in range(0, max(nch, 1), group * batch):
            start = c0 + lane                                  # (32,)
            j, w = start // max(kwc, 1), start % max(kwc, 1)
            for i in range(batch):
                ci = start + group * i
                ok = ci < nch
                jj = np.where(ok, j, 0)
                load = ok[None, :] & (((need >> jj.astype(u64)) & u64(1)) != 0)
                np.add.at(kwords, (qi[load], (s0 + jj[None, :] + 0 * qi)[load]),
                          kvec)
                rows = np.clip(b0 + s0 + jj, 0, nb - 1)
                cols = (np.where(ok, w, 0) * kvec)[:, None] + np.arange(kvec)
                differ = (sk[rows[..., None], cols[None, :, :]]
                          != q[qi[..., None], cols[None, :, :]]).any(-1)
                neq |= np.where(load & differ, u64(1) << jj.astype(u64), u64(0))
                w = w + group
                while (w >= kwc).any() and kwc:
                    j = np.where(w >= kwc, j + 1, j)
                    w = np.where(w >= kwc, w - kwc, w)
        o = 1
        while o < group:
            neq |= neq[:, lane32 ^ o]
            o <<= 1
        win = u64((1 << nseg) - 1)
        eq = occ & ~neq
        hit, vacant = eq & ~inv, (~occ | inv) & win
        for pick, mask in ((rsel, hit), (wmatch, eq), (wfree, vacant)):
            f = _ffs(mask)
            pick[:] = np.where((pick < 0) & (f >= 0), s0 + f, pick)
    picks = tuple(x[:, ::group].reshape(-1)[:c] for x in (rsel, wmatch, wfree))
    return picks, metas, kwords


@pytest.mark.parametrize("kw,vw,n_probe,kvec", [
    (20, 26, 6, 4), (20, 26, 6, 1), (7, 5, 4, 1), (4, 2, 1, 4),
    (20, 26, 40, 4), (23, 33, 6, 1)])
def test_shard_apply_mask_decision_matches_plain(kw, vw, n_probe, kvec):
    """The CUDA kernel's bit-mask decision (ballot words -> __ffs picks,
    16-byte or 4-byte key chunks, 32-candidate segments), emulated on a
    roughened slab with C not a multiple of a warp's queries, gives
    ``ref.shard_apply``'s rsel, wsel, wkind, found and value rows."""
    from repro_torch.core.hashing import checksum32
    from repro_torch.core.op_engine import W_EVICT, W_INSERT, W_UPDATE

    rng = np.random.default_rng(kw * 100 + n_probe + kvec)
    nb, c = 3 * n_probe + 40, 203
    sk, sv, sm, sc, q, base = _roughened_windows(rng, nb, kw, vw, n_probe, c)
    rsel, wmatch, wfree = _emulate_window(sk, sm, q, base, n_probe, kvec)[0]
    idx = np.clip(base.astype(np.int64) + np.maximum(rsel, 0), 0, nb - 1)
    ok = _u(checksum32(_t(q), _t(sv[idx]))) == sc[idx]
    found = np.where(rsel < 0, 0, np.where(ok, 1, -1))
    wsel = np.where(wmatch >= 0, wmatch,
                    np.where(wfree >= 0, wfree, n_probe - 1))
    wkind = np.where(wmatch >= 0, W_UPDATE,
                     np.where(wfree >= 0, W_INSERT, W_EVICT))
    vals = np.where((found == 1)[:, None], sv[idx], 0)
    r_val, r_found, r_rsel, r_wsel, r_wkind = ref.shard_apply(
        _t(sk), _t(sv), _t(sm), _t(sc), _t(q), torch.from_numpy(base),
        n_probe)
    np.testing.assert_array_equal(found, r_found.numpy())
    np.testing.assert_array_equal(np.maximum(rsel, 0), r_rsel.numpy())
    np.testing.assert_array_equal(wsel, r_wsel.numpy())
    np.testing.assert_array_equal(wkind, r_wkind.numpy())
    np.testing.assert_array_equal(vals, _u(r_val))
    # every branch of the decision occurs
    assert {-1, 0, 1} <= set(found.tolist())
    assert {W_UPDATE, W_INSERT, W_EVICT} <= set(wkind.tolist())


@pytest.mark.parametrize("kw,vw,n_probe,kvec,validate", [
    (20, 26, 6, 4, True), (20, 26, 40, 4, True), (20, 26, 1, 4, False),
    (20, 26, 4, 1, False), (7, 5, 4, 1, True), (23, 33, 40, 1, False)])
def test_probe_mask_decision_matches_plain(kw, vw, n_probe, kvec, validate):
    """The read-probe kernel's decision (``csrc/probe.cu``: ballot words ->
    live mask -> batched key chunks of the live candidates -> shuffle-OR ->
    __ffs per 32-candidate segment, stopping after the segment with the
    hit), emulated on a roughened slab (an INVALID copy of a key shadowing
    a key-equal one, a failing checksum, windows cut by the clamp at both
    ends, C not a multiple of a warp's queries), gives ``ref.probe``'s
    found, rsel and value rows, and the JAX oracle ``ref_probe``'s on the
    windows inside the slab.  Keys are loaded only for live candidates, and
    nothing after the segment of a query's hit."""
    from repro_torch.core.hashing import checksum32

    rng = np.random.default_rng(kw * 100 + n_probe + kvec + validate)
    nb, c = 3 * n_probe + 40, 203
    sk, sv, sm, sc, q, base = _roughened_windows(rng, nb, kw, vw, n_probe, c)
    (rsel, _wm, _wf), metas, kwords = _emulate_window(
        sk, sm, q, base, n_probe, kvec, probe=True)
    idx = np.clip(base.astype(np.int64) + np.maximum(rsel, 0), 0, nb - 1)
    found = (rsel >= 0).astype(np.int64)
    if validate:
        ok = _u(checksum32(_t(q), _t(sv[idx]))) == sc[idx]
        found = np.where(rsel < 0, 0, np.where(ok, 1, -1))
    vals = np.where((found == 1)[:, None], sv[idx], 0)
    r_val, r_found, r_rsel = ref.probe(
        _t(sk), _t(sv), _t(sm), _t(sc), _t(q), torch.from_numpy(base),
        n_probe, validate_checksum=validate)
    np.testing.assert_array_equal(found, r_found.numpy())
    np.testing.assert_array_equal(np.maximum(rsel, 0), r_rsel.numpy())
    np.testing.assert_array_equal(vals, _u(r_val))
    # the JAX package's oracle on the windows inside the slab (it wraps
    # negative indices), jitted: one compile instead of one an operation
    inside = (base >= 0) & (base + n_probe <= nb)
    o_val, o_has, o_slot = jax.jit(ref_probe, static_argnums=(6, 7))(
        *(jnp.asarray(a) for a in (sk, sv, sm, sc, q,
                                   np.clip(base, 0, nb - n_probe))),
        n_probe, validate)
    np.testing.assert_array_equal(vals[inside], np.asarray(o_val)[inside])
    np.testing.assert_array_equal((found == 1)[inside],
                                  np.asarray(o_has)[inside])
    np.testing.assert_array_equal(np.where(found == 1, base + rsel, -1)[inside],
                                  np.asarray(o_slot)[inside])
    # what the kernel loads: each candidate's meta word once up to the end
    # of the hit's segment (the whole window without a hit), and the key of
    # exactly the live ones among them
    cand = np.clip(base[:, None].astype(np.int64) + np.arange(n_probe), 0,
                   nb - 1)
    lv = ((sm[cand] & 1) != 0) & ((sm[cand] & 2) == 0)
    seg_end = np.where(rsel >= 0, (rsel // 32 + 1) * 32, n_probe)
    scanned = np.arange(n_probe)[None, :] < seg_end[:, None]
    np.testing.assert_array_equal(metas, scanned.astype(np.int64))
    np.testing.assert_array_equal(kwords, np.where(scanned & lv, kw, 0))
    if n_probe > 32:        # the stop skipped live candidates of segment 2
        assert (lv & ~scanned).any()
    assert set(found.tolist()) == ({-1, 0, 1} if validate else {0, 1})


@pytest.mark.parametrize("validate", [True, False])
@pytest.mark.parametrize("n_probe,seed", [(6, 0), (6, 1), (1, 2), (4, 3)])
def test_probe_matches_oracle_and_pallas(n_probe, seed, validate):
    """The plain read probe against the JAX oracle ``ref_probe`` and the
    Pallas kernel in interpret mode on a roughened slab (INVALID, emptied
    and corrupted buckets, a window at B - n_probe; no key twice in a
    window, so the Pallas kernel's fall-through never applies)."""
    sk, sv, sm, sc, q, base = _apply_case(n_probe, seed)
    j = [jnp.asarray(a) for a in (sk, sv, sm, sc, q, base)]
    o_val, o_has, o_slot = ref_probe(*j, n_probe, validate_checksum=validate)
    p_val, p_found = probe_pallas(*j, n_probe=n_probe,
                                  validate_checksum=validate, interpret=True)
    val, found, rsel = ops.probe(_t(sk), _t(sv), _t(sm), _t(sc), _t(q),
                                 torch.from_numpy(base), n_probe,
                                 validate_checksum=validate)
    assert val.dtype == found.dtype == rsel.dtype == torch.int32
    for v, f in ((o_val, o_has), (p_val, p_found)):
        np.testing.assert_array_equal(_u(val), np.asarray(v))
        np.testing.assert_array_equal(found.numpy() == 1, np.asarray(f))
    slot = np.where(found.numpy() == 1, base + rsel.numpy(), -1)
    np.testing.assert_array_equal(slot, np.asarray(o_slot))
    # the read lane of the shard-apply kernel is the validated probe
    ref_lane = ref.shard_apply(_t(sk), _t(sv), _t(sm), _t(sc), _t(q),
                               torch.from_numpy(base), n_probe)[:3]
    if validate:
        for a, b in zip((val, found, rsel), ref_lane):
            assert torch.equal(a, b)
        assert (found == -1).any()
    else:
        assert not (found == -1).any()
        assert int((found == 1).sum()) > int((ref_lane[1] == 1).sum())


def test_probe_checksum_reject_no_fallthrough():
    """The one documented difference from ``probe_pallas``: a window that
    holds the key twice, its first copy with a failed checksum.  The port
    (like the engine and ``ref_probe``) reports the selected candidate as
    failed (found == -1, not found); the Pallas kernel falls through to
    the second copy.  Without validation the first copy is served."""
    from repro_torch.core.hashing import checksum32

    rng = np.random.default_rng(5)
    kw, vw, b, p = 20, 26, 16, 6
    key = _words(rng, 1, kw)
    sk = np.zeros((b, kw), np.uint32)
    sv = _words(rng, b, vw)
    sm = np.zeros(b, np.uint32)
    sk[3] = sk[5] = key[0]
    sm[3] = sm[5] = 1 | (1 << 8)
    sm[2] = 1 | 2                                   # INVALID before them
    sk[2] = key[0]
    sc = _u(checksum32(_t(sk), _t(sv)))
    sc[3] ^= 1
    base = np.array([2], np.int32)
    args = [jnp.asarray(a) for a in (sk, sv, sm, sc, key, base)]
    p_val, p_found = probe_pallas(*args, n_probe=p, interpret=True)
    o_val, o_has, _ = ref_probe(*args, p)
    val, found, rsel = ops.probe(_t(sk), _t(sv), _t(sm), _t(sc), _t(key),
                                 torch.from_numpy(base), p)
    assert int(found[0]) == -1 and int(rsel[0]) == 1
    assert not bool(o_has[0]) and not val.any()
    assert bool(p_found[0])                                  # fell through
    np.testing.assert_array_equal(np.asarray(p_val)[0], sv[5])
    val, found, rsel = ops.probe(_t(sk), _t(sv), _t(sm), _t(sc), _t(key),
                                 torch.from_numpy(base), p,
                                 validate_checksum=False)
    assert int(found[0]) == 1 and int(rsel[0]) == 1
    np.testing.assert_array_equal(_u(val)[0], sv[3])


@pytest.mark.parametrize("n", [1, 7, 300])
@pytest.mark.parametrize("kw,vw", [(20, 26), (4, 1), (33, 17)])
def test_checksum_matches_pallas(n, kw, vw):
    rng = np.random.default_rng(n * 7 + kw + vw)
    keys, vals = _words(rng, n, kw), _words(rng, n, vw)
    expect = np.asarray(checksum_pallas(jnp.asarray(keys), jnp.asarray(vals),
                                        interpret=True))
    np.testing.assert_array_equal(_u(ref.checksum(_t(keys), _t(vals))),
                                  expect)
    # the write pass hands over row-strided views: slices of wider rows
    wide = _t(np.concatenate([keys, vals, _words(rng, n, 3)], axis=1))
    np.testing.assert_array_equal(
        _u(ops.checksum(wide[:, :kw], wide[:, kw:kw + vw])), expect)


def _decade_band():
    """Inputs within +-64 ulps of every power of ten, both signs."""
    p = np.array([np.float32(10.0 ** k) for k in range(-37, 38)], np.float32)
    band = (p.view(np.int32)[:, None] + np.arange(-64, 65)[None, :])
    band = band.astype(np.int32).view(np.float32).ravel()
    return np.concatenate([band, -band])


@pytest.mark.parametrize("sig", [3, 4])
def test_round_sig_matches_pallas(sig):
    """Bit for bit over 1e-30..1e30 outside the +-64-ulp band of each
    power of ten, with +-0, denormals, inf and nan; +0 for every zero and
    denormal.  Inside the band the F1 residue (ROADMAP.md) is pinned:
    6 of 19,350 words differ at sig 3, 2 at sig 4."""
    rng = np.random.default_rng(10 + sig)
    x = (10.0 ** rng.uniform(-30, 30, 30_000)
         * rng.choice([-1, 1], 30_000)).astype(np.float32)
    p = np.array([np.float32(10.0 ** k) for k in range(-37, 38)], np.float32)
    far = np.abs(np.abs(x).view(np.int32)[:, None]
                 - p.view(np.int32)[None, :]).min(axis=1) > 64
    edges = np.array([0.0, -0.0, 1e-40, -1e-45, -1e-39, np.inf, -np.inf,
                      np.nan, 1.0, -1.0], np.float32)
    x = np.concatenate([edges, x[far]]).reshape(-1, 10)
    expect = np.asarray(round_sig_pallas(jnp.asarray(x), sig, interpret=True))
    for out in (ref.round_sig(torch.from_numpy(x), sig),
                ops.round_sig(torch.from_numpy(x), sig)):
        assert out.shape == x.shape and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                      expect.view(np.uint32))
    assert (expect.view(np.uint32).ravel()[:5] == 0).all()     # +0

    band = _decade_band()
    a = np.asarray(round_sig_pallas(jnp.asarray(band), sig, interpret=True))
    b = ops.round_sig(torch.from_numpy(band), sig).numpy()
    assert int((a.view(np.uint32) != b.view(np.uint32)).sum()) == {
        3: 6, 4: 2}[sig]


# csrc/round.cu: kThreads, kVecs, kBlocksPerSm (the grid: SMs x blocks)
ROUND_THREADS, ROUND_VECS, ROUND_BLOCKS_PER_SM, SMS = 256, 4, 4, 132
CSRC = Path(ops.__file__).resolve().parent / "csrc"


def test_round_sig_shared_table_lookup_matches_plain():
    """csrc/round.cu's lookup: the 77 words its blocks copy into shared
    memory (siground.cuh's table) are the plain version's; for every
    exponent e, -45..45 (clamped to [-38, 38]), word idx = int(clamp(e)) +
    38 is pow10(e) and word 76 - idx is pow10(-e), bit for bit; a warp's
    lookup takes at most three bank passes (banks hold words b, b + 32,
    b + 64)."""
    from repro_torch.core.neighbors import _POW10_BITS, pow10

    text = (CSRC / "siground.cuh").read_text()
    body = text[text.index("kPow10Bits[77] = {"):]
    body = body[:body.index("};")]
    table = np.array([int(h, 16) for h in
                      re.findall(r"0x([0-9A-Fa-f]{8})u", body)], np.uint32)
    np.testing.assert_array_equal(table, np.array(_POW10_BITS, np.uint32))
    e = np.arange(-45, 46).astype(np.float32)
    idx = np.clip(e, -38, 38).astype(np.int64) + 38
    for got, want in ((table[idx], e), (table[76 - idx], -e)):
        np.testing.assert_array_equal(
            got, _u(pow10(torch.from_numpy(want)).view(torch.int32)))
    rng = np.random.default_rng(0)
    for _ in range(200):                      # warps of random exponents
        w = rng.integers(0, 77, size=32)
        passes = max(len(set(w[w % 32 == b])) for b in range(32))
        assert passes <= 3
    assert np.bincount(np.arange(77) % 32).max() == 3


def _round_split(n, offset):
    """Element coverage of csrc/round.cu's launch on n values starting
    ``offset`` words past a 16-byte boundary (the output, from
    ``empty_like``, is aligned): float4 vectors where both buffers are
    aligned, else 4-byte words; tiles of kThreads * kVecs vectors over a
    grid of at most SMs * kBlocksPerSm blocks, grid-stride; the first
    block's threads take the n % 4 tail.  Returns the count of each
    element's visits, indices past n counted at n."""
    width = 4 if offset == 0 else 1
    nv = n // width
    per_block = ROUND_THREADS * ROUND_VECS * width
    blocks = min(max(-(-n // per_block), 1), SMS * ROUND_BLOCKS_PER_SM)
    tile = ROUND_THREADS * ROUND_VECS
    lanes = (np.arange(ROUND_VECS)[:, None] * ROUND_THREADS
             + np.arange(ROUND_THREADS)[None, :]).ravel()
    seen = []
    for b in range(blocks):
        for t0 in range(b * tile, nv, blocks * tile):
            i = t0 + lanes
            i = i[i < nv]
            seen.append((i[:, None] * width + np.arange(width)).ravel())
    if width > 1:
        t = np.arange(ROUND_THREADS)
        seen.append(nv * width + t[t < n - nv * width])
    idx = np.concatenate(seen) if seen else np.zeros(0, np.int64)
    return np.bincount(np.minimum(idx, n), minlength=n + 1)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_round_sig_split_covers_every_value_once(offset):
    """csrc/round.cu's vector body, its n % 4 tail and its 4-byte path
    for inputs that start a word in (``x.reshape(-1)[1:]``) visit each of
    n values exactly once and nothing past them, for n = 0..9 and an n
    whose grid-stride loop turns more than once on both paths."""
    big = 2 * SMS * ROUND_BLOCKS_PER_SM * ROUND_THREADS * ROUND_VECS * 4 + 7
    for n in [*range(10), big]:
        counts = _round_split(n, offset)
        np.testing.assert_array_equal(counts[:n], np.ones(n, np.int64))
        assert counts[n] == 0


# csrc/l1.cu: kGroup, kSeg, kBatch, kQueries, kThreads, kCopy
L1_GROUP, L1_SEG, L1_BATCH = 4, 32, 4
L1_QUERIES, L1_THREADS, L1_COPY = 32, 128, 4


def _emulate_l1_decision(lkeys, flags, q, set_idx, key16):
    """csrc/l1.cu's step 2, group by group: lane w of a query's group
    loads the flag and first key chunk of ways w, w + 4, ... of the
    clamped set (a segment of 32 ways at a time), further chunks kBatch
    at a time only while equal; a ballot of the coherent key-equal ways
    and __ffs give the first.  Returns (way or -1, chunks loaded per
    (query, way))."""
    sets, ways, kw = lkeys.shape
    kk = 4 if key16 else 1                    # words a chunk
    kwc = kw // kk
    n = q.shape[0]
    s = np.clip(set_idx, 0, sets - 1)
    first = np.full(n, -1, np.int64)
    loaded = np.zeros((n, ways), np.int64)
    for i in range(n):
        qc = q[i].reshape(kwc, kk)
        for s0 in range(0, ways, L1_SEG):
            if first[i] >= 0:
                break
            nseg = min(ways - s0, L1_SEG)
            ok = 0
            for lane in range(L1_GROUP):
                for u in range(-(-nseg // L1_GROUP)):
                    j = lane + L1_GROUP * u
                    if j >= nseg:
                        continue
                    w = s0 + j
                    lc = lkeys[s[i], w].reshape(kwc, kk)
                    loaded[i, w] += min(kwc, 1)            # flag, head
                    eq = bool(flags[s[i], w]) and (
                        kwc == 0 or (lc[0] == qc[0]).all())
                    c0 = 1
                    while eq and c0 < kwc:                 # while equal
                        got = lc[c0:c0 + L1_BATCH]
                        loaded[i, w] += len(got)
                        eq = bool((got == qc[c0:c0 + L1_BATCH]).all())
                        c0 += L1_BATCH
                    ok |= int(eq) << j                     # ballot bit
            if ok:
                first[i] = s0 + (ok & -ok).bit_length() - 1  # __ffs - 1
    return first, loaded


def _l1_case(rng, sets, ways, n, kw, vw):
    """Lines, flags and queries: stored keys, foreign keys, keys equal to
    a line but for a word in the middle (the chunk compare's batches), a
    key in two ways of its set whose first is incoherent, and set
    indices before the first and past the last set (clamped)."""
    lkeys = _words(rng, sets * ways, kw).reshape(sets, ways, kw)
    lvals = _words(rng, sets * ways, vw).reshape(sets, ways, vw)
    flags = rng.integers(0, 2, size=(sets, ways)).astype(bool)
    set_idx = rng.integers(0, sets, size=n).astype(np.int32)
    way = rng.integers(0, ways, size=n)
    q = np.array(lkeys[set_idx, way])
    q[0::4] = _words(rng, len(range(0, n, 4)), kw)
    q[1::4, kw // 2] ^= 1
    flags[set_idx[2::4], way[2::4]] = True
    if ways > 1:
        s = set_idx[3]
        lkeys[s, 1] = lkeys[s, 0]
        q[3] = lkeys[s, 0]
        flags[s, 0], flags[s, 1] = False, True
    past = set_idx.copy()
    past[5::7] = sets + rng.integers(0, 3, size=len(range(5, n, 7)))
    past[6::11] = -1 - rng.integers(0, 3, size=len(range(6, n, 11)))
    return lkeys, lvals, flags, q, set_idx, past


@pytest.mark.parametrize("ways,kw,key16", [
    (1, 20, True), (4, 20, True), (8, 20, True), (8, 7, False),
    (4, 20, False), (40, 20, True)])
def test_l1_probe_group_decision_matches_plain(ways, kw, key16):
    """csrc/l1.cu's decision (flags and first chunks of a group's ways,
    ballot, __ffs; more ways than the group's four lanes at 8, and two
    32-way segments at 40) gives ``ref.l1_probe``'s hits and values on
    clamped set indices, and the JAX oracle's and the Pallas kernel's
    (interpret mode) on the queries whose sets are in range; a line's
    further key chunks are loaded only when it is coherent and its first
    chunk equal, and a hit's whole key is loaded."""
    from repro.kernels.l1_kernel import l1_probe_pallas
    from repro.kernels.ref import ref_l1_probe

    rng = np.random.default_rng(ways * 100 + kw + key16)
    sets, n, vw = 6, 40, 26
    lkeys, lvals, flags, q, set_idx, past = _l1_case(rng, sets, ways, n, kw,
                                                     vw)
    first, loaded = _emulate_l1_decision(lkeys, flags, q, past, key16)
    s = np.clip(past, 0, sets - 1)
    hit = first >= 0
    vals = np.where(hit[:, None], lvals[s, np.maximum(first, 0)], 0)
    r_hit, r_val = ref.l1_probe(_t(lkeys), _t(lvals), torch.from_numpy(flags),
                                _t(q), torch.from_numpy(s.astype(np.int32)))
    np.testing.assert_array_equal(hit, r_hit.numpy())
    np.testing.assert_array_equal(vals, _u(r_val))
    inside = (past >= 0) & (past < sets)
    assert not inside.all() and hit.any() and not hit.all()
    j = [jnp.asarray(a) for a in (lkeys, lvals, flags, q[inside],
                                  past[inside])]
    for o_hit, o_val in (ref_l1_probe(*j), l1_probe_pallas(*j,
                                                           interpret=True)):
        np.testing.assert_array_equal(hit[inside], np.asarray(o_hit))
        np.testing.assert_array_equal(vals[inside], np.asarray(o_val))
    if ways > 1:                  # the first way incoherent: the second
        assert first[3] == 1
    kk = 4 if key16 else 1
    lines = lkeys[s]                                     # (n, ways, kw)
    head_eq = (lines[:, :, :kk] == q[:, None, :kk]).all(-1) & flags[s]
    scanned = loaded > 0
    assert (loaded[scanned & ~head_eq] == 1).all()       # the head only
    assert (loaded[np.arange(n)[hit], first[hit]] == kw // kk).all()
    if kw // kk > 1 + L1_BATCH:                          # a later batch
        assert (loaded[scanned & head_eq] < kw // kk).any()


def _emulate_l1_copy(lvals, line, rows, vw, align):
    """csrc/l1.cu's step 3 for one block's tile of ``rows`` queries: the
    flat (rows, VW) output written as vectors of the widest width VW and
    the alignment allow, thread t taking vectors t, t + kThreads, ...
    (kCopy a turn), row = c // nv.  Returns (vector width, writes per
    word, tile)."""
    vv = next(v for v in (4, 2, 1) if vw % v == 0 and align % (4 * v) == 0)
    nv = vw // vv
    flat = lvals.reshape(-1)
    writes = np.zeros(rows * vw, np.int64)
    out = np.zeros(rows * vw, np.uint32)
    total = rows * nv
    for t in range(L1_THREADS):
        for c0 in range(t, total, L1_THREADS * L1_COPY):
            for u in range(L1_COPY):
                c = c0 + u * L1_THREADS
                if c >= total:
                    continue
                row = c // nv
                words = c * vv + np.arange(vv)
                writes[words] += 1
                if line[row] >= 0:
                    out[words] = flat[line[row] * vw + (c - row * nv) * vv
                                      + np.arange(vv)]
    return vv, writes, out.reshape(rows, vw)


@pytest.mark.parametrize("vw,align", [(25, 16), (26, 16), (28, 16),
                                      (28, 4), (26, 4)])
@pytest.mark.parametrize("rows", [L1_QUERIES, 5])
def test_l1_probe_tile_copy_covers_once(vw, align, rows):
    """csrc/l1.cu's tile copy writes each output word of a block's tile
    exactly once, with 16-byte vectors at VW 28, 8-byte at 26 and 4-byte
    at 25 or where the value rows are off alignment, and the words of
    each query's hit line (zeros for a miss), for a full tile and the
    ragged last one."""
    rng = np.random.default_rng(vw * 10 + align + rows)
    lvals = _words(rng, 24, vw)
    line = rng.integers(-1, 24, size=rows)
    line[:2] = -1
    vv, writes, out = _emulate_l1_copy(lvals, line, rows, vw, align)
    assert vv == {(25, 16): 1, (26, 16): 2, (28, 16): 4, (28, 4): 1,
                  (26, 4): 1}[(vw, align)]
    np.testing.assert_array_equal(writes, np.ones(rows * vw, np.int64))
    np.testing.assert_array_equal(
        out, np.where(line[:, None] >= 0, lvals[np.maximum(line, 0)], 0))


def test_pow10_table_copied_once_per_device():
    """The plain rounding copies the pow10 table to a device once, and
    later calls index that copy (on the card: no host-to-device copy in
    ``lattice_step``); the bits are the table's."""
    from repro_torch.core import neighbors

    e = torch.arange(-40.0, 41.0)
    a = neighbors.pow10(e)
    table = neighbors._pow10_table(e.device)
    b = neighbors.pow10(e * 0 + 3)
    assert neighbors._pow10_table(e.device) is table
    np.testing.assert_array_equal(
        _u(a.view(torch.int32)),
        np.array(neighbors._POW10_BITS, np.uint32)[
            np.clip(np.arange(-40, 41), -38, 38) + 38])
    assert bool((b == 1000.0).all())


@pytest.mark.parametrize("radius,coarse,d,key_words", [
    (1, True, 10, 20), (1, False, 4, 9), (2, True, 4, 7), (2, False, 3, 12)])
def test_stencil_keys_matches_pallas(radius, coarse, d, key_words):
    """Keys bit for bit (no input near a power of ten), and each key's
    window base wherever the keys agree.  D = 10, KW = 20 is POET's
    shape; the others cover radius 2, no coarse tier, an odd key width,
    padding words and a key cut short of 2 * D words."""
    rng = np.random.default_rng(radius * 2 + coarse)
    x = (10.0 ** rng.uniform(-3, 3, size=(13, d))
         * rng.choice([-1, 1], size=(13, d))).astype(np.float32)
    x[0, :3] = [9.99, 0.0999, -0.0]
    kw = dict(radius=radius, coarse_tier=coarse, n_buckets=4096, n_probe=6)
    jk, jb = stencil_keys_pallas(jnp.asarray(x), 3, key_words,
                                 interpret=True, **kw)
    for tk, tb in (ref.stencil_keys(torch.from_numpy(x), 3, key_words, **kw),
                   ops.stencil_keys(torch.from_numpy(x), 3, key_words, **kw)):
        m = 1 + 2 * radius * d + coarse
        assert tk.shape == (13, m, key_words) and tb.shape == (13, m)
        np.testing.assert_array_equal(_u(tk), np.asarray(jk))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        assert 0 <= int(tb.min()) and int(tb.max()) <= 4096 - 6


_M32 = np.uint64(0xFFFFFFFF)


def _rotl(x, r):
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _M32


def _premix(k):
    """murmur.cuh's murmur_premix on uint64-held uint32 words."""
    k = (k * np.uint64(0xCC9E2D51)) & _M32
    return (_rotl(k, 15) * np.uint64(0x1B873593)) & _M32


def _mix(h, km):
    """murmur.cuh's murmur_mix: fold a premixed word into the chain."""
    h = _rotl(h ^ km, 13)
    return (h * np.uint64(5) + np.uint64(0xE6546B64)) & _M32


def _finish(h, n_words):
    h = h ^ np.uint64(4 * n_words)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & _M32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & _M32
    return h ^ (h >> np.uint64(16))


def _emulate_hash64(keys, aligned=True):
    """csrc/hash.cu: where KW % 4 == 0 and the rows are aligned, each row
    arrives as KW / 4 16-byte chunks, all loaded before the chains, every
    word premixed first, then the hi and lo chains step interleaved;
    otherwise word by word from 4-byte loads."""
    n, kw = keys.shape
    k = keys.astype(np.uint64)
    if aligned and kw % 4 == 0:
        chunks = [k[:, 4 * c:4 * c + 4] for c in range(kw // 4)]
        words = np.concatenate(chunks, axis=1)      # the registers
    else:
        words = k
    pre = _premix(words)
    hi = np.full(n, 0x9E3779B9, np.uint64)
    lo = np.full(n, 0x85EBCA77, np.uint64)
    for i in range(kw):
        hi = _mix(hi, pre[:, i])
        lo = _mix(lo, pre[:, i])
    return np.stack([_finish(hi, kw), _finish(lo, kw)], -1).astype(np.uint32)


@pytest.mark.parametrize("kw", range(1, 41))
def test_hash64_premixed_chains_match_plain(kw):
    """The kernel's premix-then-chain order and its 16-byte chunking (KW %
    4 == 0), and the 4-byte path, against ref.hash64 and the Pallas
    kernel, N off the kernels' blocks."""
    keys = _words(np.random.default_rng(700 + kw), 37, kw)
    expect = np.asarray(hash64_pallas(jnp.asarray(keys), interpret=True))
    np.testing.assert_array_equal(_u(ref.hash64(_t(keys))), expect)
    for aligned in (True, False):
        np.testing.assert_array_equal(_emulate_hash64(keys, aligned), expect)


def _entry_dim(e, d, m, coarse):
    """csrc/stencil.cu's entry_dim: entry e's (dim, offset) in closed
    form (-1 the centre, -2 the coarse tier)."""
    if e == 0:
        return -1, 0
    if coarse and e == m - 1:
        return -2, 0
    j = e - 1
    r = j // (2 * d) + 1
    rem = j - (r - 1) * 2 * d
    return rem >> 1, (-r if rem & 1 else r)


@pytest.mark.parametrize("coarse", [True, False])
@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_stencil_entry_closed_form_matches_offsets(radius, coarse):
    """The kernel's entry -> (dim, off) map is the enumeration of both
    packages' stencil_offsets, for D 1..12."""
    from repro.core.neighbors import stencil_offsets as j_offsets
    from repro_torch.core.neighbors import n_stencil, stencil_offsets

    for d in range(1, 13):
        m = n_stencil(d, radius, coarse)
        got = [_entry_dim(e, d, m, coarse) for e in range(m)]
        assert got == stencil_offsets(d, radius, coarse), (d, radius)
        assert got == j_offsets(d, radius, coarse), (d, radius)


def _emulate_stencil(x, sig, kw, radius, coarse, n_buckets, n_probe,
                     misalign=0):
    """csrc/stencil.cu's decomposition: per row, once, the centre c, its
    re-rounding rr, the coarse value and the lattice step of the first Dk
    = min(D, ceil(KW / 2)) coordinates; per entry only the shifted
    coordinate is rounded; the lo chain skips the premix of zero words;
    the keys of up to 32 entries are stored as one run of 16-byte chunks
    between 4-byte ends (all 4-byte where the output sits ``misalign``
    words off 16-byte alignment).  Checks every output word is stored
    once; returns (keys, base) as numpy uint32 / int32."""
    from repro_torch.core.neighbors import lattice_step, round_significant

    n, d = x.shape
    m = 1 + 2 * radius * d + int(coarse)
    dk = min(d, (kw + 1) // 2)
    xt = torch.from_numpy(x[:, :dk])
    c = round_significant(xt, sig)
    per_row = {-1: c, -2: round_significant(round_significant(c, sig - 1),
                                            sig)}
    rr = round_significant(c, sig)
    step = lattice_step(c, sig)
    bits = {k: v.numpy().view(np.uint32) for k, v in per_row.items()}
    rr_bits = rr.numpy().view(np.uint32)
    entry = np.zeros((n, m, dk), np.uint32)
    dims = []
    for e in range(m):
        dim, off = _entry_dim(e, d, m, coarse)
        dims.append(dim)
        entry[:, e] = bits[dim] if dim < 0 else rr_bits
        if 0 <= dim < dk:
            shifted = round_significant(c[:, dim] + off * step[:, dim], sig)
            entry[:, e, dim] = shifted.numpy().view(np.uint32)
    span = max(n_buckets - n_probe + 1, 1)
    h = np.full((n, m), 0x85EBCA77, np.uint64)
    for k in range(dk):
        h = _mix(h, _premix(entry[:, :, k].astype(np.uint64)))
        if 2 * k + 1 < kw:
            h = _mix(h, np.uint64(0))
    for _ in range(2 * dk, kw):
        h = _mix(h, np.uint64(0))
    base = (_finish(h, kw) % np.uint64(span)).astype(np.int32)

    # every word of the output from (row, entry, j), as key_word builds it
    t = np.arange(n * m * kw)
    row, rest = np.divmod(t, m * kw)
    el, j = np.divmod(rest, kw)
    k = np.minimum(j >> 1, max(dk - 1, 0))
    value = entry[row, el, k] if dk else np.zeros(t.size, np.uint32)
    words = np.where((j & 1) | (j >> 1 >= dk), np.uint32(0), value)
    # which words each 32-entry run's stores cover
    stored = np.zeros(n * m * kw + misalign, np.int64)
    for r in range(n):
        for e0 in range(0, m, 32):
            w0 = misalign + (r * m + e0) * kw
            w1 = misalign + (r * m + min(m, e0 + 32)) * kw
            a = b = w1
            if misalign == 0:
                a = min(w1, (w0 + 3) & ~3)
                b = max(a, w1 & ~3)
            stored[w0:a] += 1                        # 4-byte head
            stored[b:w1] += 1                        # 4-byte tail
            assert a % 4 == 0 and (b - a) % 4 == 0 or misalign
            stored[a:b] += 1                         # 16-byte chunks
    assert (stored[misalign:] == 1).all()
    return words.reshape(n, m, kw), base


@pytest.mark.parametrize("kw,d,radius,coarse,pallas", [
    (7, 10, 1, True, True), (20, 10, 1, True, True),
    (23, 3, 3, False, True), (20, 17, 1, True, False)])
def test_stencil_row_shared_work_matches_plain(kw, d, radius, coarse, pallas):
    """The per-row shared work, the closed-form entries, the chain and the
    16-byte runs (aligned and one word off) against ref.stencil_keys on
    seeded inputs with 0, -0, a denormal, +-inf, nan and values within 64
    ulps of powers of ten, and against the Pallas kernel away from that
    band (F1): KW below 2D (truncated), equal to it and above it (zero
    padding); D = 17 against the plain version only (the Pallas kernel
    takes ~9 s to interpret it)."""
    rng = np.random.default_rng(31 * kw + d)
    x = (10.0 ** rng.uniform(-3, 3, size=(5, d))
         * rng.choice([-1, 1], size=(5, d))).astype(np.float32)
    x.reshape(-1)[:9] = [0.0, -0.0, 1e-40, np.inf, -np.inf, np.nan, 9.99,
                         0.0999, 1.0]
    band = _decade_band()
    near = band[rng.integers(0, band.size, size=(3, d))]
    args = (3, kw, radius, coarse, 4096, 6)
    for rows in (x, np.concatenate([x, near])):
        tk, tb = ref.stencil_keys(torch.from_numpy(rows), *args)
        for misalign in (0, 1):
            ek, eb = _emulate_stencil(rows, *args, misalign=misalign)
            np.testing.assert_array_equal(ek, _u(tk))
            np.testing.assert_array_equal(eb, tb.numpy())
    if not pallas:
        return
    jk, jb = stencil_keys_pallas(jnp.asarray(x), 3, kw, interpret=True,
                                 radius=radius, coarse_tier=coarse,
                                 n_buckets=4096, n_probe=6)
    ek, eb = _emulate_stencil(x, *args)
    np.testing.assert_array_equal(ek, np.asarray(jk))
    np.testing.assert_array_equal(eb, np.asarray(jb))


def test_library_name_covers_every_shared_header(tmp_path, monkeypatch):
    """A change to any ``csrc/*.cuh`` renames every library, so a build
    made against the old header is never loaded."""
    import shutil

    from repro_torch.kernels import build

    for f in build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {name: build._lib_path(name) for name in build.LIBRARIES}
    assert len(set(before.values())) == len(before)
    for header in ("siground.cuh", "murmur.cuh"):
        with open(tmp_path / header, "a") as f:
            f.write("\n// edited\n")
        after = {name: build._lib_path(name) for name in build.LIBRARIES}
        assert all(after[n] != before[n] for n in before), header
        before = after


def _attn_inputs(b, s, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32),
            rng.standard_normal((b, s, hk, d)).astype(np.float32))


def _per_head(x, g):
    """(B, S, Hx, D) -> (B * Hx * g, S, D), each head repeated g times:
    the reference kernel's (BH, S, D) layout with K/V expanded."""
    x = np.repeat(x, g, axis=2)
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


@pytest.mark.parametrize("b,s,h,hk,d,w,bq,bk", [
    # the four shapes of tests/test_kernels.py, one head per batch row
    (2, 256, 1, 1, 32, 64, 64, 32), (1, 512, 1, 1, 16, 128, 128, 64),
    (3, 128, 1, 1, 64, 128, 64, 64), (1, 128, 1, 1, 8, 32, 32, 32),
    # grouped KV heads (G = 2), as gemma3's local layers
    (2, 128, 4, 2, 16, 32, 32, 32)])
def test_local_attention_matches_pallas(b, s, h, hk, d, w, bq, bk):
    """The plain version (the CPU path of every local layer) against the
    Pallas kernel in interpret mode and against ``ref_local_attention``,
    at atol 2e-5 (float32 on both sides, sums in another order)."""
    q, k, v = _attn_inputs(b, s, h, hk, d, seed=b * s + h)
    g = h // hk
    jq, jk, jv = _per_head(q, 1), _per_head(k, g), _per_head(v, g)
    pallas = np.asarray(local_attention_pallas(jq, jk, jv, window=w, bq=bq,
                                               bk=bk, interpret=True))
    oracle = np.asarray(ref_local_attention(jq, jk, jv, window=w))
    for out in (ref.local_attention(*map(torch.from_numpy, (q, k, v)), w),
                ops.local_attention(*map(torch.from_numpy, (q, k, v)), window=w)):
        assert out.shape == (b, s, h, d) and out.dtype == torch.float32
        got = out.numpy().transpose(0, 2, 1, 3).reshape(b * h, s, d)
        np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,w,h,hk", [(45, 16, 2, 1), (40, 7, 2, 2),
                                      (20, 64, 4, 2), (33, 1, 2, 1),
                                      (1, 8, 2, 2)])
def test_local_attention_edge_shapes_match_oracle(s, w, h, hk):
    """Shapes the Pallas kernel refuses (ragged S, window below a tile,
    window >= S, window 1, S = 1), through the (BH, S, D) view of the
    oracle's layout where G = 1."""
    q, k, v = _attn_inputs(2, s, h, hk, 16, seed=s * 7 + w)
    g = h // hk
    oracle = np.asarray(ref_local_attention(_per_head(q, 1), _per_head(k, g),
                                            _per_head(v, g), window=w))
    out = ops.local_attention(*map(torch.from_numpy, (q, k, v)), window=w)
    got = out.numpy().transpose(0, 2, 1, 3).reshape(2 * h, s, 16)
    np.testing.assert_allclose(got, oracle, atol=2e-5, rtol=2e-5)
    if g == 1:   # the oracle's own layout as a strided (BH, S, 1, D) view
        flat = [torch.from_numpy(x.transpose(0, 2, 1, 3).reshape(2 * h, s, 16))
                for x in (q, k, v)]
        view = ops.local_attention(*(x[:, :, None] for x in flat), window=w)
        np.testing.assert_allclose(view[:, :, 0].numpy(), oracle, atol=2e-5,
                                   rtol=2e-5)


def test_local_attention_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple"):
        ops.local_attention(q, kv, kv, window=4)
    with pytest.raises(ValueError, match="window"):
        ops.local_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="type"):
        ops.local_attention(q, q.double(), q, window=4)
    with pytest.raises(ValueError, match="B, S or D"):
        ops.local_attention(q, q[:, :4], q[:, :4], window=4)


BF16_BQ, BF16_BK = 128, 64     # csrc/local_attn.cu: kBfBQ, kBfBK


def _emulate_bf16_kernel(q, k, v, window):
    """The bf16 tensor-core kernel's arithmetic on the CPU: per 128-row
    query tile, the band's keys in tiles of 64 with an online softmax;
    q.k in float32 from the bf16 inputs, P split into bf16 hi + lo and
    both products with V summed in float32; the end divides by
    max(l, 1e-30) and rounds to bf16.  (The kernel's exp2 is the MUFU
    approximation, ~2^-22 relative, far below the bf16 output's ulp.)"""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)                          # (B, H, S, D)
    kf, vf = (x.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
              for x in (k, v))
    out = torch.empty((b, h, s, d))
    for q0 in range(0, s, BF16_BQ):
        rows = torch.arange(q0, min(s, q0 + BF16_BQ))
        m = torch.full((b, h, len(rows)), -1e30)
        l = torch.zeros((b, h, len(rows)))
        acc = torch.zeros((b, h, len(rows), d))
        k_hi = min(s, q0 + BF16_BQ)
        for t0 in range(max(0, q0 - window + 1), k_hi, BF16_BK):
            keys = torch.arange(t0, min(k_hi, t0 + BF16_BK))
            sc = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2) / math.sqrt(d)
            valid = ((keys[None, :] <= rows[:, None])
                     & (rows[:, None] - keys[None, :] < window))
            sc = torch.where(valid, sc, torch.tensor(-1e30))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(valid, torch.exp(sc - m_new[..., None]),
                            torch.tensor(0.0))
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float()
            l = l * alpha + p.sum(dim=-1)
            acc = (acc * alpha[..., None] + hi @ vf[:, :, keys]
                   + lo @ vf[:, :, keys])
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _bf16_inputs(b, s, h, hk, d, seed):
    return tuple(torch.from_numpy(x).to(torch.bfloat16)
                 for x in _attn_inputs(b, s, h, hk, d, seed))


@pytest.mark.parametrize("s,w,h,hk,pallas_blocks", [
    (288, 64, 4, 2, (96, 32)),    # D = 256, G = 2, three query tiles
    (300, 20, 4, 2, (100, 20)),   # window below the 64-key tile
    (300, 1, 4, 2, None),         # window 1
    (300, 65, 2, 1, None)])       # window one above the key tile
def test_bf16_kernel_arithmetic_within_tolerance(s, w, h, hk, pallas_blocks):
    """The bf16 kernel's tile-by-tile arithmetic (split P, float32 sums),
    emulated on the CPU, against the plain version within the unchanged
    ``local_attn_kernel.tolerance`` (one bf16 ulp at the output's scale),
    and against ``local_attention_pallas`` in interpret mode where its
    shape rules allow (S a multiple of bq, window of bk)."""
    q, k, v = _bf16_inputs(1, s, h, hk, 256, seed=s + w)
    got = _emulate_bf16_kernel(q, k, v, w)
    plain = ref.local_attention(q, k, v, w)
    tol = local_attn_kernel.tolerance(plain)
    assert got.dtype == torch.bfloat16 and got.shape == plain.shape
    assert float((got.float() - plain.float()).abs().max()) <= tol
    if pallas_blocks is not None:
        bq, bk = pallas_blocks
        g = h // hk
        jq, jk, jv = (_per_head(x.float().numpy(), r).astype(jnp.bfloat16)
                      for x, r in ((q, 1), (k, g), (v, g)))
        pallas = np.asarray(local_attention_pallas(
            jq, jk, jv, window=w, bq=bq, bk=bk, interpret=True))
        pallas = torch.from_numpy(pallas.astype(np.float32)).reshape(
            1, h, s, 256).permute(0, 2, 1, 3)
        assert float((got.float() - pallas).abs().max()) <= tol


def _emulate_bwd_kernel(q, k, v, o, dout, window, lse):
    """The backward kernel's tile recurrence (``csrc/local_attn_bwd.cu``)
    in float32, from the forward's ``lse`` (B, H, S): the dq kernel per 64
    query rows (delta from the stored output, one walk over the band's key
    tiles for P, dP, dS and dQ), then the dkv kernel over the G query
    heads and their query tiles, from lse and the first kernel's delta,
    the heads summed into one accumulator.  In bf16 at D >= 64 (the wgmma
    path) every tile is 64 rows (64-key tiles in the dq kernel, 64 keys by
    64-row query tiles in the dkv kernel) and P and dS enter their
    products rounded once to bf16; otherwise (CUDA cores, float32 sums of
    float32 values) 32-key tiles, and 32 keys by 64-row query tiles."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    wg = q.dtype == torch.bfloat16 and d >= 64
    kt, kb, qt = (64, 64, 64) if wg else (32, 32, 64)

    def operand(x):
        return x.to(torch.bfloat16).float() if wg else x
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, dout))
    sq = math.sqrt(d)
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    delta = torch.zeros((b, h, s))

    def band(rows, keys):
        return ((keys[None, :] <= rows[:, None])
                & (rows[:, None] - keys[None, :] < window))

    for bi in range(b):
        for hi in range(h):
            kh = hi // g
            for q0 in range(0, s, 64):
                rows = torch.arange(q0, min(q0 + 64, s))
                qq, gg = qf[bi, rows, hi], gf[bi, rows, hi]
                dl = (gg * of[bi, rows, hi]).sum(-1)
                lrow = lse[bi, hi, rows]
                k_lo, k_hi = max(0, q0 - window + 1), min(s, q0 + 64)
                acc = torch.zeros((len(rows), d))
                for t0 in range(k_lo, k_hi, kt):
                    keys = torch.arange(t0, min(t0 + kt, k_hi))
                    ok = band(rows, keys)
                    kk, vv = kf[bi, keys, kh], vf[bi, keys, kh]
                    p = torch.where(ok, torch.exp(qq @ kk.T / sq - lrow[:, None]),
                                    0.0)
                    acc += operand(p * (gg @ vv.T - dl[:, None])) @ kk
                dq[bi, rows, hi] = acc / sq
                delta[bi, hi, rows] = dl
    for bi in range(b):
        for kh in range(hk):
            for k0 in range(0, s, kb):
                keys = torch.arange(k0, min(k0 + kb, s))
                kk, vv = kf[bi, keys, kh], vf[bi, keys, kh]
                q_hi = min(s, k0 + kb + window - 1)
                acc_k = torch.zeros((len(keys), d))
                acc_v = torch.zeros((len(keys), d))
                for hi in range(kh * g, kh * g + g):
                    for t0 in range(k0, q_hi, qt):
                        rows = torch.arange(t0, min(t0 + qt, s))
                        qq, gg = qf[bi, rows, hi], gf[bi, rows, hi]
                        ok = band(rows, keys).T
                        pt = torch.where(ok, torch.exp(
                            kk @ qq.T / sq - lse[bi, hi, rows][None, :]), 0.0)
                        dst = pt * (vv @ gg.T - delta[bi, hi, rows][None, :])
                        acc_v += operand(pt) @ gg
                        acc_k += operand(dst) @ qq
                dk[bi, keys, kh], dv[bi, keys, kh] = acc_k / sq, acc_v
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,w,h,hk,d", [
    (200, 40, 4, 2, 32),     # G = 2, several query and key tiles
    (150, 1000, 2, 1, 16),   # window >= S
    (130, 1, 2, 2, 64),      # window 1, S past the 64-row tiles
    (96, 33, 2, 1, 256),     # gemma3's head dim, window one above a tile
    (96, 65, 2, 1, 256),     # one key past a 64-key tile
    (160, 70, 10, 1, 128)])  # recurrentgemma's G = 10, three key blocks
def test_bwd_kernel_arithmetic_within_tolerance(dtype, s, w, h, hk, d):
    """The backward kernel's arithmetic, emulated tile by tile on the CPU
    from the plain forward's output and lse, against autograd through the
    plain version (``ref.local_attention_bwd``) within
    ``local_attn_kernel.bwd_tolerance``: 1e-5 of each gradient's own
    largest magnitude, and in bfloat16 at least one bf16 ulp there."""
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _attn_inputs(2, s, h, hk, d, seed=s + w))
    dout = torch.from_numpy(np.random.default_rng(w).standard_normal(
        (2, s, h, d)).astype(np.float32)).to(dtype)
    out = ref.local_attention(q, k, v, w)
    lse = ref.local_attention_lse(q, k, v, w)
    got = _emulate_bwd_kernel(q, k, v, out, dout, w, lse)
    plain = ref.local_attention_bwd(q, k, v, out, dout, w, lse)
    tols = local_attn_kernel.bwd_tolerance(plain)
    for name, x, y, tol in zip(("dq", "dk", "dv"), got, plain, tols):
        assert x.dtype == dtype and x.shape == y.shape, name
        err = float((x.float() - y.float()).abs().max())
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("s,w,h,hk,d", [(45, 16, 2, 1, 16), (130, 65, 4, 2, 64),
                                        (33, 1, 2, 2, 32), (20, 64, 2, 1, 8)])
def test_local_attention_lse_matches_logsumexp(s, w, h, hk, d):
    """The plain lse (the forward kernel's second output, the backward's
    input) against ``torch.logsumexp`` of the masked, scaled scores, the
    masked keys at -inf, at atol 1e-5 (float32 on both sides)."""
    q, k, v = map(torch.from_numpy, _attn_inputs(2, s, h, hk, d, seed=s + w))
    got = ref.local_attention_lse(q, k, v, w)
    kf = k.repeat_interleave(h // hk, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kf) / math.sqrt(d)
    i = torch.arange(s)
    band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < w)
    want = torch.logsumexp(scores.masked_fill(~band, float("-inf")), dim=-1)
    assert got.dtype == torch.float32 and got.shape == (2, h, s)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
