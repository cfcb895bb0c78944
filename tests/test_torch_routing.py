"""Routing parity: the port's binning, capacity planning, wire accounting
and fused dispatch/collect against the JAX package on seeded uniform and
Zipf batches.  Every position, mask, count and word compared exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

from repro.core import routing as jr
from repro_torch.core import routing as tr
from repro_torch.obs import counting


def _dest(kind, n, s, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, s, size=n).astype(np.int32)
    return ((rng.zipf(1.1, size=n) - 1) % s).astype(np.int32)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


CASES = [("uniform", 1000, 8), ("zipf", 1000, 8), ("uniform", 257, 3),
         ("zipf", 4096, 64)]


@pytest.mark.parametrize("kind,n,s", CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_bin_by_dest_matches_reference(kind, n, s, masked):
    dest = _dest(kind, n, s, seed=n + s)
    valid = (np.random.default_rng(1).random(n) > 0.2) if masked else None
    cap = tr.plan_capacity(torch.from_numpy(dest), s,
                           valid=None if valid is None
                           else torch.from_numpy(valid))
    assert cap == jr.plan_capacity(jnp.asarray(dest), s, valid=valid)
    for c in (cap, max(cap // 2, 1)):           # tight, then overflowing
        jv = None if valid is None else jnp.asarray(valid)
        tv = None if valid is None else torch.from_numpy(valid)
        jb = jr.bin_by_dest(jnp.asarray(dest), s, c, valid=jv)
        tb = tr.bin_by_dest(torch.from_numpy(dest), s, c, valid=tv)
        ob = tr.bin_by_dest_onehot(torch.from_numpy(dest), s, c, valid=tv)
        for name in ("pos", "kept", "dest", "n_dropped"):
            np.testing.assert_array_equal(_np(getattr(tb, name)),
                                          np.asarray(getattr(jb, name)), name)
            np.testing.assert_array_equal(_np(getattr(ob, name)),
                                          _np(getattr(tb, name)), name)
        np.testing.assert_array_equal(_np(tr.bin_counts(tb)),
                                      np.asarray(jr.bin_counts(jb)))
        jw = jr.wire_stats(jb, 22, 28, prologue_words=2 * s)
        tw = tr.wire_stats(tb, 22, 28, prologue_words=2 * s)
        for k in jw:
            np.testing.assert_array_equal(_np(tw[k]), np.asarray(jw[k]), k)


@pytest.mark.parametrize("n_src", [1, 4])
def test_plan_capacity_multi_source(n_src):
    dest = _dest("zipf", 1024, 16, seed=3)
    assert (tr.plan_capacity(torch.from_numpy(dest), 16, n_src=n_src)
            == jr.plan_capacity(jnp.asarray(dest), 16, n_src=n_src))


def test_capacity_helpers_match():
    for m in (0, 1, 15, 16, 17, 1000, 4097):
        assert tr.capacity_bucket(m) == jr.capacity_bucket(m)
        assert tr.capacity_bucket(m, limit=100) == jr.capacity_bucket(
            m, limit=100)
    for n, s in ((2048, 8), (10, 8), (65536, 8)):
        assert tr.auto_capacity(n, s) == jr.auto_capacity(n, s)


def test_dispatch_collect_with_fills_matches_reference():
    """One fused lane matrix each way: int32, bool, float and word
    payloads, overflowing bins, per-payload fills on both legs."""
    rng = np.random.default_rng(11)
    n, s, cap = 48, 4, 8
    dest = rng.integers(0, s, size=n).astype(np.int32)
    words = rng.integers(0, 2**32, size=(n, 5), dtype=np.uint64).astype(
        np.uint32)
    flt = rng.normal(size=(n, 3)).astype(np.float32)
    flags = rng.random(n) > 0.5
    ids = np.arange(n, dtype=np.int32)
    jb = jr.bin_by_dest(jnp.asarray(dest), s, cap)
    tb = tr.bin_by_dest(torch.from_numpy(dest), s, cap)
    j_parts = jr.dispatch(jb, [jnp.asarray(ids), jnp.asarray(words),
                               jnp.asarray(flt), jnp.asarray(flags)], None,
                          fills=(-1, 3, 0.5, True))
    with counting() as c:
        t_parts = tr.dispatch(tb, [torch.from_numpy(ids),
                                   torch.from_numpy(words.view(np.int32)),
                                   torch.from_numpy(flt),
                                   torch.from_numpy(flags)],
                              fills=(-1, 3, 0.5, True))
    assert c.delta == 1
    assert int(tb.n_dropped) > 0
    for a, b in zip(j_parts, t_parts):
        bn = _np(b)
        assert bn.shape == np.asarray(a).shape
        np.testing.assert_array_equal(
            bn.view(np.uint32) if bn.dtype == np.int32 else bn, np.asarray(a))
    j_back = jr.collect(jb, j_parts, None, fills=(7, 0, -2.0, False))
    t_back = tr.collect(tb, t_parts, fills=(7, 0, -2.0, False))
    for a, b in zip(j_back, t_back):
        bn = _np(b)
        np.testing.assert_array_equal(
            bn.view(np.uint32) if bn.dtype == np.int32 else bn, np.asarray(a))
    assert tr.lane_width(t_parts[:3]) == jr.lane_width(j_parts[:3])


def test_stable_rank_without_group_bound():
    """No ``n_groups``: the stable-argsort branch, negative groups too."""
    g = np.random.default_rng(2).integers(-5, 5, size=300).astype(np.int32)
    np.testing.assert_array_equal(
        _np(tr.stable_rank_by_group(torch.from_numpy(g))),
        np.asarray(jr.stable_rank_by_group(jnp.asarray(g))))


def test_multi_rank_backend_not_ported():
    """The multi-rank backend takes a ``torch.distributed`` process
    group; a mesh axis name (the reference's ``axis_name``) raises on
    both legs instead of falling back to the virtual shards.  The
    exchange itself is held in tests/test_torch_distributed.py."""
    tb = tr.bin_by_dest(torch.zeros(4, dtype=torch.int32), 2, 4)
    with pytest.raises(TypeError, match="ProcessGroup"):
        tr.dispatch(tb, [torch.zeros(4, dtype=torch.int32)], axis_name="x")
    with pytest.raises(TypeError, match="ProcessGroup"):
        tr.collect(tb, [torch.zeros((2, 4), dtype=torch.int32)],
                   axis_name="x")
