"""The neighbourhood-interpolation slice of the port against the JAX package
on the CPU: stencil enumeration and keys, lattice steps, dedup, the IDW
blend, the multi-key read, ``lookup_or_interpolate`` and both forms of
``lookup_interpolate_or_compute``, and the POET twin with ``--interp``.

Same seeded numpy inputs on both sides; tables are carried across with
``convert.state_from_numpy``.  Keys, provenance, found flags, stats counts
and slab words must be identical; float outputs are held at rtol 1e-5
because the two frameworks sum and divide in different orders (F4 in
ROADMAP.md)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import interp as j_interp
from repro.core import neighbors as jn
from repro.core import routing as j_routing
from repro.obs import metrics as j_metrics
from repro_torch import core as T
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import interp as t_interp
from repro_torch.core import neighbors as tn
from repro_torch.core import routing as t_routing
from repro_torch.obs import metrics as t_metrics

SIG = 3
COUNTS = ("exact", "interpolated", "misses", "probe_hits", "mismatches",
          "dropped", "epoch", "wire_words")


def _jcompute(v):
    return jnp.concatenate([v * 2.0, v[:, :3]], axis=-1)


def _tcompute(v):
    return torch.cat([v * 2.0, v[:, :3]], dim=-1)


def _cfgs(shards=4, buckets=4096):
    dcfg = J.DHTConfig(n_shards=shards, buckets_per_shard=buckets)
    jcfg = J.SurrogateConfig(n_inputs=10, n_outputs=13, sig_digits=SIG,
                             dht=dcfg)
    tcfg = T.SurrogateConfig(n_inputs=10, n_outputs=13, sig_digits=SIG,
                             dht=T.DHTConfig(**dataclasses.asdict(dcfg)))
    return jcfg, tcfg


def _carry(js):
    return state_from_numpy(dataclasses.asdict(js.cfg), *(
        np.asarray(getattr(js, k)) for k in ("keys", "vals", "meta", "csum")),
        device="cpu")


def _tables_equal(js, ts):
    for k, v in state_to_numpy(ts).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, k)), k)


def _t(a):
    return torch.from_numpy(np.array(a))


def _table(jcfg, n=48, n_exact=12, seed=0):
    """One JAX-built table for every lookup test: the +-1-step lattice
    neighbours (dim 0) of n query centres, NOT the centres (each centre is
    a bracketed near miss, tests/test_interp.py's construction), plus
    n_exact stored rows.  Returns ``(state, centres, exact rows)``."""
    rng = np.random.default_rng(seed)
    base = jnp.asarray(rng.uniform(1.5, 9.5, size=(n, 10)), jnp.float32)
    center = np.asarray(J.round_significant(base, jcfg.sig_digits))
    step = np.asarray(jn.lattice_step(jnp.asarray(center), jcfg.sig_digits))
    lo, hi = center.copy(), center.copy()
    lo[:, 0] -= step[:, 0]
    hi[:, 0] += step[:, 0]
    exact = rng.uniform(0.5, 9.5, size=(n_exact, 10)).astype(np.float32)
    rows = jnp.asarray(np.concatenate([lo, hi, exact]), jnp.float32)
    st, _ = jax.jit(lambda st, x: J.store(jcfg, st, x, _jcompute(x)))(
        J.surrogate_create(jcfg), rows)
    return st, center, exact


def _mixed_queries(center, exact, seed=1):
    """48 rows: 24 bracketed centres, 12 exact rows, 12 far misses, and a
    ``valid`` mask that drops every 7th row."""
    far = np.random.default_rng(seed).uniform(
        20.0, 90.0, size=(12, 10)).astype(np.float32)
    x = np.concatenate([center[:24], exact, far])
    valid = np.ones(x.shape[0], bool)
    valid[::7] = False
    return x, valid


def _stencil_inputs(seed, n=48, d=6):
    """Magnitudes over six decades, both signs, plus rows at decade
    boundaries (the +step point crosses a decade and re-rounds onto an
    existing entry), zeros and exact lattice points."""
    rng = np.random.default_rng(seed)
    x = (10.0 ** rng.uniform(-3, 3, size=(n, d))
         * rng.choice([-1, 1], size=(n, d))).astype(np.float32)
    x[0] = [9.99, 1.0, 0.0999, -9.99, 100.0, 0.0][:d]
    x[1] = [0.0, -0.0, 5.55, 2.34, 999.0, 1e-3][:d]
    return x


# ---------------------------------------------------------------------------
# neighbors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [0, 1, 2, 3])
@pytest.mark.parametrize("coarse", [True, False])
def test_stencil_offsets_match_reference(radius, coarse):
    assert (tn.stencil_offsets(7, radius, coarse)
            == jn.stencil_offsets(7, radius, coarse))
    assert tn.n_stencil(7, radius, coarse) == jn.n_stencil(7, radius, coarse)


def test_lattice_step_matches_reference():
    rng = np.random.default_rng(1)
    x = (10.0 ** rng.uniform(-30, 30, 5000)
         * rng.choice([-1, 1], 5000)).astype(np.float32)
    x = np.concatenate([np.asarray(J.round_significant(jnp.asarray(x), SIG)),
                        [0.0, -0.0, 1e-40, np.inf, -np.inf, np.nan, 1.0,
                         10.0, 0.1, 1e30]]).astype(np.float32)
    for sig in (1, SIG, 6):
        a = np.asarray(jn.lattice_step(jnp.asarray(x), sig)).view(np.uint32)
        b = tn.lattice_step(torch.from_numpy(x), sig).numpy().view(np.uint32)
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("coarse", [True, False])
def test_stencil_keys_and_points_match_reference(radius, coarse):
    """Bit for bit: no input lies in the F1 band of a power of ten."""
    x = _stencil_inputs(radius * 2 + coarse)
    jk, jp = jn.stencil_keys(jnp.asarray(x), SIG, 14, radius=radius,
                             coarse_tier=coarse)
    tk, tp = tn.stencil_keys(torch.from_numpy(x), SIG, 14, radius, coarse)
    assert tk.shape == (x.shape[0], jn.n_stencil(6, radius, coarse), 14)
    np.testing.assert_array_equal(tk.numpy().view(np.uint32), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy().view(np.uint32),
                                  np.asarray(jp).view(np.uint32))
    np.testing.assert_array_equal(tn.dedup_mask(tk).numpy(),
                                  np.asarray(jn.dedup_mask(jk)))


def test_dedup_masks_decade_boundary_duplicates():
    x = np.array([[9.99, 1.0, 1.0, 1.0]], np.float32)
    keys, _ = tn.stencil_keys(torch.from_numpy(x), SIG, 8, 2)
    mask = tn.dedup_mask(keys).numpy()[0]
    uniq = {bytes(k) for k in keys.numpy()[0]}
    assert mask.sum() == len(uniq) < keys.shape[1] and mask[0]
    jk, _ = jn.stencil_keys(jnp.asarray(x), SIG, 8, radius=2)
    np.testing.assert_array_equal(mask, np.asarray(jn.dedup_mask(jk))[0])


# ---------------------------------------------------------------------------
# interpolation, fan-out, wire merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("icfg_kw", [{}, {"max_neighbor_dist": 1.2},
                                     {"min_neighbors": 1, "power": 1.0}])
def test_interpolate_matches_reference(icfg_kw):
    rng = np.random.default_rng(3)
    n, d, o = 64, 10, 13
    x = rng.uniform(1.5, 9.5, size=(n, d)).astype(np.float32)
    _, points = tn.stencil_keys(torch.from_numpy(x), SIG, 20, 1, True)
    points = points.numpy()
    m = points.shape[1]
    values = rng.normal(size=(n, m, o)).astype(np.float32)
    found = rng.random((n, m)) < 0.3
    found[:8, 0] = True
    step = tn.lattice_step(torch.from_numpy(points[:, 0]), SIG).numpy()
    jo, jp, js = j_interp.interpolate(
        jnp.asarray(x), jnp.asarray(points), jnp.asarray(values),
        jnp.asarray(found), jnp.asarray(step), j_interp.InterpConfig(**icfg_kw))
    to, tp, ts = t_interp.interpolate(
        *map(torch.from_numpy, (x, points, values, found, step)),
        t_interp.InterpConfig(**icfg_kw))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert {1, 2} <= set(tp.tolist())
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-6)
    for k in ("exact", "interpolated", "misses"):
        assert int(ts[k]) == int(js[k]), k
    np.testing.assert_allclose(float(ts["neighbors_mean"]),
                               float(js["neighbors_mean"]), rtol=1e-6)


def test_interp_config_rejects_bad_values():
    for bad in ({"radius": -1}, {"min_neighbors": 0},
                {"max_neighbor_dist": 0.0}):
        with pytest.raises(ValueError):
            t_interp.InterpConfig(**bad)


def test_flatten_fanout_and_merge_wire_stats_match_reference():
    keys = np.arange(5 * 3 * 4, dtype=np.int32).reshape(5, 3, 4)
    valid = np.arange(15).reshape(5, 3) % 4 != 0
    jf, jv = j_routing.flatten_fanout(jnp.asarray(keys), jnp.asarray(valid))
    tf, tv = t_routing.flatten_fanout(torch.from_numpy(keys),
                                      torch.from_numpy(valid))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert t_routing.flatten_fanout(torch.from_numpy(keys))[1] is None
    np.testing.assert_array_equal(
        t_routing.unflatten_fanout(tf, 5, 3).numpy(), keys)

    rounds = [(1000, 0.25), (300, 0.75), (12, 0.5)]
    j = j_metrics.merge_wire_stats(*[
        {"wire_words": jnp.int32(w), "fill_frac": jnp.float32(f)}
        for w, f in rounds])
    t = t_metrics.merge_wire_stats(*[
        {"wire_words": w, "fill_frac": torch.tensor(f)} for w, f in rounds])
    assert int(t["wire_words"]) == int(j["wire_words"])
    np.testing.assert_allclose(float(t["fill_frac"]), float(j["fill_frac"]),
                               rtol=1e-6)
    one = {"wire_words": 7, "fill_frac": torch.tensor(0.5)}
    assert t_metrics.merge_wire_stats(one) == one
    with pytest.raises(ValueError):
        t_metrics.merge_wire_stats()


def test_later_slices_raise_not_ported():
    """Replication (ROADMAP item 12) is ported, so a replicated table's
    neighbourhood query no longer raises: with no ring to name the
    successors, ``n_replicas=2`` places keys as ``hi % S`` does, as in
    the reference, and the dual-epoch forms give the unreplicated
    table's answers (replication on a ring: tests/test_torch_faults.py;
    the dual-epoch form itself: tests/test_torch_migrate.py)."""
    _, tcfg = _cfgs()
    out = []
    for k in (1, 2):
        rcfg = dataclasses.replace(tcfg, dht=dataclasses.replace(
            tcfg.dht, n_shards=2, n_replicas=k))
        st = T.surrogate_create(rcfg, device="cpu")
        x = torch.linspace(1.0, 2.0, 20).reshape(2, 10)
        T.store(rcfg, st, x, torch.ones(2, rcfg.n_outputs))
        keys = torch.arange(120, dtype=torch.int32).reshape(2, 3, 20)
        _, _, v, f, s = T.dht.dht_read_many_dual(st, st, keys)
        _, _, o, p, _ = T.lookup_or_interpolate(rcfg, st, x, prev=st)
        out.append((v, f, int(s["hits"]), o, p))
    (v1, f1, h1, o1, p1), (v2, f2, h2, o2, p2) = out
    assert torch.equal(v1, v2) and torch.equal(f1, f2) and h1 == h2
    assert torch.equal(o1, o2) and torch.equal(p1, p2)
    assert bool((p2 == T.PROV_EXACT).all())


# ---------------------------------------------------------------------------
# lookup_or_interpolate and lookup_interpolate_or_compute
# ---------------------------------------------------------------------------

def test_bracketed_near_misses_interpolate_in_both():
    """Every query is a bracketed near miss: all PROV_INTERP in both
    packages, within 5% of the stored function, same stats and table."""
    jcfg, tcfg = _cfgs()
    js, centers, _ = _table(jcfg)
    ts = _carry(js)
    js, jo, jp, jst = J.lookup_or_interpolate(jcfg, js, jnp.asarray(centers),
                                              J.InterpConfig(radius=1))
    t_metrics.get_registry().reset()
    ts, to, tp, tst = T.lookup_or_interpolate(tcfg, ts, _t(centers),
                                              T.InterpConfig(radius=1))
    assert (np.asarray(jp) == J.PROV_INTERP).all()
    assert (tp.numpy() == T.PROV_INTERP).all()
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5)
    truth = _tcompute(_t(centers)).numpy()
    assert (np.abs(to.numpy() - truth) / (np.abs(truth) + 1e-9)).max() < 0.05
    for k in COUNTS:
        assert int(tst[k]) == int(jst[k]), k
    assert float(tst["fill_frac"]) == float(jst["fill_frac"])
    assert t_metrics.counter_value("surrogate.interpolated") == centers.shape[0]
    _tables_equal(js, ts)


def test_lookup_or_interpolate_mixed_provenance_and_valid():
    jcfg, tcfg = _cfgs()
    js, center, exact = _table(jcfg)
    ts = _carry(js)
    x, valid = _mixed_queries(center, exact)
    js, jo, jp, jst = J.lookup_or_interpolate(
        jcfg, js, jnp.asarray(x), J.InterpConfig(), valid=jnp.asarray(valid))
    ts, to, tp, tst = T.lookup_or_interpolate(
        tcfg, ts, _t(x), T.InterpConfig(), valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert set(tp.tolist()) == {T.PROV_MISS, T.PROV_EXACT, T.PROV_INTERP}
    assert (tp.numpy()[~valid] == T.PROV_MISS).all()
    hit = tp.numpy() == T.PROV_EXACT
    np.testing.assert_array_equal(to.numpy()[hit].view(np.uint32),
                                  np.asarray(jo)[hit].view(np.uint32))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5)
    for k in COUNTS:
        assert int(tst[k]) == int(jst[k]), k
    _tables_equal(js, ts)


def test_dht_read_many_matches_reference():
    """The stencil neighbourhood of the mixed queries, deduplicated, as
    one (n, M, KW) multi-key read."""
    jcfg, tcfg = _cfgs()
    js, center, exact = _table(jcfg)
    ts = _carry(js)
    x, valid = _mixed_queries(center, exact)
    keys, _ = tn.stencil_keys(_t(x), SIG, 20)
    vmask = tn.dedup_mask(keys) & torch.from_numpy(valid)[:, None]
    js, jv, jf, jst = J.dht_read_many(
        js, jnp.asarray(keys.numpy().view(np.uint32)),
        jnp.asarray(vmask.numpy()))
    ts, tv, tf, tst = T.dht_read_many(ts, keys, vmask)
    assert tv.shape == keys.shape[:2] + (26,) and tf.shape == keys.shape[:2]
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), np.asarray(jv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for k in ("hits", "misses", "mismatches", "dropped", "epoch",
              "wire_words", "bin_max_load"):
        assert int(tst[k]) == int(jst[k]), k
    assert float(tst["fill_frac"]) == float(jst["fill_frac"])
    assert 0 < int(tst["hits"]) < int(vmask.sum())
    _tables_equal(js, ts)


@pytest.mark.parametrize("one_round", [False, True])
def test_lookup_interpolate_or_compute_matches_reference(one_round):
    """Host form against the reference's eager form, ``one_round=True``
    against its jitted (traced) form: one mixed read + get-or-put round.
    The traced reference sizes its routing bins statically, the port
    from the round's counts, so the wire lanes are compared only for the
    host form."""
    jcfg, tcfg = _cfgs()
    js, center, exact = _table(jcfg)
    ts = _carry(js)
    x, _valid = _mixed_queries(center, exact)
    if one_round:
        jfn = jax.jit(lambda st, v: J.lookup_interpolate_or_compute(
            jcfg, st, v, _jcompute, J.InterpConfig()))
        counts = tuple(k for k in COUNTS if k != "wire_words")
    else:
        def jfn(st, v):
            return J.lookup_interpolate_or_compute(jcfg, st, v, _jcompute,
                                                   J.InterpConfig())
        counts = COUNTS
    calls = []

    def tcompute(v):
        calls.append(v.shape[0])
        return _tcompute(v)

    far = np.random.default_rng(7).uniform(20.0, 90.0, size=(20, 10))
    second = np.concatenate([x[12:40], far]).astype(np.float32)
    seen = set()
    for q in (x, second):
        js, jo, jp, jst = jfn(js, jnp.asarray(q))
        ts, to, tp, tst = T.lookup_interpolate_or_compute(
            tcfg, ts, _t(q), tcompute, T.InterpConfig(), one_round=one_round)
        _tables_equal(js, ts)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5)
        for k in counts + ("stored",):
            assert int(tst[k]) == int(jst[k]), k
        seen |= set(tp.tolist())
    assert seen == {T.PROV_EXACT, T.PROV_INTERP, T.PROV_MISS}
    assert len(calls) == 2 and int(tst["stored"]) > 0


def test_fully_resolved_batch_skips_compute():
    jcfg, tcfg = _cfgs()
    js, centers, _ = _table(jcfg)
    ts = _carry(js)
    calls = []
    ts, out, prov, st = T.lookup_interpolate_or_compute(
        tcfg, ts, _t(centers), lambda v: calls.append(1) or _tcompute(v))
    assert (prov.numpy() == T.PROV_INTERP).all()
    assert not calls and int(st["stored"]) == 0
    _tables_equal(js, ts)


# ---------------------------------------------------------------------------
# the POET twin with --interp
# ---------------------------------------------------------------------------

def test_poet_twin_interp_matches_reference():
    """Same exact hits, interpolated hits, misses and solver calls as the
    JAX example with ``use_interp``; ``conc`` within rtol 1e-5 (F4)."""
    from examples.poet_reactive_transport import PoetConfig as JPoet
    from examples.poet_reactive_transport import run_simulation as j_run
    from examples.torch_poet_reactive_transport import PoetConfig as TPoet
    from examples.torch_poet_reactive_transport import run_simulation as t_run

    kw = dict(nx=12, ny=24, n_steps=6, sig_digits=3, solver_iters=60,
              use_interp=True)
    ref = j_run(JPoet(**kw), use_dht=True)
    out = t_run(TPoet(**kw), use_dht=True, device="cpu")
    for k in ("hits", "interp_hits", "misses", "chem_calls", "mismatches"):
        assert out[k] == ref[k], k
    assert out["exact_hit_rate"] == ref["exact_hit_rate"]
    np.testing.assert_allclose(out["conc"].numpy(), np.asarray(ref["conc"]),
                               rtol=1e-5)
