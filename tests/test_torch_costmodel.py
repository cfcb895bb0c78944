"""The port's skew diagnostics and cost model (``repro_torch.obs.skew``,
``repro_torch.obs.costmodel``) against the JAX package's, on the CPU:

- ``imbalance``, ``zipf_keys``, ``bucket_occupancy`` and
  ``l1_set_occupancy`` on the same inputs;
- the analytic wire replay (``predict_wire_words``) against the port
  engine's own ``wire_stats`` of live rounds, and against the
  reference's replay;
- ``fit`` on planted coefficients (the same model as the reference's),
  ``predict_round``, ``event_features`` and the ``RoundCostModel`` dict
  round trip;
- ``profiled_alltoall_words``, the port's side of the wire cross-check
  (the reference reads HLO there).
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.obs import costmodel as jcm
from repro.obs import skew as jskew
from repro_torch import core as T
from repro_torch.core import routing as troute
from repro_torch.core.hashing import owner_shard
from repro_torch.kernels import ops as kops
from repro_torch.obs import costmodel as tcm
from repro_torch.obs import skew as tskew


def _tt(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _words(n, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**31, size=(n, w)).astype(np.uint32)


# ---------------------------------------------------------------------------
# skew
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loads", [
    [10, 10, 10, 10], [97, 1, 1, 1], [], [0, 0, 0], [0, 5, 0, 0, 2],
    list(range(64)), [3.5, 0.25, 8.0]])
def test_imbalance_matches_reference(loads):
    assert tskew.imbalance(loads).to_dict() == \
        jskew.imbalance(loads).to_dict()


@pytest.mark.parametrize("alpha", [0.0, 0.99, 1.2])
def test_zipf_keys_match_reference(alpha):
    t = tskew.zipf_keys(np.random.default_rng(0), 512, 4, alpha=alpha)
    j = jskew.zipf_keys(np.random.default_rng(0), 512, 4, alpha=alpha)
    assert t.dtype == j.dtype == np.uint32
    np.testing.assert_array_equal(t, j)


def test_occupancy_matches_reference():
    """The table's and the cache's occupancy views of the same contents:
    an empty table and cache, then both after the same write and the same
    cached read."""
    cfg = dict(n_shards=4, buckets_per_shard=32, key_words=4, val_words=3)
    js = J.dht_create(J.DHTConfig(**cfg))
    ts = T.dht_create(T.DHTConfig(**cfg), device="cpu")
    jl = J.l1_create(J.L1Config(n_sets=16, n_ways=2, key_words=4,
                                val_words=3), 4)
    tl = T.l1_create(T.L1Config(n_sets=16, n_ways=2, key_words=4,
                                val_words=3), 4, device="cpu")
    assert tskew.bucket_occupancy(ts).to_dict() == \
        jskew.bucket_occupancy(js).to_dict()
    assert tskew.l1_set_occupancy(tl).to_dict() == \
        jskew.l1_set_occupancy(jl).to_dict()
    keys, vals = _words(64, 4, 2), _words(64, 3, 3)
    js, _ = J.dht_write(js, jnp.asarray(keys), jnp.asarray(vals))
    ts, _ = T.dht_write(ts, _tt(keys), _tt(vals))
    js, jl, _, _, _ = J.dht_read_cached(js, jl, jnp.asarray(keys))
    ts, tl, _, _, _ = T.dht_read_cached(ts, tl, _tt(keys))
    occ = tskew.bucket_occupancy(ts)
    assert occ.to_dict() == jskew.bucket_occupancy(js).to_dict()
    l1 = tskew.l1_set_occupancy(tl)
    assert l1.to_dict() == jskew.l1_set_occupancy(jl).to_dict()
    assert occ.total > 0 and l1.total > 0


# ---------------------------------------------------------------------------
# the analytic wire replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["read", "write"])
def test_predict_wire_words_matches_port_engine(kind):
    """The replay at the capacity the count-exchange prologue chose
    reproduces the port engine's wire lanes, both legs."""
    s, n, kw, vw = 8, 192, 6, 5
    state = T.dht_create(T.DHTConfig(n_shards=s, buckets_per_shard=64,
                                     key_words=kw, val_words=vw),
                         device="cpu")
    keys, vals = _tt(_words(n, kw, 0)), _tt(_words(n, vw, 1))
    state, stats = T.dht_write(state, keys, vals)
    if kind == "read":
        state, _, _, stats = T.dht_read(state, keys)
    dest = owner_shard(kops.hash64(keys)[:, 0], s)
    cap = troute.plan_capacity(dest, s)
    pred = tcm.predict_wire_words(n, s, key_words=kw, val_words=vw,
                                  kind=kind, capacity=cap, prologue=True)
    assert pred["wire_words"] == int(stats["wire_words"])
    assert pred == jcm.predict_wire_words(n, s, key_words=kw, val_words=vw,
                                          kind=kind, capacity=cap,
                                          prologue=True)


@pytest.mark.parametrize("n,s", [(4096, 8), (2048, 16), (100, 64), (0, 4)])
def test_capacity_and_lanes_match_reference(n, s):
    assert tcm.predict_capacity(n, s) == jcm.predict_capacity(n, s)
    for kw, vw, extra in ((20, 26, {}), (20, 26, {"kind": "write"}),
                          (4, 3, {"l1_meta": True}), (4, 3, {"dual": True}),
                          (4, 3, {"mixed": True})):
        assert tcm.send_reply_lanes(kw, vw, **extra) == \
            jcm.send_reply_lanes(kw, vw, **extra)
    for elide in (False, True):
        assert tcm.predict_wire_words(
            n, s, key_words=20, val_words=26, elide_self=elide) == \
            jcm.predict_wire_words(n, s, key_words=20, val_words=26,
                                   elide_self=elide)


# ---------------------------------------------------------------------------
# fit and predict
# ---------------------------------------------------------------------------

def _synthetic_events(alpha, beta, c_bin, c_shard, c_apply=0.0):
    evs = []
    for s in (2, 4, 8, 16, 32, 64):
        for n in (256, 1024, 4096):
            cap = jcm.predict_capacity(n, s)
            send, reply = jcm.send_reply_lanes(8, 8)
            rows = s * cap
            dur = (alpha + beta * rows * (send + reply)
                   + c_bin * n * np.log2(n) + c_apply * rows + c_shard * s)
            evs.append({"stats": {"dispatch_rounds": 1,
                                  "wire_send_words": rows * send,
                                  "wire_reply_words": rows * reply,
                                  "n_shards": s, "capacity": cap},
                        "ops": {"read": n}, "dur": float(dur)})
    return evs


@pytest.mark.parametrize("planted", [
    (8e-5, 5e-9, 2e-8, 4e-6), (1e-4, 5e-9, 2e-8, -1e-6),
    (2e-5, 1e-9, 0.0, 1e-5, 3e-9)])
def test_fit_matches_reference(planted):
    """The exhaustive-support NNLS recovers planted coefficients (a
    negative one clamped to 0) with the reference's numbers, and so do
    its predictions."""
    evs = _synthetic_events(*planted)
    junk = [{"stats": {}, "ops": {}, "dur": 0.0},
            {"stats": {"wire_send_words": 1}, "ops": {"read": 4},
             "dur": 1.0}]
    t, j = tcm.fit(evs + junk), jcm.fit(evs + junk)
    assert t.to_dict() == j.to_dict()
    assert t.n_events == len(evs) and min(t.coef()) >= 0.0
    if min(planted) >= 0.0:
        assert t.alpha == pytest.approx(planted[0], rel=1e-4)
        assert t.fit_rel_err < 1e-6
    for ev in evs[:3]:
        np.testing.assert_array_equal(tcm.event_features(ev),
                                      jcm.event_features(ev))
    kw = dict(key_words=8, val_words=8, prologue=False)
    assert tcm.predict_round(t, 2048, 128, **kw) == \
        jcm.predict_round(j, 2048, 128, **kw)
    again = tcm.RoundCostModel.from_dict(t.to_dict())
    assert again == t and again.to_dict() == j.to_dict()


def test_fit_on_port_trace_events():
    """The port's own recorded rounds feed the fit: every engine event
    has the lanes ``event_features`` needs, and the fit needs >= 5."""
    from repro_torch import obs

    reg = obs.metrics.MetricRegistry()
    prev = obs.metrics.set_registry(reg)
    obs.get_tracer().clear()
    try:
        st = T.dht_create(T.DHTConfig(n_shards=4, buckets_per_shard=256),
                          device="cpu")
        for n in (16, 32, 64, 128, 256, 512):
            keys = _tt(_words(n, 20, n))
            st, _ = T.dht_write(st, keys, _tt(_words(n, 26, n + 1)))
            T.dht_read(st, keys)
        events = obs.get_tracer().events()
    finally:
        obs.metrics.set_registry(prev)
        obs.get_tracer().clear()
    assert len(events) == 12
    assert all(tcm.event_features(e) is not None for e in events)
    model = tcm.fit(events)
    assert model.n_events == 12 and min(model.coef()) >= 0.0
    with pytest.raises(ValueError, match="needs >= 5"):
        tcm.fit(events[:4])


# ---------------------------------------------------------------------------
# the profiler side of the wire cross-check
# ---------------------------------------------------------------------------

Ev = collections.namedtuple("Ev", "name input_shapes")


def test_profiled_alltoall_words_counts_the_dispatcher_op_only():
    """One ``c10d::alltoall_base_`` event per ``all_to_all_single`` call,
    its input buffer's elements counted; the backend's own events beside
    it (``gloo:all_to_all``, ``nccl:all_to_all``) and the reductions are
    not, so nothing counts twice."""
    events = [Ev("c10d::alltoall_base_", [[16, 22], [16, 22], [], []]),
              Ev("gloo:all_to_all", [[16, 22]]),
              Ev("nccl:all_to_all", [[16, 22]]),
              Ev("c10d::allreduce_", [[4]]),
              Ev("c10d::alltoall_base_", [[16, 28], [16, 28], [], []])]
    assert tcm.profiled_alltoall_words(events) == 16 * 22 + 16 * 28
    assert tcm.profiled_alltoall_words([]) == 0
    with pytest.raises(ValueError, match="record_shapes"):
        tcm.profiled_alltoall_words([Ev("c10d::alltoall_base_", [])])
