"""The port's telemetry substrate (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU:

- histograms, quantiles, snapshot merge and ``merge_snapshots`` on the
  same observations, bit for bit;
- the JSONL and Chrome exports of the same events, byte for byte;
- ``report``'s renderings and ``regress``'s verdicts and CLI on the same
  files (``benchmarks/trajectory.json`` as the baseline);
- the engine's self-record: from fresh registries, one seeded sequence
  (write, read, two cached reads, a capacity-bound write whose retries
  relabel drops, a replicated write, crash, recovery and a repair step,
  a migration step) through both packages leaves equal counters and
  equal non-time histograms, and traces whose events agree in
  ``source``, ``ops`` and every non-time scalar lane;
- ``OBS_DISABLED=1`` / ``disabled()`` and the fence.

The F3 decision (ROADMAP.md queue 3): the port's ``Histogram`` keeps the
reference's arithmetic, so a snapshot built in the same order equals the
reference's bit for bit; across merge orders ``counts``, ``count``,
``min`` and ``max`` are exact and the float ``sum`` is held to a
relative 1e-12 (it moves in its last bits with the order, in both
packages).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)
from _hypothesis_compat import given, settings, st

import repro.core as J
import repro.obs as jobs
from repro.obs import metrics as jmetrics
from repro.obs import regress as jregress
from repro.obs import report as jreport
from repro.obs import trace as jtrace
from repro_torch import core as T
from repro_torch import obs as tobs
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import regress as tregress
from repro_torch.obs import report as treport
from repro_torch.obs import trace as ttrace

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
KW, VW = 20, 26
N = 128
# lanes and histograms measured on the host clock: compared in count only
TIME_LANES = {"issue_us", "hidden_us", "commit_wait_us", "overlap_frac"}
TIME_HISTS = ("engine.round_latency_us", "engine.hidden_us",
              "engine.overlap_frac")
VALUE_HISTS = ("engine.fill_frac", "engine.bin_imbalance",
               "engine.hot_frac", "engine.batch_size")


def _hist_pair(seed: int, edges=jmetrics.FRACTION_EDGES):
    """The same seeded observations into a reference and a port
    histogram."""
    jh, th = jmetrics.Histogram(edges), tmetrics.Histogram(edges)
    rng = np.random.default_rng(seed)
    for v in rng.uniform(-0.2, 1.4, size=rng.integers(0, 40)):
        jh.observe(float(v))
        th.observe(float(v))
    return jh, th


def _same_but_sum(a: dict, b: dict) -> None:
    """Exact counts, count, min and max; the sum to a relative 1e-12."""
    assert {k: v for k, v in a.items() if k != "sum"} == {
        k: v for k, v in b.items() if k != "sum"}
    assert a["sum"] == pytest.approx(b["sum"], rel=1e-12, abs=1e-300)


# ---------------------------------------------------------------------------
# histograms and snapshots
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(st.integers(0, 97), st.integers(0, 97), st.integers(0, 97))
def test_histogram_merge_matches_reference(sa, sb, sc):
    """Each histogram and each merge in one order is the reference's bit
    for bit; across merge orders the port holds the F3 decision."""
    (ja, ta), (jb, tb), (jc, tc) = (_hist_pair(s) for s in (sa, sb, sc))
    for j, t in ((ja, ta), (jb, tb), (jc, tc)):
        assert t.to_dict() == j.to_dict()
    assert ta.merge(tb).merge(tc).to_dict() == \
        ja.merge(jb).merge(jc).to_dict()
    assert ta.merge(tb.merge(tc)).to_dict() == \
        ja.merge(jb.merge(jc)).to_dict()
    _same_but_sum(ta.merge(tb).to_dict(), tb.merge(ta).to_dict())
    _same_but_sum(ta.merge(tb).merge(tc).to_dict(),
                  ta.merge(tb.merge(tc)).to_dict())
    assert ta.merge(tmetrics.Histogram(ta.edges)).to_dict() == ta.to_dict()
    with pytest.raises(ValueError):
        ta.merge(tmetrics.Histogram((1.0, 2.0)))


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantile_matches_reference(q):
    jh, th = _hist_pair(7, jmetrics.LATENCY_EDGES_US)
    for v in (0.5, 3.0, 70.0, 9e7):
        jh.observe(v)
        th.observe(v)
    assert tmetrics.histogram_quantile(th, q) == \
        jmetrics.histogram_quantile(jh, q)
    assert tmetrics.histogram_quantile(th.to_dict(), q) == \
        jmetrics.histogram_quantile(jh.to_dict(), q)
    rt = tmetrics.Histogram.from_dict(json.loads(json.dumps(th.to_dict())))
    assert rt.to_dict() == jh.to_dict()


def _fill(reg, rng, hists: bool = True):
    for _ in range(int(rng.integers(1, 8))):
        reg.inc("c.x", int(rng.integers(0, 9)))
        reg.inc(f"c.{int(rng.integers(0, 3))}", 1)
    reg.set_gauge("g.last", float(rng.uniform()))
    if hists:
        for v in rng.uniform(0, 1, size=int(rng.integers(0, 12))):
            reg.observe("h.frac", float(v), jmetrics.FRACTION_EDGES)
        for v in rng.uniform(1, 1e4, size=int(rng.integers(0, 12))):
            reg.observe("h.us", float(v))


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 31), st.integers(0, 31), st.booleans())
def test_snapshot_merge_matches_reference(sa, sb, swap):
    """Registries filled with the same calls snapshot alike, and
    ``merge_snapshots``/``merge_snapshot`` give the reference's merged
    snapshot in the same order (in the other, F3's sum tolerance)."""
    snaps = {}
    for name, mod in (("j", jmetrics), ("t", tmetrics)):
        regs = [mod.MetricRegistry(), mod.MetricRegistry()]
        for reg, seed in zip(regs, (sa, sb)):
            _fill(reg, np.random.default_rng(seed))
        parts = [r.snapshot() for r in regs]
        snaps[name] = (parts, mod.merge_snapshots(parts[::-1] if swap
                                                  else parts))
    assert snaps["t"][0] == snaps["j"][0]
    assert snaps["t"][1] == snaps["j"][1]
    other = tmetrics.merge_snapshots(snaps["t"][0][::1 if swap else -1])
    assert other["counters"] == snaps["t"][1]["counters"]
    for k, h in other["histograms"].items():
        _same_but_sum(h, snaps["t"][1]["histograms"][k])
    reg = tmetrics.MetricRegistry()
    for p in snaps["t"][0]:
        reg.merge_snapshot(p)
    assert reg.snapshot()["counters"] == snaps["t"][1]["counters"]
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------

def _events(mod):
    """The same three events in a fresh recorder of ``mod`` (a trace
    module): a round with spans, a round without, a trace-only event."""
    rec = mod.TraceRecorder(maxlen=8)
    rec.record(mod.RoundEvent(
        source="engine.read", ts=12.5, dur=0.00125,
        spans={"bin": (12.5, 0.0002), "dispatch": (12.5002, 0.0003),
               "apply": (12.5005, 0.0004), "collect": (12.5009, 0.0001),
               "commit": (12.501, 0.00025)},
        ops={"read": 128},
        stats={"wire_words": 12544, "fill_frac": 0.5, "dropped": 0,
               "bin_imbalance": 1.1875, "hot_frac": 0.296875,
               "issue_us": 1000.0}))
    rec.record(mod.RoundEvent(
        source="sharded.write", ts=13.0, dur=0.003, spans={},
        ops={"write": 256}, stats={"requeued": 7, "wire_words": 99}))
    rec.record(mod.RoundEvent(source="migrate.step", ts=14.0, dur=-1.0,
                              spans={}, ops={"migrate": 64},
                              stats={"moved": 60, "remaining": 4}))
    return rec


@pytest.mark.parametrize("fmt", ["jsonl", "chrome"])
def test_exports_byte_equal_to_reference(tmp_path, fmt):
    out = {}
    for name, mod in (("j", jtrace), ("t", ttrace)):
        rec = _events(mod)
        path = tmp_path / f"{name}.{fmt}"
        n = (rec.to_jsonl(path) if fmt == "jsonl"
             else rec.to_chrome_trace(path))
        out[name] = (n, path.read_bytes())
    assert out["t"] == out["j"]
    assert out["t"][0] == (3 if fmt == "jsonl" else 3 + 5)


def test_trace_ring_is_bounded_like_reference():
    for mod in (jtrace, ttrace):
        rec = mod.TraceRecorder(maxlen=4)
        for i in range(10):
            rec.record(mod.RoundEvent(source=f"e{i}", ts=float(i), dur=0.0,
                                      spans={}, ops={}, stats={}))
        assert [e.source for e in rec.events()] == ["e6", "e7", "e8", "e9"]
        assert rec.n_recorded == 10 and rec.maxlen == 4


# ---------------------------------------------------------------------------
# the seeded sequence through both packages
# ---------------------------------------------------------------------------

def _sequence(P, conv, kw):
    """Write, read, two cached reads (the second hits the L1), a write at
    capacity 24 with two retries allowed (bins of ~32 rows drop), a
    replicated write (k=2) with a crash, recovery and one repair step,
    and one migration step of a ring table losing shard 1."""
    rng = np.random.default_rng(2)
    keys = conv(rng.integers(0, 2**31, size=(N, KW)).astype(np.uint32))
    vals = conv(rng.integers(0, 2**31, size=(N, VW)).astype(np.uint32))
    st = P.dht_create(P.DHTConfig(n_shards=4, buckets_per_shard=256), **kw)
    st, _ = P.dht_write(st, keys, vals)
    st, _, _, _ = P.dht_read(st, keys)
    l1 = P.l1_create(P.L1Config(n_sets=64, n_ways=2), 4, **kw)
    for _ in range(2):
        st, l1, _, _, _ = P.dht_read_cached(st, l1, keys)
    st = P.dht_create(P.DHTConfig(n_shards=4, buckets_per_shard=256,
                                  capacity=24), **kw)
    st, ws = P.dht_write(st, keys, vals, max_retries=2)
    st = P.dht_create(P.DHTConfig(n_shards=4, buckets_per_shard=256,
                                  n_replicas=2), P.ring_create(4), **kw)
    st, _ = P.dht_write_replicated(st, keys, vals)
    st = P.recover_shard(P.crash_shard(st, 1), 1)
    rep, _ = P.repair_step(P.repair_begin(st, 1, batch=64))
    st = P.dht_create(P.DHTConfig(n_shards=4, buckets_per_shard=256),
                      P.ring_create(4), **kw)
    st, _ = P.dht_write(st, keys, vals)
    P.migration_step(P.migration_begin(st, P.ring_leave(st.ring, 1),
                                       batch=64))


def _recorded(P, obs, conv, kw) -> dict:
    reg = obs.metrics.MetricRegistry()
    prev = obs.metrics.set_registry(reg)
    obs.get_tracer().clear()
    try:
        _sequence(P, conv, kw)
        return {"snap": reg.snapshot(),
                "events": [e.to_json() for e in obs.get_tracer().events()]}
    finally:
        obs.metrics.set_registry(prev)
        obs.get_tracer().clear()


def _tt(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.fixture(scope="module")
def runs():
    return {"ref": _recorded(J, jobs, jnp.asarray, {}),
            "port": _recorded(T, tobs, _tt, {"device": "cpu"})}


def test_sequence_counters_equal_reference(runs):
    got, want = runs["port"]["snap"], runs["ref"]["snap"]
    assert got["counters"] == want["counters"]
    c = got["counters"]
    # the sequence is not vacuous: drops relabelled, copies, L1 hits,
    # a repair and a migration step
    assert c["engine.requeued"] > 0 and c["replica.writes"] > 0
    assert c["l1.hits"] > 0 and c["repair.rounds"] == 1
    assert c["migrate.steps"] == 1 and c["routing.dispatches"] == \
        c["engine.rounds"]


@pytest.mark.parametrize("name", VALUE_HISTS + TIME_HISTS)
def test_sequence_histograms_equal_reference(runs, name):
    """Histograms of lane values bit for bit; of host-clock times in
    count."""
    got = runs["port"]["snap"]["histograms"][name]
    want = runs["ref"]["snap"]["histograms"][name]
    if name in TIME_HISTS:
        assert got["count"] == want["count"] > 0
    else:
        assert got == want
    assert set(runs["port"]["snap"]["histograms"]) == set(
        runs["ref"]["snap"]["histograms"])


def test_sequence_events_equal_reference(runs):
    """Event by event: the same source, op counts, phase names and every
    scalar lane but the host-clock ones.  The port's dual-epoch and
    replicated rounds are single rounds as in the reference, so no event
    is skipped."""
    got, want = runs["port"]["events"], runs["ref"]["events"]
    assert [e["source"] for e in got] == [e["source"] for e in want]
    for g, w in zip(got, want):
        assert g["ops"] == w["ops"], g["source"]
        assert list(g["spans"]) == list(w["spans"]), g["source"]
        assert ({k: v for k, v in g["stats"].items() if k not in TIME_LANES}
                == {k: v for k, v in w["stats"].items()
                    if k not in TIME_LANES}), g["source"]
    assert {"engine.read", "engine.write", "engine.migrate", "repair.step",
            "migrate.step"} <= {e["source"] for e in got}


def test_reference_snapshot_loads_into_port_registry(runs, tmp_path):
    snap = runs["ref"]["snap"]
    reg = tmetrics.MetricRegistry()
    reg.merge_snapshot(json.loads(json.dumps(snap)))
    assert reg.snapshot() == snap
    path = tmp_path / "snap.json"
    tmetrics.save_snapshot(str(path), reg)
    assert json.loads(path.read_text()) == snap


# ---------------------------------------------------------------------------
# report and regress: the same text and verdicts on the same files
# ---------------------------------------------------------------------------

def _files(runs, tmp_path):
    trace = tmp_path / "trace.jsonl"
    trace.write_text("".join(json.dumps(e, sort_keys=True) + "\n"
                             for e in runs["port"]["events"]))
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps(runs["port"]["snap"]))
    return str(trace), str(snap)


@pytest.mark.parametrize("args", [
    ["--trace", "T"], ["--bench", "S"], ["--bench", "S", "--trace", "T"],
    ["--bench", "S", "--bench", "S", "--top", "5"],
    ["--skew", "--trace", "T", "--bench", "S"], ["--trace", "T", "--last",
                                                 "4"]])
def test_report_cli_matches_reference(runs, tmp_path, capsys, args):
    trace, snap = _files(runs, tmp_path)
    argv = [{"T": trace, "S": snap}.get(a, a) for a in args]
    texts = []
    for mod in (jreport, treport):
        assert mod.main(argv) == 0
        texts.append(capsys.readouterr().out)
    assert texts[1] == texts[0] and "==" in texts[1]


def test_report_renderings_match_reference(runs):
    events, snap = runs["port"]["events"], runs["port"]["snap"]
    for fn, args in (("render_summary", (snap,)),
                     ("render_timeline", (events,)),
                     ("render_skew", (events, snap)),
                     ("render_summary", ({},)),
                     ("render_timeline", ([],)), ("render_skew", ())):
        assert getattr(treport, fn)(*args) == getattr(jreport, fn)(*args)


def _payload(traj: dict, scale: dict) -> dict:
    """A BENCH payload holding the trajectory's metrics, each times
    ``scale`` of its kind."""
    tel = {"counters": {}, "gauges": {}, "histograms": {}}
    benches: dict = {}
    for key, v in traj["metrics"].items():
        kind, rest = key.split(".", 1)
        if kind == "counter":
            tel["counters"][rest] = v * scale.get("counter", 1.0)
        elif kind == "gauge":
            tel["gauges"][rest] = v * scale.get("gauge", 1.0)
        else:
            benches.setdefault(f"BENCH_{kind}", []).append({
                "name": rest[:-len(".us_per_call")],
                "us_per_call": v * scale.get("time", 1.0)})
    return {"schema": {"schema_version": traj["source_schema_version"],
                       "fingerprint": traj["fingerprint"]},
            "telemetry": tel, **benches}


@pytest.mark.parametrize("scale,extra", [
    ({}, []), ({"time": 3.0}, []), ({"time": 3.0}, ["--strict-time"]),
    ({"counter": 1.5}, []), ({"gauge": 0.5}, []),
    ({}, ["--max-dropped-ratio", "0.001"]),
    ({"counter": 1.01}, ["--ignore-fingerprint"])])
def test_regress_cli_matches_reference(tmp_path, capsys, scale, extra):
    base = os.path.join(ROOT, "benchmarks", "trajectory.json")
    with open(base) as f:
        traj = json.load(f)
    bench = tmp_path / "BENCH.json"
    bench.write_text(json.dumps(_payload(traj, scale)))
    out = []
    for name, mod in (("j", jregress), ("t", tregress)):
        verdict = tmp_path / f"{name}.json"
        rc = mod.main(["--bench", str(bench), "--baseline", base,
                       "--out", str(verdict)] + extra)
        out.append((rc, capsys.readouterr().out,
                    json.loads(verdict.read_text())))
    assert out[1] == out[0]
    if not scale:
        assert out[1][0] == 0 and out[1][2]["verdict"] == "pass"
    if scale.get("counter") == 1.5:
        assert out[1][0] == 1 and out[1][2]["failures"]


def test_regress_functions_match_reference(tmp_path):
    with open(os.path.join(ROOT, "benchmarks", "trajectory.json")) as f:
        traj = json.load(f)
    payload = _payload(traj, {"time": 1.2})
    payload["repeats_raw"] = {"x": [[{"name": "a", "us_per_call": v}]
                                    for v in (30.0, 10.0, 20.0)]}
    got = tregress.extract_metrics(payload)
    assert got == jregress.extract_metrics(payload)
    assert all(tregress.classify(k) == jregress.classify(k) for k in got)
    assert tregress.compare(got, traj["metrics"]) == jregress.compare(
        got, traj["metrics"])
    assert tregress.make_trajectory(payload) == \
        jregress.make_trajectory(payload)
    assert tregress.dropped_ratio_gate(got, 0.0) == \
        jregress.dropped_ratio_gate(got, 0.0)
    # seeding a baseline writes the same document
    for name, mod in (("j", jregress), ("t", tregress)):
        bench = tmp_path / "b.json"
        bench.write_text(json.dumps(payload))
        assert mod.main(["--bench", str(bench), "--baseline",
                         str(tmp_path / f"{name}.json"), "--update"]) == 0
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


# ---------------------------------------------------------------------------
# off switches and the fence
# ---------------------------------------------------------------------------

def _small():
    rng = np.random.default_rng(3)
    st = T.dht_create(T.DHTConfig(n_shards=4, buckets_per_shard=256),
                      device="cpu")
    keys = _tt(rng.integers(0, 2**31, size=(64, KW)).astype(np.uint32))
    vals = _tt(rng.integers(0, 2**31, size=(64, VW)).astype(np.uint32))
    return st, keys, vals


def test_disabled_leaves_registry_and_trace_empty():
    st, keys, vals = _small()
    reg = tmetrics.MetricRegistry()
    prev = tmetrics.set_registry(reg)
    tobs.get_tracer().clear()
    try:
        with tmetrics.disabled():
            st, ws = T.dht_write(st, keys, vals, max_retries=1)
            rnd = T.dht_read_async(st, keys)
            assert rnd.lanes is None and rnd.mix is None
            _, _, found, _ = T.dht_read_commit(rnd)
        assert tobs.enabled()
        assert int(ws["inserted"]) == 64 and bool(found.all())
        assert reg.snapshot() == {"counters": {}, "gauges": {},
                                  "histograms": {}}
        assert tobs.get_tracer().events() == []
    finally:
        tmetrics.set_registry(prev)


def test_obs_disabled_environment_starts_off():
    env = dict(os.environ, OBS_DISABLED="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c",
         "from repro_torch.obs import metrics, trace; "
         "print(metrics.enabled(), trace.fence_enabled())"],
        env=env, capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


def test_fenced_round_records_every_phase():
    """With the fence on, a round on the CPU (where the fence waits for
    nothing) records the reference's five phases in order, one event a
    round, each span inside the round."""
    st, keys, vals = _small()
    prev_fence = tobs.set_fence(True)
    reg = tmetrics.MetricRegistry()
    prev = tmetrics.set_registry(reg)
    tobs.get_tracer().clear()
    try:
        assert tobs.fence_enabled()
        tobs.fence(keys, [vals], {"x": keys})
        T.dht_write(st, keys, vals)
        (ev,) = tobs.get_tracer().events()
    finally:
        tobs.set_fence(prev_fence)
        tmetrics.set_registry(prev)
        tobs.get_tracer().clear()
    assert list(ev.spans) == list(ttrace.PHASES)
    assert ev.source == "engine.write" and ev.ops == {"write": 64}
    for start, dur in ev.spans.values():
        assert ev.ts <= start and dur >= 0.0
    assert reg.counter("engine.rounds") == 1


def test_record_round_reads_tensor_lanes_like_reference():
    """``record_round`` takes 0-d tensors, numpy and Python numbers and
    flushes what the reference flushes for the same values (vectors
    skipped, float32 lanes as the float of their float32 value)."""
    lanes = {"wire_words": 12, "dropped": 3, "hits": 7, "rounds": 2,
             "fill_frac": 0.3, "bin_imbalance": 1.25, "hot_frac": 0.1,
             "l1_hits": 4, "bin_counts": [1, 2], "flag": True}
    snaps, events = [], []
    for obs, conv in ((jobs, jnp.asarray), (tobs, torch.tensor)):
        stats = {k: (v if k == "bin_counts" else
                     conv(np.float32(v)) if isinstance(v, float) else
                     conv(v)) for k, v in lanes.items()}
        reg = obs.metrics.MetricRegistry()
        prev = obs.metrics.set_registry(reg)
        obs.get_tracer().clear()
        try:
            obs.record_round("x.round", stats, ops={"read": 9})
            obs.record_event("x.event", {"n": conv(5)})
            snaps.append(reg.snapshot())
            events.append([{k: v for k, v in e.to_json().items()
                            if k not in ("ts", "dur")}
                           for e in obs.get_tracer().events()])
        finally:
            obs.metrics.set_registry(prev)
            obs.get_tracer().clear()
    assert snaps[1] == snaps[0]
    assert events[1] == events[0]


# ---------------------------------------------------------------------------
# device spans, timed host reads and profiler ranges
# ---------------------------------------------------------------------------

def test_round_opens_phase_ranges_under_profiler():
    """Under a CPU ``torch.profiler`` a write round's phases, its write
    schedule and its commit are profiler ranges, in the round's order;
    the round records what it records without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    st, keys, vals = _small()
    reg = tmetrics.MetricRegistry()
    prev = tmetrics.set_registry(reg)
    tobs.get_tracer().clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            T.dht_write(st, keys, vals)
        (ev,) = tobs.get_tracer().events()
    finally:
        tmetrics.set_registry(prev)
        tobs.get_tracer().clear()
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.name.startswith("engine.")]
    assert names == ["engine.bin", "engine.dispatch", "engine.apply",
                     "engine.write", "engine.collect", "engine.commit"]
    assert list(ev.spans) == list(ttrace.PHASES)
    assert not any(k.startswith("device_us.") or k == "issue_wait_us"
                   for k in ev.stats)
    assert "engine.host_syncs" not in reg.snapshot()["counters"]
    assert ttrace._CURRENT is None


def test_round_opens_no_range_without_profiler(monkeypatch):
    """Without a profiler no range is opened (the entries are counted);
    the same round under one opens its six."""
    from torch.profiler import ProfilerActivity, profile

    opened = []
    real = ttrace._open_range
    monkeypatch.setattr(ttrace, "_open_range",
                        lambda name: opened.append(name) or real(name))
    st, keys, vals = _small()
    T.dht_write(st, keys, vals)
    T.dht_read(st, keys)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        T.dht_write(st, keys, vals)
    assert len(opened) == 6


@pytest.mark.parametrize("spans", [ttrace.DEVICE_SPANS, ("bin", "apply")])
def test_record_round_device_lanes_fill_named_histograms(spans):
    """``record_round`` given ``device_us.*`` and ``issue_wait_us`` lanes
    as host numbers observes each ``device_us`` lane into its
    ``engine.device_us.<span>`` histogram and makes no other histogram;
    the event keeps every lane."""
    lanes = {f"device_us.{s}": 10.0 * (i + 1) for i, s in enumerate(spans)}
    lanes["issue_wait_us"] = 7.5
    reg = tmetrics.MetricRegistry()
    prev = tmetrics.set_registry(reg)
    tobs.get_tracer().clear()
    try:
        tobs.record_round("engine.read", lanes)
        (ev,) = tobs.get_tracer().events()
    finally:
        tmetrics.set_registry(prev)
        tobs.get_tracer().clear()
    hists = reg.snapshot()["histograms"]
    assert set(hists) == {f"engine.device_us.{s}" for s in spans}
    for s in spans:
        h = hists[f"engine.device_us.{s}"]
        assert h["count"] == 1 and h["sum"] == lanes[f"device_us.{s}"]
        assert h["edges"] == list(tmetrics.LATENCY_EDGES_US)
    assert ev.stats == lanes


def test_host_read_off_the_card_is_the_plain_read():
    """The sync helper records nothing for a CPU value, in a round or
    outside one, and returns the plain read."""
    from torch.profiler import ProfilerActivity, profile

    reg = tmetrics.MetricRegistry()
    prev = tmetrics.set_registry(reg)
    try:
        x = torch.tensor([3, 9, 4])
        assert ttrace.host_read("capacity", int, x.max()) == 9
        assert ttrace.host_read("lock_rounds", torch.Tensor.tolist,
                                x) == [3, 9, 4]
        cpu = torch.device("cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            rs = ttrace.begin_round(cpu)
            assert rs is not None and not rs.card
            assert ttrace.host_read("write_flag", bool, x.any()) is True
            assert ttrace.host_read("commit", int, x[0], rs) == 3
            rs.close()
        assert rs.lanes(None) == {} and rs.waits == []
        assert ttrace.begin_round(cpu) is None
    finally:
        tmetrics.set_registry(prev)
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}
    assert not any(e.name.startswith("engine.sync.")
                   for e in prof.events())
    assert ttrace._CURRENT is None


def test_raising_issue_half_closes_its_round(monkeypatch):
    """An issue half that raises after its round's spans began leaves no
    round behind for later host reads to be charged to, and closes its
    open profiler range."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import routing

    def broken(*a, **k):
        raise RuntimeError("dispatch failed")

    st, keys, vals = _small()
    monkeypatch.setattr(routing, "dispatch", broken)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError, match="dispatch failed"):
            T.dht_write(st, keys, vals)
        assert ttrace._CURRENT is None
    names = [e.name for e in prof.events() if e.name.startswith("engine.")]
    assert names == ["engine.bin", "engine.dispatch"]
