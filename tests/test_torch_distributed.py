"""The port's multi-rank backend (``repro_torch.core.distributed``,
ROADMAP item 7) on gloo ranks on the CPU, against the reference.

Two spawned groups of 2 ranks (``tests/torch_dist_ranks.py``: ``modes``
and ``tier``) run many checks each and return their rows, and a group of
3 (``elastic``) runs a leave and a join through the lockstep
``apply_ring``; one subprocess runs the reference's own ``ShardedDHT``
on 2 forced host devices, another the reference's single-device
``shard_leave``/``shard_join`` on the elastic group's batch.  All of
them run at once, from one module fixture, each with a collective
timeout in the ranks and a join timeout here, so a hang fails the tests
instead of stalling the suite.  The group's batch is the ranks' batches
in rank order.  The oracles:

- ``capacity > 0`` (per source and destination pair on the sharded
  backend): every output, found flag, code, stat lane and slab word
  against the reference's ``ShardedDHT``, drops included;
- ``capacity = 0`` (the port's agreed count-exchange capacity: nothing
  drops): outputs and slabs against the reference's virtual-shard
  backend on the same global batch, rank r's slab against shard r;
- the L1 tier, elision, the issue/commit wrappers and the pipelined
  schedule against the port's own cacheless, routed and synchronous
  rounds, bit for bit;
- the two surrogate forms against the reference's ``jax.jit``-traced
  forms on the virtual-shard backend.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import torch_dist_ranks as R

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TESTS = os.path.join(ROOT, "tests")
JOIN_TIMEOUT = 300          # seconds for every process of the fixture
SEND, REPLY = 1 + R.KW + 1, R.VW + 1 + 1    # a read round's lanes a row

REFERENCE = """
import json
import sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import torch_dist_ranks as R
from repro.core import DHTConfig
from repro.core.distributed import ShardedDHT
from repro.obs.metrics import MetricRegistry, set_registry

mesh = jax.make_mesh((R.WORLD,), ("dht",))
out = {{}}

def put(prefix, v):
    if isinstance(v, dict):
        for k, x in v.items():
            put(prefix + "/" + k, x)
    else:
        out[prefix] = np.asarray(v)

def slab(prefix, st):
    for k in ("keys", "vals", "meta", "csum"):
        out[prefix + "/" + k] = np.asarray(getattr(st, k))

inp = {{k: jnp.asarray(v) for k, v in R.mode_inputs().items()}}
keys, vals, mk, mv = inp["keys"], inp["vals"], inp["mk"], inp["mv"]
ones = jnp.ones((R.N,), bool)
many = keys.reshape(R.N // 4, 4, R.KW)
first = jnp.zeros((R.N // 4, 4), bool).at[:, 0].set(True)
for mode in R.MODES:
    p = mode + "/cap" + str(R.CAP)
    cfg = DHTConfig(n_shards=R.WORLD, buckets_per_shard=R.BUCKETS,
                    mode=mode, capacity=R.CAP)
    a = ShardedDHT.create(mesh, cfg)
    if mode == "lockfree":
        prev = set_registry(MetricRegistry())
    put(p + "/write", a.write(keys, vals))
    o, f, s = a.read(keys)
    put(p + "/read", {{"out": o, "found": f, "stats": s}})
    if mode == "lockfree":
        a.read(keys)
        out["telemetry/snapshot"] = np.array(json.dumps(
            a.telemetry_snapshot()))
        set_registry(prev)
    if mode == "lockfree":
        o, f, s = a.read_many(many)
        put(p + "/many", {{"out": o, "found": f, "stats": s}})
        o, f, s = a.read_many(many, first)
        put(p + "/many_first", {{"out": o, "found": f, "stats": s}})
    em = a.execute_fn(("migrate",))
    a.state, o, f, c, es = em(a.state, mk, mv, ones)
    put(p + "/migrate", {{"out": o, "found": f, "code": c, "stats": es}})
    slab(p + "/a_slab", a.state)
    if mode != "lockfree":
        continue
    b = ShardedDHT.create(mesh, cfg)
    ew, er = b.execute_fn(("write",)), b.execute_fn(("read",))
    b.state, _, _, c, es = ew(b.state, keys, vals, ones)
    put(p + "/ex_write", {{"code": c, "stats": es}})
    b.state, o, f, _, es = er(b.state, keys, vals, ones)
    put(p + "/ex_read", {{"out": o, "found": f, "stats": es}})
    slab(p + "/b_slab", b.state)
r = {{k: jnp.asarray(v) for k, v in R.retry_inputs().items()}}
d = ShardedDHT.create(mesh, DHTConfig(n_shards=R.WORLD, buckets_per_shard=4096,
                                      capacity=R.RETRY_CAP))
put("retry/write", d.write(r["keys"], r["vals"]))
slab("retry/slab", d.state)
np.savez(sys.argv[1], **out)
"""

# the elastic group's changes on the reference's single-device backend
# (its sharded leave/join cannot run here: ROADMAP.md F3), in a process
# of its own so that it runs beside the other reference
REFERENCE_ELASTIC = """
import sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import torch_dist_ranks as R
from repro.core import DHTConfig, dht_create, dht_read, dht_write
from repro.core import ring_create, shard_join, shard_leave

out = {{}}

def put(prefix, v):
    if isinstance(v, dict):
        for k, x in v.items():
            put(prefix + "/" + k, x)
    else:
        out[prefix] = np.asarray(v)

def slab(prefix, st):
    for k in ("keys", "vals", "meta", "csum"):
        out[prefix + "/" + k] = np.asarray(getattr(st, k))

e = {{k: jnp.asarray(v) for k, v in R.elastic_inputs().items()}}
st = dht_create(DHTConfig(n_shards=R.ELASTIC_WORLD,
                          buckets_per_shard=R.ELASTIC_BUCKETS),
                ring_create(R.ELASTIC_WORLD))
st, _ = dht_write(st, e["keys"], e["vals"])
slab("elastic/init", st)
for step, change in (("leave", shard_leave), ("join", shard_join)):
    st, stats = change(st, 1, batch=R.ELASTIC_BATCH)
    put("elastic/" + step + "/stats", stats)
    st, o, f, s = dht_read(st, e["keys"])
    put("elastic/" + step + "/read", {{"out": o, "found": f,
                                      "epoch": s["epoch"]}})
    slab("elastic/" + step + "/slab", st)
np.savez(sys.argv[1], **out)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.update(extra)
    return env


def _finish(procs: dict) -> None:
    """Wait for every process under one deadline; kill them all on a
    timeout or a failure, so no rank outlives the fixture."""
    try:
        for name, p in procs.items():
            try:
                _, err = p.communicate(timeout=JOIN_TIMEOUT)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name}: no exit within "
                                     f"{JOIN_TIMEOUT} s (a hang?)")
            assert p.returncode == 0, f"{name} failed:\n{err[-4000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    procs = {"reference": subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(tests=TESTS)),
         str(out / "reference.npz")],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=2",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)}
    procs["reference elastic"] = subprocess.Popen(
        [sys.executable, "-c",
         textwrap.dedent(REFERENCE_ELASTIC.format(tests=TESTS)),
         str(out / "reference_elastic.npz")],
        env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    for group in R.GROUPS:
        port = _free_port()
        world = R.GROUP_WORLD.get(group, R.WORLD)
        for rank in range(world):
            procs[f"{group} rank {rank}"] = subprocess.Popen(
                [sys.executable, os.path.join(TESTS, "torch_dist_ranks.py"),
                 group, str(rank), str(world), str(port), str(out)],
                env=_env(), stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True)
    try:
        # the parent's reference rounds run while the ranks do
        res = {"virtual": _virtual(), "traced": _traced()}
    finally:
        _finish(procs)
    res["reference"] = dict(np.load(out / "reference.npz"))
    res["reference"].update(np.load(out / "reference_elastic.npz"))
    for group in R.GROUPS:
        res[group] = [dict(np.load(out / f"{group}_rank{r}.npz"))
                      for r in range(R.GROUP_WORLD.get(group, R.WORLD))]
    return res


def _cat(ranks, key):
    """The group's rows: the ranks' rows in rank order."""
    return np.concatenate([r[key] for r in ranks])


def _slab(ranks, prefix):
    """The group's table: rank r's shard as shard r."""
    return {k: np.concatenate([r[f"{prefix}/{k}"] for r in ranks])
            for k in ("keys", "vals", "meta", "csum")}


def _assert_slabs(got: dict, want, what: str):
    for k in ("keys", "vals", "meta", "csum"):
        w = want[k] if isinstance(want, dict) else np.asarray(
            getattr(want, k))
        np.testing.assert_array_equal(got[k], w, f"{what}: {k}")


# ---------------------------------------------------------------------------
# capacity > 0: the reference's ShardedDHT, drops included
# ---------------------------------------------------------------------------

STEPS = ("write", "read", "many", "many_first", "migrate", "ex_write",
         "ex_read")
ROWS = {"write": ("code",), "read": ("out", "found"),
        "many": ("out", "found"), "many_first": ("out", "found"),
        "migrate": ("out", "found", "code"), "ex_write": ("code",),
        "ex_read": ("out", "found")}


# F4: under jit, XLA turns the division by a round's constant row count
# into a multiply by its reciprocal, so the reference's traced fractions
# may sit an ulp or two from the port's exact division (1 - 48/48 reads
# -2.98e-08 there).  The counts are held exactly.
FRACTIONS = ("fill_frac", "bin_imbalance", "hot_frac")


def _assert_lanes(got: dict, want: dict, what: str):
    for k, v in want.items():
        if k in FRACTIONS:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-7,
                                       err_msg=f"{what}/{k}")
        else:
            np.testing.assert_array_equal(got[k], v, f"{what}/{k}")


def _lanes(d: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in d.items()
            if k.startswith(prefix + "/")}


# every step in lock-free mode; the locked modes' write, read and
# get-or-put (the reference compiles a program per closure and mode)
CASES = [("lockfree", step) for step in STEPS] + [
    (mode, step) for mode in ("fine", "coarse")
    for step in ("write", "read", "migrate")]


@pytest.mark.parametrize("mode,step", CASES)
def test_sharded_rounds_match_reference_sharded(runs, mode, step):
    """Outputs, found flags, codes and every stat lane of each wrapper
    and engine closure, at capacity 64 a (source, destination) pair, are
    the reference ShardedDHT's on 2 host devices (the same global batch,
    the same drops)."""
    ranks, ref = runs["modes"], runs["reference"]
    p = f"{mode}/cap{R.CAP}/{step}"
    stats = p if step == "write" else f"{p}/stats"
    for row in ROWS[step]:
        key = f"{p}/{row}"
        np.testing.assert_array_equal(_cat(ranks, key), ref[key], key)
    want = {k: v for k, v in _lanes(ref, stats).items() if k != "code"}
    for r in ranks:
        got = {k: v for k, v in _lanes(r, stats).items() if k != "code"}
        assert set(got) == set(want), (sorted(got), sorted(want))
        _assert_lanes(got, want, stats)


def test_capacity_case_drops_rows(runs):
    """The capacity>0 streams are not vacuous: the wrapper's first write
    round drops rows (and retries them), the engine's write round keeps
    its drops (``W_DROPPED``), on both backends alike."""
    ranks = runs["modes"]
    p = f"lockfree/cap{R.CAP}"
    assert int(ranks[0][f"{p}/write/write_retries"]) >= 1
    assert int(ranks[0][f"{p}/ex_write/stats/dropped"]) > 0
    assert (_cat(ranks, f"{p}/ex_write/code") == J.W_DROPPED).any()


@pytest.mark.parametrize("mode", R.MODES)
def test_sharded_slabs_match_reference_sharded(runs, mode):
    """At capacity 64 the tables after the wrapper stream (and, lock-free,
    after the engine closures) are the reference ShardedDHT's, word for
    word."""
    ranks, ref = runs["modes"], runs["reference"]
    for t in ("a_slab", "b_slab") if mode == "lockfree" else ("a_slab",):
        p = f"{mode}/cap{R.CAP}/{t}"
        _assert_slabs(_slab(ranks, p), _lanes(ref, p), p)


def test_sharded_write_retry_on_overflow(runs):
    """Mirrors tests/test_faults.py::test_sharded_write_retry_on_overflow
    (without its ring): capacity 24 below the round's largest bin drops
    rows in round 1; the group-agreed retry recovers every row, and the
    lanes equal the reference's ShardedDHT's."""
    ranks, ref = runs["modes"], runs["reference"]
    lanes = _lanes(ranks[0], "retry/write")
    applied = sum(int(lanes[k]) for k in ("inserted", "updated", "evicted"))
    assert applied == R.RETRY_N
    assert int(lanes["write_retries"]) >= 1 and int(lanes["dropped"]) == 0
    want = _lanes(ref, "retry/write")
    np.testing.assert_array_equal(_cat(ranks, "retry/write/code"),
                                  want.pop("code"))
    for r in ranks:
        _assert_lanes(_lanes(r, "retry/write"), want, "retry/write")
    _assert_slabs(_slab(ranks, "retry/slab"), _lanes(ref, "retry/slab"),
                  "retry")


# ---------------------------------------------------------------------------
# capacity = 0: the virtual-shard backend on the same global batch
# ---------------------------------------------------------------------------

def _virtual():
    """The reference's virtual-shard backend (eager: its count-driven
    capacity drops nothing) on the modes stream, in all three modes."""
    inp = {k: jnp.asarray(v) for k, v in R.mode_inputs().items()}
    keys, vals, mk, mv = inp["keys"], inp["vals"], inp["mk"], inp["mv"]
    many = keys.reshape(R.N // 4, 4, R.KW)
    first = jnp.zeros((R.N // 4, 4), bool).at[:, 0].set(True)
    res = {}
    for mode in R.MODES:
        cfg = J.DHTConfig(n_shards=R.WORLD, buckets_per_shard=R.BUCKETS,
                          mode=mode)
        o = {}
        st = J.dht_create(cfg)
        st, o["write"] = J.dht_write(st, keys, vals)
        written = st
        st, o["read_out"], o["read_found"], _ = J.dht_read(st, keys)
        st, o["many_out"], o["many_found"], _ = J.dht_read_many(st, many)
        st, o["first_out"], o["first_found"], _ = J.dht_read_many(
            st, many, first)
        st, _, o["mig_out"], o["mig_found"], o["mig_code"], _ = \
            J.dht_execute(st, J.migrate_ops(mk, mv), kinds=("migrate",))
        o["a_slab"] = st
        # the engine's write round at capacity 0 is the wrapper's: b's
        # table is the written one, then a 95/5 mixed round on it
        st = o["b_slab"] = written
        st, _, o["mixed_out"], o["mixed_found"], o["mixed_code"], _ = \
            J.dht_execute(st, J.mixed_ops(inp["op"], mk, mv),
                          kinds=("read", "write"))
        o["mixed_slab"] = st
        res[mode] = o
    return res


@pytest.mark.parametrize("mode", R.MODES)
def test_sharded_rows_match_virtual_backend(runs, mode):
    """Mirrors tests/test_distributed.py::test_sharded_dht_all_modes and
    ::test_sharded_dht_read_many_one_round at capacity 0: every write
    lands, every read hits, read_many with and without its mask, the
    get-or-put and a 95/5 mixed round through the engine: all rows equal
    the virtual-shard backend's."""
    ranks, v = runs["modes"], runs["virtual"][mode]
    p = f"{mode}/cap0"
    pairs = {
        "write/code": v["write"]["code"], "read/out": v["read_out"],
        "read/found": v["read_found"], "many/out": v["many_out"],
        "many/found": v["many_found"], "many_first/out": v["first_out"],
        "many_first/found": v["first_found"], "migrate/out": v["mig_out"],
        "migrate/found": v["mig_found"], "migrate/code": v["mig_code"],
        "ex_write/code": v["write"]["code"], "mixed/out": v["mixed_out"],
        "mixed/found": v["mixed_found"], "mixed/code": v["mixed_code"]}
    for key, want in pairs.items():
        np.testing.assert_array_equal(_cat(ranks, f"{p}/{key}"),
                                      np.asarray(want), key)
    assert _cat(ranks, f"{p}/read/found").all()
    first = _cat(ranks, f"{p}/many_first/found")
    assert first[:, 0].all() and not first[:, 1:].any()
    for k in ("dropped",):
        assert int(ranks[0][f"{p}/write/{k}"]) == 0
        assert int(ranks[0][f"{p}/read/stats/{k}"]) == 0
    for k in ("inserted", "updated", "evicted", "rounds"):
        assert int(ranks[0][f"{p}/write/{k}"]) == int(v["write"][k]), k


@pytest.mark.parametrize("mode", R.MODES)
def test_sharded_slabs_match_virtual_backend(runs, mode):
    """Where nothing drops, rank r's slab is shard r of the virtual-shard
    backend's after the same rounds: keys, vals, meta and csum words."""
    ranks, v = runs["modes"], runs["virtual"][mode]
    for t in ("a_slab", "b_slab", "mixed_slab"):
        _assert_slabs(_slab(ranks, f"{mode}/cap0/{t}"), v[t], t)


@pytest.mark.parametrize("mode", R.MODES)
def test_sharded_execute_fn_matches_wrappers(runs, mode):
    """Mirrors tests/test_distributed.py::
    test_sharded_execute_fn_matches_wrappers_all_modes at capacity 0:
    the engine closures equal the wrappers, and the get-or-put skips the
    128 present keys and inserts the 128 fresh ones."""
    ranks = runs["modes"]
    p = f"{mode}/cap0"
    np.testing.assert_array_equal(_cat(ranks, f"{p}/ex_write/code"),
                                  _cat(ranks, f"{p}/write/code"))
    for k in ("out", "found"):
        np.testing.assert_array_equal(_cat(ranks, f"{p}/ex_read/{k}"),
                                      _cat(ranks, f"{p}/read/{k}"))
    code = _cat(ranks, f"{p}/migrate/code")
    assert (code == J.W_SKIP).sum() == R.N // 2
    assert (code == J.W_INSERT).sum() == R.N // 2
    if mode != "lockfree":
        assert int(ranks[0][f"{p}/write/lock_tokens"]) > 0


# ---------------------------------------------------------------------------
# the locality tier, elision and the issue/commit wrappers
# ---------------------------------------------------------------------------

def test_cached_reads_equal_cacheless(runs):
    """Cached sharded reads (L1 in front, self traffic elided) are bit
    for bit the cacheless read, serve L1 hits on the repeat, and follow
    a remote write through the watermark piggyback."""
    ranks = runs["tier"]
    plain = _cat(ranks, "l1/plain1/out")
    assert _cat(ranks, "l1/plain1/found").all()
    for i in (2, 3):
        np.testing.assert_array_equal(_cat(ranks, f"l1/cached{i}/out"),
                                      plain)
    assert int(ranks[0]["l1/cached2/stats/l1_hits"]) == 0
    assert int(ranks[0]["l1/cached3/stats/l1_hits"]) > R.N // 2
    np.testing.assert_array_equal(_cat(ranks, "l1/cached4/out"),
                                  _cat(ranks, "l1/plain4/out"))
    vals = R.mode_inputs(7)["vals"]
    q = R.N // R.WORLD // 4
    got = _cat(ranks, "l1/cached4/out")
    for r in range(R.WORLD):
        rows = slice(r * (R.N // R.WORLD), r * (R.N // R.WORLD) + q)
        np.testing.assert_array_equal(got[rows], vals[rows] + 9)
    np.testing.assert_array_equal(_cat(ranks, "l1/cached_many/out"),
                                  _cat(ranks, "l1/plain_many/out"))
    _assert_slabs(_slab(ranks, "l1/cached_slab"),
                  _slab(ranks, "l1/plain_slab"), "l1")


def test_elided_rows_leave_the_wire(runs):
    """Elision: the elided read equals the routed one bit for bit; the
    self block leaves both legs of each rank's wire words, and the
    group's read ships (S-1) blocks a rank (3 coherence lanes more for a
    cached read)."""
    ranks = runs["tier"]
    np.testing.assert_array_equal(_cat(ranks, "l1/routed/out"),
                                  _cat(ranks, "l1/plain1/out"))
    np.testing.assert_array_equal(_cat(ranks, "l1/routed/found"),
                                  _cat(ranks, "l1/plain1/found"))
    cap = R.TIER_CAP
    for r in ranks:
        assert (int(r["l1/routed/wire_words"]) - int(r["l1/elided/wire_words"])
                == cap * (SEND + REPLY))
    blocks = R.WORLD * (R.WORLD - 1) * cap
    assert int(ranks[0]["l1/plain1/stats/wire_words"]) == blocks * (
        SEND + REPLY)
    assert int(ranks[0]["l1/cached2/stats/wire_words"]) == blocks * (
        SEND + REPLY + 3)


# counted as a round is traced in the reference (a cached jitted call runs
# no Python) and as it runs in the port
TRACE_TIME = ("routing.dispatches", "routing.collects")


def test_sharded_telemetry_matches_reference(runs):
    """Each rank's ``telemetry_snapshot()`` after the lock-free
    capacity-64 table's write (its retry rounds included) and two reads,
    from a fresh registry: every counter equals the reference
    ShardedDHT's one-process snapshot of the same calls but the
    ``routing.*`` counters (trace-time there), and so does every
    histogram's count.  Merging the ranks' snapshots doubles every count,
    as merging the reference's snapshot with itself does."""
    from repro_torch.obs import merge_snapshots

    ref = json.loads(str(runs["reference"]["telemetry/snapshot"]))
    snaps = [json.loads(str(r["telemetry/snapshot"]))
             for r in runs["modes"]]
    for snap in snaps:
        got = {k: v for k, v in snap["counters"].items()
               if k not in TRACE_TIME}
        want = {k: v for k, v in ref["counters"].items()
                if k not in TRACE_TIME}
        assert got == want
        assert ({k: h["count"] for k, h in snap["histograms"].items()}
                == {k: h["count"] for k, h in ref["histograms"].items()})
    c = snaps[0]["counters"]
    retries = int(runs["modes"][0][f"lockfree/cap{R.CAP}/write/write_retries"])
    assert retries > 0 and c["engine.requeued"] > 0
    assert c["engine.rounds"] == 1 + retries + 2
    assert c["engine.ops.read"] == 2 * R.N
    merged = merge_snapshots(snaps)
    assert merged["counters"]["engine.rounds"] == 2 * c["engine.rounds"]


def test_profiled_alltoall_words_match_wire_accounting(runs):
    """The all-to-all words ``torch.profiler`` saw in one read at
    capacity 0 (``costmodel.profiled_alltoall_words``), summed over both
    legs and both ranks, against the group's ``wire_words`` lane.  Each
    rank hands ``all_to_all_single`` its whole (S * cap)-row buffer both
    ways, self block included; its wire words leave out the self block
    (elided: padding that never crosses the fabric) and add the 2S words
    of the count-exchange prologue, which travels in an ``all_reduce``.
    So profiled = (wire - world * 2S) * S / (S - 1), exactly."""
    ranks = runs["modes"]
    s = R.WORLD
    profiled = sum(int(r["telemetry/profiled_words"]) for r in ranks)
    wire = int(ranks[0]["telemetry/profiled_read/wire_words"])
    assert int(ranks[1]["telemetry/profiled_read/wire_words"]) == wire
    assert profiled > 0
    assert profiled * (s - 1) == (wire - R.WORLD * 2 * s) * s


@pytest.mark.parametrize("tier", ["plain", "cached"])
def test_async_wrappers_match_sync(runs, tier):
    """Mirrors tests/test_pipeline.py::
    test_sharded_async_closures_never_alias_sync: read_async/read_commit
    equals the synchronous read at depth 2 and 3, a write_commit updates
    every row, and a round queue commits in order."""
    ranks = runs["tier"]
    p = f"async/{tier}"
    for k in ("async", "depth3"):
        np.testing.assert_array_equal(_cat(ranks, f"{p}/{k}"),
                                      _cat(ranks, f"{p}/sync"))
    for k in ("found", "found3", "found_sync"):
        assert _cat(ranks, f"{p}/{k}").all()
    assert 0.0 <= float(ranks[0][f"{p}/overlap"]) <= 1.0
    assert int(ranks[0][f"{p}_write/updated"]) == R.N
    np.testing.assert_array_equal(ranks[0][f"{p}_queue/updated"],
                                  [len(range(i, R.N // R.WORLD, 3))
                                   * R.WORLD for i in range(3)])
    _assert_slabs(_slab(ranks, "async/cached_slab"),
                  _slab(ranks, "async/plain_slab"), "async")


@pytest.mark.parametrize("tier", ["nol1", "l1"])
def test_pipelined_schedule_matches_sync(runs, tier):
    """Mirrors tests/test_pipeline.py::
    test_sharded_pipelined_parity_l1_on_and_off: the pipelined
    lookup-or-compute over the issue/commit wrappers, with pending-write
    forwarding, is bit for bit the synchronous schedule."""
    ranks = runs["tier"]
    for i in range(4):
        p = f"pipe/{tier}/{i}"
        np.testing.assert_array_equal(_cat(ranks, f"{p}/out_p"),
                                      _cat(ranks, f"{p}/out_s"))
        np.testing.assert_array_equal(_cat(ranks, f"{p}/found_p"),
                                      _cat(ranks, f"{p}/found_s"))
    assert _cat(ranks, f"pipe/{tier}/3/found_s").any()


# ---------------------------------------------------------------------------
# the surrogate forms through the group
# ---------------------------------------------------------------------------

def _compute(x):
    return jnp.concatenate([x * 2.0, x[:, :3]], axis=-1)


def _traced():
    """The reference's traced forms (``jax.jit``) on the virtual-shard
    backend: traced auto-capacity is the whole batch at S = 2, so nothing
    drops."""
    scfg = J.SurrogateConfig(n_inputs=10, n_outputs=13, sig_digits=3,
                             dht=J.DHTConfig(n_shards=R.WORLD,
                                             buckets_per_shard=R.TIER_BUCKETS))
    loc = jax.jit(lambda st, x: J.lookup_or_compute(scfg, st, x, _compute))
    lic = jax.jit(lambda st, x: J.lookup_interpolate_or_compute(
        scfg, st, x, _compute, J.InterpConfig()))
    res = {}
    for name, fn in (("loc", loc), ("lic", lic)):
        st = J.surrogate_create(scfg)
        for i, x in enumerate(R.surrogate_inputs()):
            st, out, flag, stats = fn(st, jnp.asarray(x))
            res[f"{name}{i}"] = (np.asarray(out), np.asarray(flag),
                                 {k: np.asarray(v) for k, v in stats.items()})
        res[f"{name}_slab"] = st
    return res


def test_lookup_or_compute_through_group_matches_traced(runs):
    """The one-round get-or-put form through the group (the only form
    under a group): outputs, found flags, the group's hit/miss/stored
    counts and slab words equal the reference's traced form."""
    ranks, traced = runs["tier"], runs["traced"]
    for i in range(2):
        out, found, stats = traced[f"loc{i}"]
        np.testing.assert_array_equal(_cat(ranks, f"surr/loc{i}/out"), out)
        np.testing.assert_array_equal(_cat(ranks, f"surr/loc{i}/found"),
                                      found)
        for k in ("hits", "misses", "stored"):
            assert sum(int(r[f"surr/loc{i}/stats/{k}"]) for r in ranks) \
                == int(stats[k]), k
    assert int(traced["loc1"][2]["hits"]) > 0
    _assert_slabs(_slab(ranks, "surr/loc_slab"), traced["loc_slab"], "loc")


def test_lookup_interpolate_one_round_through_group_matches_traced(runs):
    """The one-round neighbourhood form through the group: provenance,
    stored rows and slab words equal the reference's traced form; the
    second batch interpolates its centres from cached neighbours."""
    ranks, traced = runs["tier"], runs["traced"]
    for i in range(2):
        out, prov, stats = traced[f"lic{i}"]
        # interpolated rows: the IDW blend sums and divides in another
        # order under XLA (F4), held at the repo's rtol 1e-5 for it
        np.testing.assert_allclose(_cat(ranks, f"surr/lic{i}/out"), out,
                                   rtol=1e-5)
        np.testing.assert_array_equal(_cat(ranks, f"surr/lic{i}/prov"),
                                      prov)
        assert sum(int(r[f"surr/lic{i}/stored"]) for r in ranks) \
            == int(stats["stored"])
    assert (traced["lic1"][1] == J.PROV_INTERP).any()
    _assert_slabs(_slab(ranks, "surr/lic_slab"), traced["lic_slab"], "lic")


# ---------------------------------------------------------------------------
# elastic membership on 3 ranks: the lockstep apply_ring
# ---------------------------------------------------------------------------

ELASTIC_STEPS = ("leave", "join")


def _live_pairs(slab: dict, shard: int) -> set:
    """The (key, value) words of shard ``shard``'s live buckets."""
    meta = slab["meta"][shard]
    live = ((meta & 1) != 0) & ((meta & 2) == 0)
    return {(k.tobytes(), v.tobytes()) for k, v in
            zip(slab["keys"][shard][live], slab["vals"][shard][live])}


def _assert_same_entries(got: dict, want: dict, what: str):
    """Per shard, the same live (key, value) pairs.  Slot positions may
    differ: the lockstep rounds take each rank's sources 32 at a time,
    the single-device migration the global source list 96 at a time, so
    the inserts land in another order."""
    for s in range(R.ELASTIC_WORLD):
        assert _live_pairs(got, s) == _live_pairs(want, s), f"{what} {s}"


def test_elastic_leave_join_matches_single_device_reference(runs):
    """3 gloo ranks, ``ShardedDHT.create(ring=)``: after the write, the
    leave of shard 1 and its join, every shard holds the live entries
    the reference's single-device ``shard_leave``/``shard_join`` leave
    there; the reads, ``n_live``, ``n_planned``, ``moved``, the evictions
    and the epoch are the reference's."""
    ranks, ref = runs["elastic"], runs["reference"]
    _assert_same_entries(_slab(ranks, "init"),
                         _lanes(ref, "elastic/init"), "init")
    for step in ELASTIC_STEPS:
        _assert_same_entries(_slab(ranks, f"{step}/slab"),
                             _lanes(ref, f"elastic/{step}/slab"), step)
        for row in ("out", "found", "epoch"):
            got = (_cat(ranks, f"{step}/read/{row}") if row != "epoch"
                   else ranks[0][f"{step}/read/epoch"])
            np.testing.assert_array_equal(
                got, ref[f"elastic/{step}/read/{row}"], f"{step} {row}")
        want = _lanes(ref, f"elastic/{step}/stats")
        for r in ranks:
            got = _lanes(r, f"{step}/stats")
            for k in ("n_live", "n_planned", "moved", "evicted_at_dest",
                      "epoch"):
                assert int(got[k]) == int(want[k]), (step, k)
    leave = _lanes(ranks[0], "leave/stats")
    assert 0 < int(leave["moved"]) == int(leave["n_planned"])
    assert int(leave["evicted_at_dest"]) == 0


def test_elastic_leave_join_matches_virtual_backend(runs):
    """The same changes on the port's virtual-shard backend (rank 0):
    the same live entries per shard, reads and stats."""
    ranks = runs["elastic"]
    virt = ranks[0]
    _assert_same_entries(_slab(ranks, "init"),
                         _lanes(virt, "virtual/init"), "init")
    for step in ELASTIC_STEPS:
        _assert_same_entries(_slab(ranks, f"{step}/slab"),
                             _lanes(virt, f"virtual/{step}/slab"), step)
        for row in ("out", "found"):
            np.testing.assert_array_equal(
                _cat(ranks, f"{step}/read/{row}"),
                virt[f"virtual/{step}/read/{row}"], f"{step} {row}")
        want = _lanes(virt, f"virtual/{step}/stats")
        got = _lanes(ranks[1], f"{step}/stats")
        assert set(got) <= set(want)
        for k in got:
            assert int(got[k]) == int(want[k]), (step, k)


def test_elastic_leaver_drains_and_rejoins(runs):
    """The leaver's rows hold no live entry after the leave, its entries
    went to both other ranks, and the join brings entries back; every
    row reads back found in the new epoch."""
    ranks = runs["elastic"]
    init, left, back = (_slab(ranks, p) for p in ("init", "leave/slab",
                                                  "join/slab"))
    moved = _live_pairs(init, 1)
    assert moved and not _live_pairs(left, 1)
    assert all(moved & _live_pairs(left, s) for s in (0, 2))
    assert _live_pairs(back, 1)
    for step, epoch in (("leave", 1), ("join", 2)):
        assert _cat(ranks, f"{step}/read/found").all()
        assert int(ranks[2][f"{step}/read/epoch"]) == epoch


# ---------------------------------------------------------------------------
# errors, without a group
# ---------------------------------------------------------------------------

def test_sharded_create_needs_a_group():
    import torch.distributed as dist

    from repro_torch.core import DHTConfig
    from repro_torch.core.distributed import ShardedDHT

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        ShardedDHT.create(DHTConfig(n_shards=2), device="cpu")


@pytest.mark.parametrize("method,item", [
    ("crash", "12"), ("recover", "12"), ("repair", "12"),
    ("write_replicated_fn", "12"), ("write_replicated_refresh_fn", "12"),
    ("repair_fn", "12"), ("telemetry_snapshot", "14")])
def test_later_items_raise(method, item):
    """Nothing the backend hands on raises any more.  Replication and
    repair (12) are ported (tests/test_torch_faults.py runs them on 4
    ranks): their closures are plain functions, and crash, recover and
    repair of a table with no ring raise ``ValueError``.  The telemetry
    registry (14) is ported: a group-less table's snapshot is the
    process registry's, plain JSON (the group's snapshots against the
    reference: ``test_sharded_telemetry_matches_reference``)."""
    import json

    from repro_torch.core import DHTConfig, dht_create
    from repro_torch.core.distributed import ShardedDHT
    from repro_torch.obs import get_registry

    cfg = DHTConfig(n_shards=2, buckets_per_shard=64)
    d = ShardedDHT(cfg=cfg, state=dht_create(cfg, device="cpu", shards=1),
                   group=None)
    args = {"crash": (0,), "recover": (0,), "repair": (0,)}.get(method, ())
    if item == "12" and method.endswith("_fn"):
        assert callable(getattr(d, method)())
    elif item == "12":
        with pytest.raises(ValueError, match="ring"):
            getattr(d, method)(*args)
    else:
        snap = d.telemetry_snapshot()
        assert json.loads(json.dumps(snap)) == snap
        assert snap == get_registry().snapshot()
        assert set(snap) == {"counters", "gauges", "histograms"}


def test_elastic_changes_need_a_ring_of_the_group():
    """``join`` needs a ring, ``apply_ring`` one of the table's shard
    count, and ``create`` a ring as wide as the group."""
    from repro_torch.core import DHTConfig, dht_create, ring_create
    from repro_torch.core.distributed import ShardedDHT

    cfg = DHTConfig(n_shards=2, buckets_per_shard=64)
    d = ShardedDHT(cfg=cfg, state=dht_create(cfg, device="cpu", shards=1),
                   group=None)
    assert d.ring is None
    with pytest.raises(ValueError, match="needs a ring"):
        d.join(0)
    with pytest.raises(ValueError, match="ring of 3 shards"):
        ShardedDHT.create(cfg, device="cpu", ring=ring_create(3))


def test_rank_state_holds_one_shard():
    """A rank's state: one shard's B rows (plus the dump row) while the
    cfg keeps the global S for the owner hash; the views follow the
    buffers, and the engine refuses it without a group of S ranks."""
    import torch

    from repro_torch.core import DHTConfig, dht_create, read_ops
    from repro_torch.core import dht_execute

    cfg = DHTConfig(n_shards=4, buckets_per_shard=64)
    st = dht_create(cfg, device="cpu", shards=1)
    assert st.n_local == 1 and st.flat_meta.shape[0] == 65
    assert st.keys.shape == (1, 64, cfg.key_words) and st.meta.shape == (1, 64)
    assert dht_create(cfg, device="cpu").keys.shape == (4, 64, cfg.key_words)
    with pytest.raises(ValueError, match="out of range"):
        dht_create(cfg, device="cpu", shards=5)
    # the virtual-shard backend needs the whole table: its owner is hi % S
    with pytest.raises(ValueError, match="process group"):
        dht_execute(st, read_ops(torch.zeros((8, cfg.key_words),
                                             dtype=torch.int32)),
                    kinds=("read",))
