"""The port's crash tolerance (``repro_torch.core``: k-successor
replication, crash failover, fault injection, anti-entropy repair) against
the JAX package's, on the CPU, bit for bit.

The reference's scenarios of ``tests/test_faults.py`` run once, in six
module fixtures, at one table shape (S=4 x B=4096, batches of 256
rows: XLA compiles each program once) and keep numpy arrays; the port
makes the same calls on the same seeded inputs and is held to them after
every step: slab words, ``code``, ``acked``, ``replica_writes``,
``fallback_reads``, read outputs and found flags, the repair plan
(``src``, ``n_candidates``, ``n_present``) and ``repair_run``'s dict, and
for cached reads across a crash the values, found flags, ``l1_hits`` and
the L1's words.  The reference's own assertions are asserted on the
port's results.  The oracle interleaving runs the port's engine against
the port's ``IssueCommitOracle``.

The repair fixture first spawns one gloo group of 4 ranks
(``tests/torch_dist_ranks.py faults``), which runs while the reference
does: the
multi-rank backend with k=2 and capacity > 0 writes, loses shard 1,
reads through the failover, writes during the outage, recovers and
repairs, held against the reference's single-device run of the same
sequence and the port's virtual backend (rank 0); plus the L1 crash
fence and the write retry on overflow (k=1 and k=2), held against the
copies the routing rule lands.  One more scenario crowds the victim's
probe windows until repair cannot place every copy, and holds two
passes against the reference's.  (The reference's
own sharded crash test fails on this tree, ROADMAP.md F3, so it is no
oracle here.)
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import torch_dist_ranks as R
from repro.core import faults as jfaults
from repro.core import migrate as jmigrate
from repro.core.hashing import hash64 as jhash64
from repro.core.membership import ring_successors_np as j_succ_np
from repro_torch import core as T
from repro_torch.convert import l1_to_numpy, state_to_numpy
from repro_torch.core import faults as tfaults
from repro_torch.core.async_sim import IssueCommitOracle
from repro_torch.core.hashing import base_bucket
from repro_torch.core.layout import live_mask
from repro_torch.core.membership import ring_successors_np
from repro_torch.core.migrate import first_copies
from repro_torch.kernels import ops as kops
from repro_torch.obs import metrics as T_metrics

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TESTS = os.path.join(ROOT, "tests")
JOIN_TIMEOUT = 300          # seconds for the rank processes
S, B, N = R.FAULT_WORLD, R.FAULT_BUCKETS, R.FAULT_N
VICTIM = R.FAULT_VICTIM
SLAB = ("keys", "vals", "meta", "csum")
L1 = dict(n_sets=64, n_ways=4)


def _cfg(k, cap=N):
    return dict(n_shards=S, n_replicas=k, buckets_per_shard=B, capacity=cap)


def _jnew(k, cap=N):
    return J.dht_create(J.DHTConfig(**_cfg(k, cap)), J.ring_create(S))


def _tnew(k, cap=N):
    return T.dht_create(T.DHTConfig(**_cfg(k, cap)), T.ring_create(S),
                        device="cpu")


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


def _u(x) -> np.ndarray:
    a = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 and a.ndim > 1 else a


def _hi(keys: np.ndarray) -> np.ndarray:
    """The port's high hash word of each key row, uint32."""
    return kops.hash64(_t(keys))[:, 0].numpy().view(np.uint32)


def _jslab(st) -> dict:
    return {k: np.array(getattr(st, k)) for k in SLAB}


def _tslab(st) -> dict:
    return {k: v.copy() for k, v in state_to_numpy(st).items()}


def _assert_slab(got: dict, want: dict, what: str):
    for k in SLAB:
        np.testing.assert_array_equal(got[k], want[k], f"{what}: {k}")


def _lanes(stats, names) -> dict:
    return {k: np.asarray(stats[k]) if not torch.is_tensor(stats[k])
            else stats[k].cpu().numpy() for k in names}


def _assert_lanes(got, want, what):
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      f"{what}: {k}")


W_LANES = ("code", "acked", "replica_writes", "inserted", "updated",
           "evicted", "dropped")
R_LANES = ("hits", "misses", "dropped", "fallback_reads")
RETRY_LANES = ("code", "dropped", "rounds", "inserted", "updated", "evicted")


def _jw(st, keys, vals, **kw):
    st, ws = J.dht_write_replicated(st, jnp.asarray(keys), jnp.asarray(vals),
                                    **kw)
    return st, _lanes(ws, W_LANES)


def _jr(st, keys):
    st, out, found, rs = J.dht_read(st, jnp.asarray(keys))
    return st, {"out": np.array(out), "found": np.array(found),
                **_lanes(rs, R_LANES)}


def _tw(st, keys, vals, **kw):
    st, ws = T.dht_write_replicated(st, _t(keys), _t(vals), **kw)
    return st, ws, _lanes(ws, W_LANES)


def _tr(st, keys):
    st, out, found, rs = T.dht_read(st, _t(keys))
    return st, {"out": _u(out), "found": _u(found), **_lanes(rs, R_LANES)}


def _jplan(st, shard):
    p = jmigrate.plan_repair(st, shard)
    return {"src": np.asarray(p.src), "n_candidates": p.n_candidates,
            "n_present": p.n_present}


def _tplan(st, shard):
    p = T.plan_repair(st, shard)
    return {"src": p.src.numpy(), "n_candidates": p.n_candidates,
            "n_present": p.n_present}


def _assert_plan(got, want, what):
    np.testing.assert_array_equal(got["src"], want["src"], f"{what}: src")
    assert (got["n_candidates"], got["n_present"]) == (
        want["n_candidates"], want["n_present"]), what


def _jl1(l1) -> dict:
    return {k: np.array(getattr(l1, k))
            for k in ("keys", "vals", "csum", "gen", "owner", "wmark",
                      "epoch", "live", "shard_wmark")}


# ---------------------------------------------------------------------------
# the reference's scenarios, each run once
# ---------------------------------------------------------------------------

def _ref_crash(out):
    """Write, crash VICTIM (wiped), read through the failover, write
    during the outage, recover, read (the gap), repair, read, repair
    again: the gloo group's sequence on the single-device backend."""
    inp = R.fault_inputs()
    k1, v1, k2, v2 = (inp[n] for n in ("k1", "v1", "k2", "v2"))
    st = _jnew(2)
    st, out["w1"] = _jw(st, k1, v1)
    out["s_w1"] = _jslab(st)
    st = J.crash_shard(st, VICTIM)
    st, out["r_out1"] = _jr(st, k1)
    st, out["w2"] = _jw(st, k2, v2)
    out["s_w2"] = _jslab(st)
    st = J.recover_shard(st, VICTIM)
    st, out["r_gap1"] = _jr(st, k1)
    st, out["r_gap2"] = _jr(st, k2)
    out["plan"] = _jplan(st, VICTIM)
    st, out["rep"] = jmigrate.repair_run(st, VICTIM, batch=R.FAULT_BATCH)
    out["s_rep"] = _jslab(st)
    out["diff"] = jmigrate.repair_diff(st, VICTIM)
    st, out["r_fin1"] = _jr(st, k1)
    st, out["r_fin2"] = _jr(st, k2)
    st, out["rep2"] = jmigrate.repair_run(st, VICTIM, batch=R.FAULT_BATCH)


def _ref_writes() -> dict:
    """Replicated writes at k=1 and k=2, and a read of the k=2 table."""
    out = {}
    keys, vals = R.kv(N, 1)
    st, out["k1_write"] = _jw(_jnew(1), keys, vals)
    out["k1_slab"] = _jslab(st)

    keys, vals = R.kv(N, 2)
    st, out["fan_write"] = _jw(_jnew(2), keys, vals)
    out["fan_slab"] = _jslab(st)
    st, out["fan_read"] = _jr(st, keys)
    return out


def _ref_faults() -> dict:
    """A write with every replica of some rows down, and the injected
    faults."""
    out = {}
    keys, vals = R.kv(N, 3)
    st = J.crash_shard(J.crash_shard(_jnew(2), 0), 1)
    st, out["down_write"] = _jw(st, keys, vals)
    out["down_slab"] = _jslab(st)
    st, out["down_read"] = _jr(st, keys)

    keys, vals = R.kv(N, 8)
    with jfaults.injected(drop_frac=0.4, seed=13) as plan:
        st, out["inj_write"] = _jw(_jnew(1), keys, vals)
    out["inj_n"] = plan.injected
    out["inj_slab"] = _jslab(st)
    st, _ = _jw(_jnew(1), keys, vals)
    with jfaults.injected(drop_frac=1.0, seed=13) as plan:
        st, out["inj_read"] = _jr(st, keys)
    out["inj_read_n"] = plan.injected
    with jfaults.injected(drop_frac=0.25, seed=3) as plan:
        st, out["inj_rep"] = _jw(_jnew(2), keys, vals)
    out["inj_rep_n"] = plan.injected
    out["inj_rep_slab"] = _jslab(st)
    return out


def _ref_repair() -> dict:
    """The crash sequence."""
    out = {}
    _ref_crash(out)
    return out


def _ref_plan() -> dict:
    """The repair plan's diff, step by step."""
    out = {}
    keys, vals = R.kv(N, 7)
    st, _ = _jw(_jnew(2), keys, vals)
    out["plan_healthy"] = _jplan(st, 2)
    st = J.recover_shard(J.crash_shard(st, 2), 2)
    out["plan_wiped"] = _jplan(st, 2)
    rep = jmigrate.repair_begin(st, 2, batch=R.FAULT_BATCH)
    rep, out["plan_step"] = jmigrate.repair_step(rep)
    out["plan_step_slab"] = _jslab(rep.state)
    out["plan_after"] = _jplan(rep.state, 2)
    return out


CROWD_REGION = 16      # window bases [0, 16) of every shard
CROWD_KEYS = 96        # rows there with VICTIM in their replica set


def _crowded() -> tuple[np.ndarray, np.ndarray]:
    """A batch of N rows: CROWD_KEYS whose replica set holds VICTIM and
    whose probe window starts below CROWD_REGION (VICTIM's buckets there
    cannot hold all their copies), the rest with VICTIM outside their
    replica set."""
    pool_keys, pool_vals = R.kv(1 << 17, 11)
    h = kops.hash64(_t(pool_keys))
    succ = ring_successors_np(T.ring_create(S), h[:, 0].numpy().view(
        np.uint32), 2)
    base = base_bucket(h[:, 1], B, T.DHTConfig(**_cfg(2)).n_probe).numpy()
    held = (succ == VICTIM).any(axis=1)
    rows = np.concatenate([np.nonzero(held & (base < CROWD_REGION))[0][
        :CROWD_KEYS], np.nonzero(~held)[0][:N - CROWD_KEYS]])
    return pool_keys[rows], pool_vals[rows]


def _ref_full_windows() -> dict:
    """Repair where VICTIM's windows overflow: the crowded batch, the
    crash and recovery, and two repair passes."""
    out = {}
    keys, vals = _crowded()
    st, out["write"] = _jw(_jnew(2), keys, vals)
    out["s_write"] = _jslab(st)
    st = J.recover_shard(J.crash_shard(st, VICTIM), VICTIM)
    for p in (1, 2):
        out[f"plan{p}"] = _jplan(st, VICTIM)
        st, out[f"rep{p}"] = jmigrate.repair_run(st, VICTIM,
                                                 batch=R.FAULT_BATCH)
        out[f"s_rep{p}"] = _jslab(st)
    out["diff"] = jmigrate.repair_diff(st, VICTIM)
    return out


def _ref_retry() -> dict:
    """The eager write retry: on a capacity overflow, under a plan."""
    out = {}
    keys, vals = R.kv(N, 5)
    jk, jv = jnp.asarray(keys), jnp.asarray(vals)
    cap = R.FAULT_RETRY_CAP
    _, ws0 = J.dht_write(_jnew(1, cap), jk, jv)
    out["overflow_single"] = _lanes(ws0, ("code", "dropped"))
    st, ws = J.dht_write(_jnew(1, cap), jk, jv, max_retries=2)
    out["overflow"] = _lanes(ws, RETRY_LANES)
    out["overflow_slab"] = _jslab(st)
    with jfaults.injected(drop_frac=0.3, seed=5) as plan:
        st, ws = J.dht_write(_jnew(1), jk, jv, max_retries=2)
    out["injected_n"] = plan.injected
    out["injected"] = _lanes(ws, RETRY_LANES)
    out["injected_slab"] = _jslab(st)
    return out


def _ref_cached() -> dict:
    """Cached reads under replication: fill, hot, the crash, refill."""
    keys, vals = R.kv(N, 9)
    st, _ = _jw(_jnew(2), keys, vals)
    l1 = J.l1_create(J.L1Config(**L1), S)
    reads = []
    for step in range(4):
        if step == 2:
            st = J.crash_shard(st, VICTIM)
        st, l1, o, f, rs = J.dht_read_cached(st, l1, jnp.asarray(keys))
        reads.append({"out": np.array(o), "found": np.array(f),
                      **_lanes(rs, ("l1_hits", "fallback_reads", "hits")),
                      "l1": _jl1(l1)})
    return {"reads": reads, "slab": _jslab(st)}


# ---------------------------------------------------------------------------
# the fixture: the gloo group and the reference, at once
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def repair_ref(tmp_path_factory):
    """The gloo group's rows, spawned first, and the reference's crash
    sequence, run while the ranks do."""
    out = tmp_path_factory.mktemp("faults")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "torch_dist_ranks.py"),
         "faults", str(r), str(S), str(port), str(out)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for r in range(S)]
    try:
        res = _ref_repair()
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=JOIN_TIMEOUT)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r}: no exit within "
                                     f"{JOIN_TIMEOUT} s (a hang?)")
            assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res["ranks"] = [dict(np.load(out / f"faults_rank{r}.npz"))
                    for r in range(S)]
    return res


@pytest.fixture(scope="module")
def plan_ref():
    return _ref_plan()


@pytest.fixture(scope="module")
def windows_ref():
    return _ref_full_windows()


@pytest.fixture(scope="module")
def writes_ref():
    return _ref_writes()


@pytest.fixture(scope="module")
def faults_ref():
    return _ref_faults()


@pytest.fixture(scope="module")
def retry_ref():
    return _ref_retry()


@pytest.fixture(scope="module")
def cached_ref():
    return _ref_cached()


@pytest.fixture(autouse=True)
def _no_plan():
    tfaults.clear()
    yield
    tfaults.clear()


# ---------------------------------------------------------------------------
# replicated writes
# ---------------------------------------------------------------------------

def test_replicated_k1_bit_identical(writes_ref):
    """n_replicas=1 IS dht_write: the same words and codes, and the
    reference's."""
    ref = writes_ref
    keys, vals = R.kv(N, 1)
    st_a = _tnew(1)
    st_a, ws_a = T.dht_write(st_a, _t(keys), _t(vals))
    st_b, ws_b, lanes = _tw(_tnew(1), keys, vals)
    _assert_slab(_tslab(st_b), _tslab(st_a), "k=1 vs dht_write")
    assert torch.equal(ws_a["code"], ws_b["code"])
    assert int(ws_b["replica_writes"]) == 0 and int(ws_b["acked"]) == N
    _assert_slab(_tslab(st_b), ref["k1_slab"], "k=1 vs reference")
    _assert_lanes(lanes, ref["k1_write"], "k=1 lanes")


def test_replicated_write_acks_and_fans_out(writes_ref):
    ref = writes_ref
    keys, vals = R.kv(N, 2)
    st, ws, lanes = _tw(_tnew(2), keys, vals)
    assert int(ws["acked"]) == N and int(ws["replica_writes"]) == N
    assert int(ws["dropped"]) == 0
    _assert_lanes(lanes, ref["fan_write"], "fan-out write")
    _assert_slab(_tslab(st), ref["fan_slab"], "fan-out slab")
    st, rd = _tr(st, keys)
    assert rd["found"].all() and (rd["out"] == vals).all()
    assert int(rd["fallback_reads"]) == 0        # healthy: owners serve
    _assert_lanes(rd, ref["fan_read"], "fan-out read")
    # the fan-out is one dispatch round whose wire words are exactly k
    # times the k=1 write's at the same capacity; a healthy read moves the
    # same words at k=2 as at k=1
    with T_metrics.counting() as rounds2:
        _tw(_tnew(2), keys, vals)
    with T_metrics.counting() as rounds1:
        st1, ws1 = T.dht_write(_tnew(1), _t(keys), _t(vals))
    assert rounds2.delta == rounds1.delta == 1
    assert int(ws["wire_words"]) == 2 * int(ws1["wire_words"])
    _, _, _, rs1 = T.dht_read(st1, _t(keys))
    _, _, _, rs2 = T.dht_read(st, _t(keys))
    assert int(rs1["wire_words"]) == int(rs2["wire_words"])


def test_all_replicas_down_rows_drop_not_ack(faults_ref):
    """A row whose whole replica set is dead reports W_DROPPED, unacked,
    like an overflow."""
    ref = faults_ref
    keys, vals = R.kv(N, 3)
    st = T.crash_shard(T.crash_shard(_tnew(2), 0), 1)
    succ = ring_successors_np(st.ring, _hi(keys), 2)
    doomed = np.isin(succ, (0, 1)).all(axis=1)
    assert doomed.any() and not doomed.all()
    st, ws, lanes = _tw(st, keys, vals)
    code = ws["code"].numpy()
    assert (code[doomed] == T.W_DROPPED).all()
    assert (code[~doomed] != T.W_DROPPED).all()
    assert int(ws["acked"]) == int((~doomed).sum())
    _assert_lanes(lanes, ref["down_write"], "all-down write")
    _assert_slab(_tslab(st), ref["down_slab"], "all-down slab")
    st, rd = _tr(st, keys)
    assert not rd["found"][doomed].any() and rd["found"][~doomed].all()
    _assert_lanes(rd, ref["down_read"], "all-down read")


# ---------------------------------------------------------------------------
# crash -> failover -> recover -> repair
# ---------------------------------------------------------------------------

def _port_crash() -> dict:
    """The port's run of ``_ref_crash``."""
    out = {}
    inp = R.fault_inputs()
    k1, v1, k2, v2 = (inp[n] for n in ("k1", "v1", "k2", "v2"))
    st, _, out["w1"] = _tw(_tnew(2), k1, v1)
    out["s_w1"] = _tslab(st)
    st = T.crash_shard(st, VICTIM)
    st, out["r_out1"] = _tr(st, k1)
    st, _, out["w2"] = _tw(st, k2, v2)
    out["s_w2"] = _tslab(st)
    st = T.recover_shard(st, VICTIM)
    st, out["r_gap1"] = _tr(st, k1)
    st, out["r_gap2"] = _tr(st, k2)
    out["plan"] = _tplan(st, VICTIM)
    st, out["rep"] = T.repair_run(st, VICTIM, batch=R.FAULT_BATCH)
    out["s_rep"] = _tslab(st)
    out["diff"] = T.repair_diff(st, VICTIM)
    st, out["r_fin1"] = _tr(st, k1)
    st, out["r_fin2"] = _tr(st, k2)
    st, out["rep2"] = T.repair_run(st, VICTIM, batch=R.FAULT_BATCH)
    out["owners"] = ring_successors_np(
        st.ring, _hi(k1), 1)[:, 0]
    return out


@pytest.fixture(scope="module")
def crash_run():
    return _port_crash()


def test_crash_failover_reads_bit_identical(repair_ref, crash_run):
    ref, got = repair_ref, crash_run
    k1, v1 = (R.fault_inputs()[n] for n in ("k1", "v1"))
    rd = got["r_out1"]
    assert rd["found"].all() and (rd["out"] == v1).all()
    # failover is a routing decision: exactly the victim-owned keys
    assert int(rd["fallback_reads"]) == int((got["owners"] == VICTIM).sum())
    for step in ("w1", "r_out1", "w2"):
        _assert_lanes(got[step], ref[step], step)
    for step in ("s_w1", "s_w2"):
        _assert_slab(got[step], ref[step], step)
    assert int(got["w2"]["acked"]) == N          # writes during the outage


def test_availability_gap_closed_by_repair(repair_ref, crash_run):
    ref, got = repair_ref, crash_run
    inp = R.fault_inputs()
    # recovered but unrepaired: the owner serves from an empty slab
    assert ((~got["r_gap1"]["found"]) == (got["owners"] == VICTIM)).all()
    for step in ("r_gap1", "r_gap2", "r_fin1", "r_fin2"):
        _assert_lanes(got[step], ref[step], step)
    _assert_plan(got["plan"], ref["plan"], "repair plan")
    assert got["rep"] == ref["rep"] and got["rep"]["healed"] > 0
    _assert_slab(got["s_rep"], ref["s_rep"], "repaired slab")
    assert got["diff"] == ref["diff"] == 0
    for i in (1, 2):
        rd = got[f"r_fin{i}"]
        assert rd["found"].all() and (rd["out"] == inp[f"v{i}"]).all()
        assert int(rd["fallback_reads"]) == 0
    # idempotent: a second pass finds nothing to heal
    assert got["rep2"] == ref["rep2"]
    assert got["rep2"]["healed"] == 0 and got["rep2"]["rounds"] == 0


def test_repair_plan_watermark_diff(plan_ref):
    ref = plan_ref
    keys, vals = R.kv(N, 7)
    st, _, _ = _tw(_tnew(2), keys, vals)
    healthy = _tplan(st, 2)
    _assert_plan(healthy, ref["plan_healthy"], "healthy plan")
    assert healthy["src"].size == 0
    assert healthy["n_candidates"] == healthy["n_present"]
    st = T.recover_shard(T.crash_shard(st, 2), 2)
    wiped = _tplan(st, 2)
    _assert_plan(wiped, ref["plan_wiped"], "wiped plan")
    assert wiped["n_present"] == 0
    assert wiped["src"].size == wiped["n_candidates"] > 0
    rep = T.repair_begin(st, 2, batch=R.FAULT_BATCH)
    rep, step = T.repair_step(rep)
    assert step == ref["plan_step"]
    assert step["healed"] == min(R.FAULT_BATCH, wiped["src"].size)
    _assert_slab(_tslab(rep.state), ref["plan_step_slab"], "after a step")
    after = _tplan(rep.state, 2)
    _assert_plan(after, ref["plan_after"], "re-plan")
    assert after["src"].size == wiped["src"].size - step["healed"]


def test_repair_full_windows_matches_reference(windows_ref):
    """Where the recovered shard's probe windows cannot hold every copy,
    repair does not converge, in the reference as in the port: a repair
    insert into a full window evicts a copy healed before it.  Every
    step's slab words, plan and ``repair_run`` dict are the reference's,
    the second pass leaves as many copies missing as it planned, and each
    of them faces a window on VICTIM full of other keys."""
    ref = windows_ref
    keys, vals = _crowded()
    st, _, lanes = _tw(_tnew(2), keys, vals)
    _assert_lanes(lanes, ref["write"], "crowded write")
    _assert_slab(_tslab(st), ref["s_write"], "crowded write")
    st = T.recover_shard(T.crash_shard(st, VICTIM), VICTIM)
    for p in (1, 2):
        _assert_plan(_tplan(st, VICTIM), ref[f"plan{p}"], f"pass {p}")
        st, rep = T.repair_run(st, VICTIM, batch=R.FAULT_BATCH)
        assert rep == ref[f"rep{p}"], f"pass {p}"
        _assert_slab(_tslab(st), ref[f"s_rep{p}"], f"pass {p}")
    diff = T.repair_diff(st, VICTIM)
    assert diff == ref["diff"] == ref["rep2"]["n_planned"] > 0
    src = T.plan_repair(st, VICTIM).src
    cfg = st.cfg
    base = base_bucket(kops.hash64(st.flat_keys[src])[:, 1],
                       cfg.buckets_per_shard, cfg.n_probe)
    win = (VICTIM * cfg.buckets_per_shard + base.long()[:, None]
           + torch.arange(cfg.n_probe))
    assert bool(live_mask(st.flat_meta[win]).all())


def test_first_copies_splits_hash_collisions():
    """The dedupe groups copies by their hash word and compares rows
    inside a group: a forced collision of two keys keeps both, while a
    key's later copies go, as np.unique(axis=0, return_index=True)."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 50, size=(200, 3)).astype(np.int32)
    rows[rng.integers(0, 200, 60)] = rows[rng.integers(0, 200, 60)]
    h64 = torch.from_numpy(rows[:, 0].astype(np.int64) % 7)   # collide
    keep = first_copies(h64, lambda pos: torch.from_numpy(rows)[pos])
    _, first = np.unique(rows, axis=0, return_index=True)
    want = np.zeros(200, bool)
    want[first] = True
    np.testing.assert_array_equal(keep.numpy(), want)


class _HostLiveness:
    """A ring's host liveness array that may be read for its shape only."""

    def __init__(self, n):
        self.shape = (n,)

    def __getitem__(self, i):
        raise AssertionError("a replicated round read the host liveness")

    __array__ = __iter__ = __getitem__


def test_replicated_rounds_read_no_host_liveness():
    """Writes, reads and cached reads under replication take the
    liveness bits from the ring's device twin: with the host array
    unreadable they give what they give with it."""
    import dataclasses

    keys, vals = R.kv(N, 11)
    got = []
    for poison in (False, True):
        st = T.crash_shard(_tnew(2), VICTIM)
        if poison:
            st.ring = dataclasses.replace(st.ring, alive=_HostLiveness(S))
        st, ws, lanes = _tw(st, keys, vals)
        st, rd = _tr(st, keys)
        l1 = T.l1_create(T.L1Config(**L1), S, device="cpu")
        st, l1, o, f, rs = T.dht_read_cached(st, l1, _t(keys))
        got.append((lanes, rd, _u(o), _u(f), int(rs["fallback_reads"]),
                    int(ws["evicted_copies"]), _tslab(st)))
    (a_w, a_r, a_o, a_f, a_fb, a_ev, a_s), b = got[0], got[1]
    _assert_lanes(b[0], a_w, "write")
    _assert_lanes(b[1], a_r, "read")
    assert (b[2] == a_o).all() and (b[3] == a_f).all() and b[4] == a_fb > 0
    assert b[5] == a_ev == int(a_w["evicted"])
    _assert_slab(b[6], a_s, "slab")


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

def test_fault_injection_deterministic_drops(faults_ref):
    ref = faults_ref
    keys, vals = R.kv(N, 8)

    def run():
        with T.injected(drop_frac=0.4, seed=13) as plan:
            st, _, lanes = _tw(_tnew(1), keys, vals)
        return st, lanes, plan.injected

    st, lanes_a, n_a = run()
    _, lanes_b, n_b = run()
    assert 0 < n_a < N
    assert (lanes_a["code"] == T.W_DROPPED).sum() == n_a
    # the same plan and call sequence: the same faults, bit for bit, and
    # the reference's
    assert n_a == n_b == ref["inj_n"]
    _assert_lanes(lanes_a, ref["inj_write"], "injected write")
    _assert_lanes(lanes_b, ref["inj_write"], "injected write, again")
    _assert_slab(_tslab(st), ref["inj_slab"], "injected slab")
    # reads are not eligible by default ("write", "migrate")
    st, _, _ = _tw(_tnew(1), keys, vals)
    with T.injected(drop_frac=1.0, seed=13) as plan:
        st, rd = _tr(st, keys)
    assert rd["found"].all() and plan.injected == ref["inj_read_n"] == 0
    # a replicated round's plan drops copies: the same mask over n * k
    with T.injected(drop_frac=0.25, seed=3) as plan:
        st, _, lanes = _tw(_tnew(2), keys, vals)
    assert plan.injected == ref["inj_rep_n"] > 0
    _assert_lanes(lanes, ref["inj_rep"], "injected replicated write")
    _assert_slab(_tslab(st), ref["inj_rep_slab"], "injected replicated")


@pytest.mark.parametrize("cause", ["overflow", "injected"])
def test_eager_write_retry(retry_ref, cause):
    """``dht_write(max_retries=2)`` re-issues the rows a fixed capacity
    dropped, or an injected plan dropped, as the reference does; the
    default stays the single round."""
    ref = retry_ref
    keys, vals = R.kv(N, 5)
    if cause == "overflow":
        cap = R.FAULT_RETRY_CAP
        _, ws0 = T.dht_write(_tnew(1, cap), _t(keys), _t(vals))
        assert int(ws0["dropped"]) > 0
        _assert_lanes(_lanes(ws0, ("code", "dropped")),
                      ref["overflow_single"], "single round")
        st, ws = T.dht_write(_tnew(1, cap), _t(keys), _t(vals),
                             max_retries=2)
    else:
        with T.injected(drop_frac=0.3, seed=5) as plan:
            st, ws = T.dht_write(_tnew(1), _t(keys), _t(vals),
                                 max_retries=2)
        assert plan.injected == ref["injected_n"] > 0
    _assert_lanes(_lanes(ws, RETRY_LANES), ref[cause], f"retry ({cause})")
    _assert_slab(_tslab(st), ref[f"{cause}_slab"], f"retry ({cause})")
    assert int(ws["rounds"]) > 1
    landed = ws["code"].numpy() != T.W_DROPPED
    # an injected plan drops rows of the retry rounds too
    assert int(ws["dropped"]) == int((~landed).sum())
    assert landed.all() if cause == "overflow" else landed.mean() > 0.9
    # read back in thin chunks (a full batch would overflow the window)
    for lo in range(0, N, 64):
        _, got, found, _ = T.dht_read(st, _t(keys[lo:lo + 64]))
        np.testing.assert_array_equal(found.numpy(), landed[lo:lo + 64])
        assert (_u(got)[found.numpy()] == vals[lo:lo + 64][found]).all()


# ---------------------------------------------------------------------------
# the L1 across a crash
# ---------------------------------------------------------------------------

def test_cached_read_across_crash(cached_ref):
    """dht_read_cached under replication: the crash's epoch bump fences
    every cached line, the next read fails over, bit for bit the
    reference's (values, found, l1_hits, fallback_reads, L1 words)."""
    ref = cached_ref["reads"]
    keys, vals = R.kv(N, 9)
    st, _, _ = _tw(_tnew(2), keys, vals)
    l1 = T.l1_create(T.L1Config(**L1), S, device="cpu")
    for step in range(4):
        if step == 2:
            st = T.crash_shard(st, VICTIM)
        st, l1, o, f, rs = T.dht_read_cached(st, l1, _t(keys))
        got = {"out": _u(o), "found": _u(f),
               **_lanes(rs, ("l1_hits", "fallback_reads", "hits"))}
        want = ref[step]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], f"{step}: {k}")
        l1w = l1_to_numpy(l1)
        for k, v in want["l1"].items():
            np.testing.assert_array_equal(l1w[k], v, f"{step}: l1 {k}")
        assert bool(f.all()) and (_u(o) == vals).all()
    assert ref[1]["l1_hits"] > 0 and ref[2]["l1_hits"] == 0
    assert ref[2]["fallback_reads"] > 0 and ref[3]["l1_hits"] > 0
    _assert_slab(_tslab(st), cached_ref["slab"], "cached slab")


# ---------------------------------------------------------------------------
# IssueCommitOracle: crash/recover/repair transitions, interleavings
# ---------------------------------------------------------------------------

def _placement(pool_keys: np.ndarray, ring, k):
    succ = ring_successors_np(ring, _hi(pool_keys), k)
    index = {pool_keys[i].tobytes(): i for i in range(pool_keys.shape[0])}

    def place(key):
        row = np.ascontiguousarray(np.asarray(key, np.uint32)).tobytes()
        return tuple(int(x) for x in succ[index[row]])

    return place


def test_oracle_transitions():
    keys, vals = R.kv(64, 9)
    ring = T.ring_create(4)
    # the port's placement is the reference's, word for word
    jh = np.asarray(jhash64(jnp.asarray(keys))[0])
    np.testing.assert_array_equal(
        ring_successors_np(ring, jh, 2), j_succ_np(J.ring_create(4), jh, 2))
    orc = IssueCommitOracle(n_shards=4, placement=_placement(keys, ring, 2))
    orc.commit(orc.issue_write(keys, vals))
    _, found = orc.commit(orc.issue_read(keys))
    assert all(found)
    owners = ring_successors_np(ring, jh, 1)[:, 0]
    victim = int(np.bincount(owners, minlength=4).argmax())
    orc.crash(victim)
    _, found = orc.commit(orc.issue_read(keys))
    assert all(found)
    orc.recover(victim)
    _, found = orc.commit(orc.issue_read(keys))
    assert [not f for f in found] == (owners == victim).tolist()
    healed = orc.repair(victim, keys)
    assert healed > 0 and orc.repair(victim, keys) == 0
    _, found = orc.commit(orc.issue_read(keys))
    assert all(found)


def test_oracle_interleaving_matches_engine():
    """Random crash / recover+repair / write schedules: the port's
    replicated engine's reads match the oracle's, value for value."""
    s, k, n_pool = 4, 2, 96
    pool_keys, pool_vals = R.kv(n_pool, 10)
    st = _tnew(2, n_pool)
    orc = IssueCommitOracle(n_shards=s,
                            placement=_placement(pool_keys, st.ring, k))
    rng = np.random.default_rng(42)
    alive = [True] * s
    for step in range(30):
        op = rng.choice(["write", "crash", "recover"], p=[0.5, 0.25, 0.25])
        if op == "write":
            idx = rng.choice(n_pool, size=8, replace=False)
            st, _, _ = _tw(st, pool_keys[idx], pool_vals[idx])
            orc.commit(orc.issue_write(pool_keys[idx], pool_vals[idx]))
        elif op == "crash" and sum(alive) > 1:
            v = int(rng.choice([i for i in range(s) if alive[i]]))
            st = T.crash_shard(st, v)
            orc.crash(v)
            alive[v] = False
        elif op == "recover" and not all(alive):
            d = int(rng.choice([i for i in range(s) if not alive[i]]))
            st = T.recover_shard(st, d)
            st, _ = T.repair_run(st, d, batch=64)
            orc.recover(d)
            orc.repair(d, pool_keys)
            alive[d] = True
        st, rd = _tr(st, pool_keys)
        ovals, ofound = orc.commit(orc.issue_read(pool_keys))
        assert rd["found"].tolist() == ofound, f"step {step}"
        for i in np.nonzero(rd["found"])[0]:
            assert (rd["out"][i] == ovals[i]).all(), (step, i)


# ---------------------------------------------------------------------------
# the multi-rank backend: 4 gloo ranks
# ---------------------------------------------------------------------------

def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _rank_slab(ranks, prefix):
    return {k: np.concatenate([r[f"{prefix}/{k}"] for r in ranks])
            for k in SLAB}


def test_sharded_crash_failover_repair(repair_ref):
    """k=2, capacity > 0 on 4 ranks: every step's slab words, rows and
    group lanes equal the reference's single-device run and the port's
    virtual backend; the repair converges (``diff_after == 0``)."""
    ref, ranks = repair_ref, repair_ref["ranks"]
    for slab in ("s_w1", "s_w2", "s_rep"):
        got = _rank_slab(ranks, f"sharded/{slab}")
        _assert_slab(got, ref[slab], f"sharded {slab}")
        _assert_slab(got, {k: ranks[0][f"virtual/{slab}/{k}"] for k in SLAB},
                     f"virtual {slab}")
    for step in ("w1", "w2"):
        np.testing.assert_array_equal(
            _cat(ranks, f"sharded/{step}/code"), ref[step]["code"], step)
        for lane in ("acked", "replica_writes"):
            assert int(ranks[0][f"sharded/{step}/{lane}"]) == int(
                ref[step][lane]), (step, lane)
    for step in ("r_out1", "r_gap1", "r_gap2", "r_fin1", "r_fin2"):
        for row in ("out", "found"):
            np.testing.assert_array_equal(
                _cat(ranks, f"sharded/{step}/{row}"), ref[step][row],
                f"{step}: {row}")
        for lane in ("hits", "misses", "fallback_reads"):
            assert int(ranks[0][f"sharded/{step}/{lane}"]) == int(
                ref[step][lane]), (step, lane)
    rep = {k: int(ranks[0][f"sharded/rep/{k}"]) for k in ref["rep"]}
    assert rep == ref["rep"]
    assert int(ranks[0]["sharded/rep/diff_after"]) == 0
    rep2 = {k: int(ranks[0][f"sharded/rep2/{k}"]) for k in ref["rep2"]}
    assert rep2 == ref["rep2"]


def test_sharded_l1_crash_fence(repair_ref):
    """The crash's epoch bump fences every line cached before it: the
    first read after serves no L1 hit and stays bit for bit, the next
    refills at the new epoch."""
    ranks = repair_ref["ranks"]
    _, vals = R.kv(N, 9)
    hits = [int(ranks[0][f"fence/{i}/l1_hits"]) for i in range(4)]
    assert hits[1] > 0 and hits[2] == 0 and hits[3] > 0, hits
    for i in range(4):
        assert _cat(ranks, f"fence/{i}/found").all()
        np.testing.assert_array_equal(_cat(ranks, f"fence/{i}/out"), vals)
    assert int(ranks[0]["fence/2/fallback_reads"]) > 0


def _retry_model(keys: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Which copies the sharded write with retry lands, from the routing
    rule alone: each rank bins its rows' copies by destination in flat
    (row, replica) order, ``k * cap`` slots a destination, later copies
    dropped; a row none of whose copies got a slot is re-issued, for up
    to two more rounds, every rank's at once.  Every shard is live and no
    window fills at this load.  Returns ``(succ, landed)``, (N, k)."""
    succ = ring_successors_np(T.ring_create(S), _hi(keys), k)
    cap, per = k * R.FAULT_SHARDED_RETRY_CAP, N // S
    landed = np.zeros((N, k), bool)
    pending = np.ones(N, bool)
    for _ in range(3):
        for r in range(S):
            used = np.zeros(S, np.int64)
            for i in range(r * per, (r + 1) * per):
                if pending[i]:
                    for j in range(k):
                        landed[i, j] = used[succ[i, j]] < cap
                        used[succ[i, j]] += 1
        pending = ~landed.any(axis=1)
        if not pending.any():
            break
    return succ, landed


def _live_keys(slab: dict) -> list[set]:
    """Per shard, the key rows (as bytes) of its live buckets."""
    live = live_mask(torch.from_numpy(slab["meta"].view(np.int32))).numpy()
    return [{slab["keys"][s, b].tobytes() for b in np.nonzero(live[s])[0]}
            for s in range(S)]


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_write_retry_on_overflow(repair_ref, k):
    """A capacity below the bin loads drops rows in round 1; the
    group-agreed retry re-issues exactly the rows none of whose copies
    landed.  The slabs hold exactly the copies the routing rule lands
    (``_retry_model``), the codes and stat lanes agree with it, and a
    read (routed to the owner) finds a row where its owner's copy is
    live, with its value."""
    ranks = repair_ref["ranks"]
    p = f"retry{k}"
    keys, vals = R.kv(N, 5)
    succ, landed = _retry_model(keys, k)
    assert int(ranks[0][f"{p}/first_dropped"]) > 0
    assert int(ranks[0][f"{p}/write_retries"]) >= 1
    # every row lands; at k=2 some only on one copy (not re-issued)
    assert landed.any(axis=1).all() and landed.all() == (k == 1)
    np.testing.assert_array_equal(_cat(ranks, f"{p}/code") != T.W_DROPPED,
                                  landed.any(axis=1))
    assert int(ranks[0][f"{p}/dropped"]) == 0
    if k > 1:       # the replicated write's lanes
        assert int(ranks[0][f"{p}/acked"]) == N
        assert int(ranks[0][f"{p}/replica_writes"]) == landed.sum() - N
    live = _live_keys(_rank_slab(ranks, f"{p}/slab"))
    for s in range(S):
        want = {keys[i].tobytes() for i, j in zip(*np.nonzero(landed))
                if succ[i, j] == s}
        assert live[s] == want, f"shard {s}"
    found = _cat(ranks, f"{p}/found")
    owner_live = np.array([keys[i].tobytes() in live[succ[i, 0]]
                           for i in range(N)])
    np.testing.assert_array_equal(found, owner_live)
    np.testing.assert_array_equal(found, landed[:, 0])
    np.testing.assert_array_equal(_cat(ranks, f"{p}/out")[found],
                                  vals[found])
