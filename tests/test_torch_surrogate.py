"""The surrogate layer and the POET twin against the JAX package.

- ``lookup_or_compute`` in both forms: the port's host form against the
  reference's eager host form, the port's ``one_round=True`` get-or-put
  against the reference's jitted (traced) form, with a deterministic
  elementwise ``compute_fn`` that both frameworks evaluate bit for bit;
- ``convert.py``: a table built by the JAX package, carried into the port,
  read in both with the same results, and carried back unchanged;
- the POET twin against ``examples/poet_reactive_transport``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro_torch import core as T
from repro_torch.convert import cfg_from_dict, state_from_numpy, state_to_numpy

IDX = list(range(10)) + [0, 1, 2]          # 10 inputs -> 13 outputs


def compute_fn(x):
    """Exact in f32 on both sides (a doubling and a +1)."""
    return x[:, IDX] * 2.0 + 1.0


def _inputs(seed, n=64):
    rng = np.random.default_rng(seed)
    x = (10.0 ** rng.uniform(-3, 2, size=(n, 10))).astype(np.float32)
    x[n // 2:] = x[: n - n // 2]                    # duplicate rows
    return x


def _tables_equal(js, ts):
    for k, v in state_to_numpy(ts).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, k)), k)


def _pair(dcfg):
    js = J.dht_create(dcfg)
    ts = state_from_numpy(dataclasses.asdict(dcfg), *(
        np.asarray(getattr(js, k)) for k in ("keys", "vals", "meta", "csum")),
        device="cpu")
    return js, ts


@pytest.mark.parametrize("one_round", [False, True])
def test_lookup_or_compute_matches_reference(one_round):
    dcfg = J.DHTConfig(n_shards=4, buckets_per_shard=256)
    jcfg = J.SurrogateConfig(sig_digits=3, dht=dcfg)
    tcfg = T.SurrogateConfig(sig_digits=3, dht=cfg_from_dict(
        dataclasses.asdict(dcfg)))
    js, ts = _pair(dcfg)
    if one_round:
        jfn = jax.jit(lambda st, x: J.lookup_or_compute(jcfg, st, x,
                                                        compute_fn))
    else:
        def jfn(st, x):
            return J.lookup_or_compute(jcfg, st, x, compute_fn)
    first = _inputs(0)
    for x in (first, np.concatenate([first[:20], _inputs(1)[:44]])):
        js, jout, jfound, jst = jfn(js, jnp.asarray(x))
        ts, tout, tfound, tst = T.lookup_or_compute(
            tcfg, ts, torch.from_numpy(x), compute_fn, one_round=one_round)
        _tables_equal(js, ts)
        np.testing.assert_array_equal(tout.numpy().view(np.uint32),
                                      np.asarray(jout).view(np.uint32))
        np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
        for k in ("hits", "misses", "mismatches", "stored"):
            assert int(tst[k]) == int(jst[k]), k
    assert int(tst["hits"]) >= 20


def test_convert_round_trip_reads_alike():
    rng = np.random.default_rng(2)
    dcfg = J.DHTConfig(n_shards=4, buckets_per_shard=128)
    keys = rng.integers(0, 2**32, size=(300, 20), dtype=np.uint64).astype(
        np.uint32)
    vals = rng.integers(0, 2**32, size=(300, 26), dtype=np.uint64).astype(
        np.uint32)
    js, _ = J.dht_write(J.dht_create(dcfg), jnp.asarray(keys),
                        jnp.asarray(vals))
    arrays = {k: np.asarray(getattr(js, k))
              for k in ("keys", "vals", "meta", "csum")}
    ts = state_from_numpy(dataclasses.asdict(dcfg), **arrays, device="cpu")
    back = state_to_numpy(ts)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], k)
    q = np.concatenate([keys[::3], keys[:50] ^ np.uint32(1)])
    js, jv, jf, jst = J.dht_read(js, jnp.asarray(q))
    ts, tv, tf, tst = T.dht_read(ts, torch.from_numpy(q.view(np.int32)))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), np.asarray(jv))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert int(tst["hits"]) == int(jst["hits"]) > 0
    assert int(tst["misses"]) == int(jst["misses"]) >= 50
    with pytest.raises(ValueError):
        cfg_from_dict({"n_shards": 2, "bogus": 1})


@pytest.mark.parametrize("use_pipeline", [False, True],
                         ids=["plain", "pipeline"])
def test_poet_twin_matches_reference(use_pipeline):
    """Same hits, misses and solver calls as the JAX example, with and
    without the pipelined lookup (``use_pipeline``); ``conc``
    within rtol 1e-5.  The tolerance is the f32 chemistry in two
    frameworks: XLA's CPU backend contracts a*b+c into fused multiply-adds
    and divides by constants through their reciprocal, torch does
    neither, so the solver outputs differ in their last bits (33 of the
    2,592 words of ``conc`` here, at most 1e-6 relative; F4 in
    ROADMAP.md).  The DHT path itself is exact: those last-bit
    differences split no key at this size."""
    from examples.poet_reactive_transport import PoetConfig as JPoet
    from examples.poet_reactive_transport import run_simulation as j_run
    from examples.torch_poet_reactive_transport import PoetConfig as TPoet
    from examples.torch_poet_reactive_transport import run_simulation as t_run

    # the reference's pipelined steps hand its eager engine and jitted
    # solver a new batch shape each, so each step compiles anew: 3 steps
    kw = dict(nx=12, ny=24, n_steps=3 if use_pipeline else 6, sig_digits=3,
              solver_iters=50, use_pipeline=use_pipeline)
    ref = j_run(JPoet(**kw), use_dht=True)
    out = t_run(TPoet(**kw), use_dht=True, device="cpu")
    for k in ("hits", "misses", "chem_calls", "mismatches"):
        assert out[k] == ref[k], k
    np.testing.assert_allclose(out["conc"].numpy(), np.asarray(ref["conc"]),
                               rtol=1e-5)
    assert out["hit_rate"] > 0.3
