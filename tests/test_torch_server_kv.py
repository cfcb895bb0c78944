"""The server baseline (``repro_torch.core.server_kv``, the paper's Fig. 3
contrast) against ``repro.core.server_kv`` on the same seeded inputs:
the slab words after the write, the read's values and found flags, and
the ``rounds`` each side bills."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

from repro.core import DHTConfig as JConfig
from repro.core.server_kv import server_create as j_create
from repro.core.server_kv import server_read as j_read
from repro.core.server_kv import server_write as j_write
from repro_torch.convert import state_to_numpy
from repro_torch.core import DHTConfig
from repro_torch.core.server_kv import server_create, server_read, server_write


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("n,width", [(96, 24), (100, 7)])
def test_server_baseline_roundtrip_matches_reference(n, width):
    """Mirrors tests/test_surrogate_async.py::
    test_server_baseline_roundtrip_and_serialization (96 ops at width 24
    drain in 4 rounds; a ragged last round at width 7)."""
    fields = dict(n_shards=8, buckets_per_shard=1024)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**31, size=(n, 20)).astype(np.uint32)
    vals = rng.integers(0, 2**31, size=(n, 26)).astype(np.uint32)

    js = j_create(JConfig(**fields))
    js, jws = j_write(js, jnp.asarray(keys), jnp.asarray(vals),
                      server_width=width)
    js, jout, jfound, jrs = j_read(js, jnp.asarray(keys), server_width=width)

    ts = server_create(DHTConfig(**fields), device="cpu")
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    ts, ws = server_write(ts, _t(keys), _t(vals), server_width=width)
    ts, out, found, rs = server_read(ts, _t(keys), server_width=width)

    assert ws["rounds"] == int(jws["rounds"]) == -(-n // width)
    assert rs["rounds"] == int(jrs["rounds"])
    for name, words in state_to_numpy(ts).items():
        np.testing.assert_array_equal(words, np.asarray(getattr(js, name)),
                                      name)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  np.asarray(jout))
    assert bool(found.all()) and np.array_equal(out.numpy().view(np.uint32),
                                                vals)
