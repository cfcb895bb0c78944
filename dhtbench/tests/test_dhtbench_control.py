"""The comparison that decides ``correct`` fails what it must: the
control (the reference put in the program's place with a guarantee
broken, or in the precision below the configuration's) reads past the
limits, and a run with the timed path broken underneath comes out not
correct, once for each fault a one-chip cell can have."""
import pytest
import torch

import dhtbench_tiny as tiny
import limits
from dhtb import cell, manifest


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails_a_limit(name):
    spec = tiny.tiny_spec(name)
    r = limits.readings(spec, 41, 0.5, "cpu")
    ref = manifest.load_module("reference", spec["kind"])
    assert all(c["ok"] for c in cell.limits_of(ref, r["program"]).values())
    assert not all(c["ok"] for c in cell.limits_of(ref, r["control"]).values())


def _unchanged_state(monkeypatch):
    """A write step that leaves the table as it was."""
    from repro_torch.core import op_engine

    def no_write(state, abs_base, keys, vals, active):
        wsel, kind = op_engine._choose_write_slot(state, abs_base, keys)
        return kind, torch.zeros_like(active)
    monkeypatch.setattr(op_engine, "_write_pass", no_write)


def _half_batch(monkeypatch):
    """Half of each round's rows left out."""
    from repro_torch.core import op_engine

    orig = op_engine.dht_issue

    def halved(state, ops, **kw):
        keep = torch.arange(ops.valid.shape[0]) % 2 == 0
        ops = op_engine.OpBatch(keys=ops.keys, valid=ops.valid & keep,
                                op=ops.op, vals=ops.vals, esel=ops.esel)
        return orig(state, ops, **kw)
    monkeypatch.setattr(op_engine, "dht_issue", halved)
    monkeypatch.setattr("repro_torch.core.dht_issue", halved)
    monkeypatch.setattr("repro_torch.core.dht.dht_issue", halved)


def _altered_answer(monkeypatch):
    """One value word of one found answer altered where the probe makes
    it."""
    from repro_torch.kernels import ops

    orig = ops.probe

    def altered(*args, **kw):
        val, found, rsel = orig(*args, **kw)
        hit = torch.nonzero(found == 1)
        if hit.numel():
            val = val.clone()
            val[hit[-1, 0], 0] ^= 1
        return val, found, rsel
    monkeypatch.setattr(ops, "probe", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    spec = tiny.tiny_spec(name)
    fault(monkeypatch)
    result, checks = tiny.run_tiny(spec)
    assert not result["correct"], checks
