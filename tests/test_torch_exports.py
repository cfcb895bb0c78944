"""``repro_torch.core`` exports every public name of ``repro.core`` whose
home module is ported, so code can swap one package for the other.  Names
whose port waits for a later ROADMAP item would be listed with that item;
none is left."""
import importlib
import types

import repro.core as jcore
import repro_torch.core as tcore

# modules of repro.core with a port file under repro_torch/core/
PORTED = ("neighbors", "hashing", "layout", "dht", "surrogate", "interp",
          "l1cache", "op_engine", "pipeline", "membership", "migrate",
          "faults")

# public names of ported modules whose port is still to come: ROADMAP item
WAITING: dict = {}


def _home(name):
    """The ported module of repro.core that defines ``name``, or None."""
    obj = getattr(jcore, name)
    mod = getattr(obj, "__module__", None)
    if isinstance(mod, str) and mod.startswith("repro.core."):
        short = mod.rsplit(".", 1)[1]
        return short if short in PORTED else None
    # constants carry no __module__: the first ported module holding them
    for short in PORTED:
        if getattr(importlib.import_module(f"repro.core.{short}"), name,
                   None) is obj:
            return short
    return None


def _ported_names():
    return sorted(
        n for n in dir(jcore)
        if not n.startswith("_")
        and not isinstance(getattr(jcore, n), types.ModuleType)
        and _home(n) is not None)


def test_core_exports_every_ported_name():
    names = _ported_names()
    assert "stencil_keys" in names and "dht_write" in names
    missing = [n for n in names if n not in WAITING
               and (not hasattr(tcore, n) or n not in tcore.__all__)]
    assert not missing, f"repro_torch.core lacks {missing}"


def test_waiting_list_names_only_missing_reference_names():
    """Nothing is left waiting: every public name of a ported module of
    repro.core is exported, the replication, fault and repair names of
    item 12 (the last to wait) among them, with every public name of
    the reference's ``faults`` module."""
    names = set(_ported_names())
    assert WAITING == {}
    item12 = {"dht_write_replicated", "replica_placement", "Repair",
              "RepairPlan", "plan_repair", "repair_begin", "repair_diff",
              "repair_run", "repair_step", "FaultPlan", "crash_shard",
              "recover_shard"}
    assert item12 <= names
    from repro.core import faults as jfaults
    assert not [n for n in item12 | set(jfaults.__all__)
                if n not in tcore.__all__ or not hasattr(tcore, n)]


def test_obs_exports_every_reference_name_but_count_traced_rounds():
    """``repro_torch.obs`` exports every public name of ``repro.obs`` but
    ``count_traced_rounds``, which counts dispatches in one
    ``jax.make_jaxpr`` trace: eager torch has no trace to count, and
    ``counting()`` around the eager call gives the one-round property."""
    import dataclasses

    import repro.obs as jobs
    import repro_torch.obs as tobs

    missing = sorted(set(jobs.__all__) - set(tobs.__all__))
    assert missing == ["count_traced_rounds"]
    assert set(tobs.__all__) <= set(jobs.__all__)
    for name in tobs.__all__:
        assert getattr(tobs, name) is not None
    for mod in ("metrics", "trace", "skew", "costmodel", "regress",
                "report"):
        j = getattr(jobs, mod)
        t = getattr(tobs, mod)
        want = set(getattr(j, "__all__", []))
        if mod == "trace":
            want -= {"count_traced_rounds"}
        if mod == "costmodel":
            want = (want - {"hlo_alltoall_words"}) | {
                "profiled_alltoall_words"}
        assert set(getattr(t, "__all__", [])) == want, mod
    assert dataclasses.is_dataclass(tobs.trace.RoundEvent)
