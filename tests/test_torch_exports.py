"""``repro_torch.core`` exports every public name of ``repro.core`` whose
home module is ported, so code can swap one package for the other.  Names
whose port waits for a later ROADMAP item are listed with that item."""
import importlib
import types

import repro.core as jcore
import repro_torch.core as tcore

# modules of repro.core with a port file under repro_torch/core/
PORTED = ("neighbors", "hashing", "layout", "dht", "surrogate", "interp",
          "l1cache", "op_engine", "pipeline", "membership", "migrate")

# public names of ported modules whose port is still to come: ROADMAP item
WAITING = {
    # item 12: replication, and the anti-entropy repair half of migrate
    "dht_write_replicated": 12, "replica_placement": 12,
    "Repair": 12, "RepairPlan": 12, "plan_repair": 12, "repair_begin": 12,
    "repair_diff": 12, "repair_run": 12, "repair_step": 12,
}


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
    """Each waiting name is a ported module's public name of repro.core
    that the port does not export yet: the list shrinks as items land."""
    names = set(_ported_names())
    assert set(WAITING) <= names
    assert not [n for n in WAITING if hasattr(tcore, n)]
    assert set(WAITING.values()) <= {12}
