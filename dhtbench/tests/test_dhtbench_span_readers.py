"""The readers of the program's device spans and timed host reads: each
reads a hand-built context, and gives nothing where the program
recorded nothing (an empty context, or a run off the card)."""
import pytest

import dhtbench_tiny as tiny
from dhtb import cell, loop, manifest

# each reader's metric, and its value on CONTEXT below
EXPECTED = {
    "routing.bin_device_ms.kv": 4.0,
    "routing.exchange_device_ms.kv": 1.5 + 0.25,
    "engine.apply_device_ms.kv": 9.0,
    "engine.write_device_ms.kv": 6.0,
    "engine.issue_wait_ms.kv": (2000.0 + 6000.0 + 0.0) / 4 / 1e3,
    "engine.syncs.kv": 17 / 4,
}


def _context(counters: dict, hists: dict) -> cell.Context:
    window = loop.Window(latency_s=[], stats=[], kept={}, ops=0, rounds=0,
                         span_s=0.0)
    return cell.Context(window=window, counters=counters, hists=hists,
                        profile={}, work={}, kernel_s={})


CONTEXT = dict(
    counters={"engine.rounds": 4, "engine.host_syncs": 17},
    hists={"engine.device_us.bin": (16000.0, 4),
           "engine.device_us.dispatch": (6000.0, 4),
           "engine.device_us.apply": (36000.0, 4),
           "engine.device_us.write": (24000.0, 4),
           "engine.device_us.collect": (1000.0, 4),
           "engine.sync_wait_us.capacity": (2000.0, 4),
           "engine.sync_wait_us.write_flag": (6000.0, 9),
           "engine.sync_wait_us.commit": (50000.0, 4)})


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_hand_built_context(name):
    read = manifest.metric_reader(name, tiny.BENCH).read
    assert read(_context(**CONTEXT)) == pytest.approx(EXPECTED[name])
    assert read(_context({}, {})) is None
    # a window whose histograms the program made but left empty
    empty = {k: (0.0, 0) for k in CONTEXT["hists"]}
    assert read(_context({"engine.rounds": 0}, empty)) is None


def test_readers_are_in_the_manifest_for_both_cells():
    man = manifest.load_manifest()
    entries = {m["name"]: m for m in man["per_layer"]}
    for name in EXPECTED:
        assert entries[name]["moves"] == "kv_ops_per_s"
        assert entries[name]["workloads"] == tiny.CELLS


def test_traced_run_off_the_card_reports_none_of_them():
    """The program records device spans and timed reads on the card
    alone: a traced CPU run leaves the six out and raises nothing."""
    result, checks = tiny.run_tiny(tiny.tiny_spec(tiny.CELLS[0]),
                                   trace=True)
    assert result["correct"], checks
    assert not set(EXPECTED) & set(result["metrics"])
    assert "engine.write_passes.kv" in result["metrics"]
