"""Telemetry substrate of the PyTorch port (``repro.obs``'s twin): metric
registry, per-round tracing, reporting, cost model, skew diagnostics, and
regression gating.

- :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
  histograms with deterministic snapshots and cross-rank merge.
- :mod:`repro_torch.obs.trace`  — bounded ring buffer of per-round
  events, JSONL + Chrome ``trace_event`` export; ``OBS_FENCE=1`` fences
  phase spans with ``torch.cuda.synchronize``.
- :mod:`repro_torch.obs.report` — ``python -m repro_torch.obs.report``
  CLI rendering a round timeline, top-metrics summary, and ``--skew``
  imbalance view.
- :mod:`repro_torch.obs.costmodel` — calibrated α-β round-cost model
  fitted over trace events; throughput prediction at unreachable shard
  counts and the wire-vs-profiler traffic cross-check.
- :mod:`repro_torch.obs.skew` — bin/bucket/L1-set imbalance summaries.
- :mod:`repro_torch.obs.regress` — ``python -m repro_torch.obs.regress``
  noise-aware BENCH-trajectory regression gate.

Metric names, event sources and the snapshot/JSONL/Chrome schemas are
the reference's (DESIGN.md §10-§11), so both packages' outputs read
alike.  ``OBS_DISABLED=1`` no-ops the lot.  The reference's
``count_traced_rounds`` counts dispatches in one ``jax.make_jaxpr``
trace and has no port: eager torch has no trace to count, and
``metrics.counting()`` around the eager call gives the one-round
property.
"""
from . import costmodel, metrics, skew, trace
from .metrics import (counter_value, counting, disabled, enabled,
                      get_registry, inc, merge_snapshots, merge_wire_stats,
                      observe, set_enabled, set_gauge)
from .trace import (fence, fence_enabled, get_tracer, record_event,
                    record_round, set_fence)


def __getattr__(name):
    # the CLI modules (python -m repro_torch.obs.regress / .report) load
    # lazily so running them with -m doesn't double-import under runpy
    if name in ("regress", "report"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "costmodel", "metrics", "regress", "skew", "trace",
    "counter_value", "counting", "disabled",
    "enabled", "get_registry", "inc", "merge_snapshots",
    "merge_wire_stats", "observe", "set_enabled", "set_gauge",
    "fence", "fence_enabled", "get_tracer",
    "record_event", "record_round", "set_fence",
]
