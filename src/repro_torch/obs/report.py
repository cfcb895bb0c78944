"""Render telemetry: round timeline + top-metrics summary (PyTorch port
of ``repro.obs.report``: the same code over the same JSON).

Usage::

    python -m repro_torch.obs.report --bench BENCH.json    # snapshot
    python -m repro_torch.obs.report --trace trace.jsonl   # timeline
    python -m repro_torch.obs.report --bench s.json --trace trace.jsonl

``--bench`` takes either a ``benchmarks/run.py --json`` payload (reads
its ``telemetry`` key) or a bare registry-snapshot JSON; multiple
``--bench`` files (e.g. one per shard process) are merged with
:func:`repro_torch.obs.metrics.merge_snapshots` before rendering.

``--skew`` renders the imbalance view (DESIGN.md §11): the per-round
``imb``/``hot`` columns aggregated over the trace plus the
``engine.bin_imbalance``/``engine.hot_frac`` registry histograms.
"""
from __future__ import annotations

import argparse
import json

from . import metrics

_BAR = 40


def _fmt_count(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.6g}" if isinstance(v, float) and v != int(v) else f"{int(v)}"


def load_snapshot(path: str) -> dict:
    with open(path) as f:
        payload = json.load(f)
    return payload.get("telemetry", payload)


def render_summary(snap: dict, top: int = 20) -> str:
    lines = ["== metric registry =="]
    counters = snap.get("counters", {})
    if counters:
        lines.append("-- counters --")
        ranked = sorted(counters.items(), key=lambda kv: -kv[1])[:top]
        width = max(len(k) for k, _ in ranked)
        for k, v in ranked:
            lines.append(f"  {k:<{width}}  {_fmt_count(v):>10}")
    gauges = snap.get("gauges", {})
    if gauges:
        lines.append("-- gauges --")
        width = max(len(k) for k in gauges)
        for k in sorted(gauges):
            lines.append(f"  {k:<{width}}  {gauges[k]:>10.4f}")
    hists = snap.get("histograms", {})
    if hists:
        lines.append("-- histograms --")
        for k in sorted(hists):
            h = hists[k]
            n = int(h["count"])
            mean = (float(h["sum"]) / n) if n else 0.0
            p50 = metrics.histogram_quantile(h, 0.5)
            p99 = metrics.histogram_quantile(h, 0.99)
            lines.append(
                f"  {k}: n={n} mean={mean:.4g} p50={p50:.4g} "
                f"p99={p99:.4g} max={h.get('max')}")
    if len(lines) == 1:
        lines.append("  (registry empty)")
    return "\n".join(lines)


def render_timeline(events: list[dict], last: int = 30) -> str:
    """ASCII round timeline: per-event duration bar + phase breakdown."""
    lines = [f"== round timeline (last {min(last, len(events))} "
             f"of {len(events)} events) =="]
    tail = events[-last:]
    if not tail:
        lines.append("  (trace empty)")
        return "\n".join(lines)
    dmax = max((e.get("dur", 0.0) for e in tail), default=0.0) or 1.0
    for e in tail:
        dur_us = e.get("dur", 0.0) * 1e6
        bar = "#" * max(1, int(_BAR * e.get("dur", 0.0) / dmax))
        stats = e.get("stats", {})
        extras = []
        for key, label in (("wire_words", "wire"), ("fill_frac", "fill"),
                           ("bin_imbalance", "imb"), ("hot_frac", "hot"),
                           ("l1_hits", "l1"), ("dropped", "drop"),
                           ("requeued", "rq"), ("fallback_reads", "fb"),
                           ("replica_writes", "rep"), ("healed", "heal"),
                           ("overlap_frac", "ov")):
            if key in stats:
                extras.append(f"{label}={_fmt_count(stats[key])}")
        spans = e.get("spans", {})
        if spans and dur_us > 0:
            mix = " ".join(
                f"{p}:{100 * spans[p][1] * 1e6 / dur_us:.0f}%"
                for p in ("bin", "dispatch", "apply", "collect", "commit",
                          "issue", "hidden")
                if p in spans)
            if mix:
                extras.append(mix)
        lines.append(f"  {e.get('source', '?'):<24} {dur_us:>9.1f}us "
                     f"|{bar:<{_BAR}}| {' '.join(extras)}")
    return "\n".join(lines)


def render_skew(events: list[dict] | None = None,
                snap: dict | None = None) -> str:
    """Imbalance view: trace-side skew lanes aggregated per source, plus
    the registry's imbalance/hot-fraction histograms (DESIGN.md §11)."""
    lines = ["== skew =="]
    if events:
        by_src: dict[str, list[dict]] = {}
        for e in events:
            s = e.get("stats", {})
            if "bin_imbalance" in s or "hot_frac" in s:
                by_src.setdefault(e.get("source", "?"), []).append(s)
        if by_src:
            lines.append("-- per-round wire-bin skew (trace) --")
            lines.append(f"  {'source':<24} {'rounds':>6} {'imb(med)':>9} "
                         f"{'imb(max)':>9} {'hot(med)':>9} {'maxload':>8}")
            for src in sorted(by_src):
                ss = by_src[src]
                imbs = sorted(float(s.get("bin_imbalance", 1.0)) for s in ss)
                hots = sorted(float(s.get("hot_frac", 0.0)) for s in ss)
                loads = [int(s.get("bin_max_load", 0)) for s in ss]
                mid = len(ss) // 2
                lines.append(
                    f"  {src:<24} {len(ss):>6} {imbs[mid]:>9.2f} "
                    f"{imbs[-1]:>9.2f} {hots[mid]:>9.3f} {max(loads):>8}")
        else:
            lines.append("  (no skew lanes in trace)")
    hists = (snap or {}).get("histograms", {})
    shown = False
    for name in ("engine.bin_imbalance", "engine.hot_frac",
                 "l1.set_occupancy", "dht.bucket_occupancy"):
        h = hists.get(name)
        if not h or not h.get("count"):
            continue
        if not shown:
            lines.append("-- registry skew histograms --")
            shown = True
        n = int(h["count"])
        mean = float(h["sum"]) / n if n else 0.0
        lines.append(
            f"  {name}: n={n} mean={mean:.3f} "
            f"p50={metrics.histogram_quantile(h, 0.5):.3g} "
            f"p99={metrics.histogram_quantile(h, 0.99):.3g} "
            f"max={h.get('max')}")
    if len(lines) == 1:
        lines.append("  (no skew data)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__)
    ap.add_argument("--bench", action="append", default=[],
                    help="BENCH json (or bare snapshot); repeatable, merged")
    ap.add_argument("--trace", help="trace JSONL from obs.trace")
    ap.add_argument("--top", type=int, default=20,
                    help="top-N counters to show")
    ap.add_argument("--last", type=int, default=30,
                    help="last-N trace events to show")
    ap.add_argument("--skew", action="store_true",
                    help="render the imbalance view (DESIGN.md §11)")
    args = ap.parse_args(argv)
    if not args.bench and not args.trace:
        ap.error("need --bench and/or --trace")
    events = None
    if args.trace:
        with open(args.trace) as f:
            events = [json.loads(line) for line in f if line.strip()]
    snap = None
    if args.bench:
        snap = metrics.merge_snapshots(load_snapshot(p) for p in args.bench)
    if args.skew:
        print(render_skew(events, snap))
        return 0
    if events is not None:
        print(render_timeline(events, last=args.last))
    if snap is not None:
        print(render_summary(snap, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
