"""Noise-aware bench-trajectory regression gate (PyTorch port of
``repro.obs.regress``: the same code over the same JSON; DESIGN.md §11).

Compares a fresh ``benchmarks/run.py --json`` payload against the
committed trajectory baseline and emits a machine-readable verdict::

    python -m repro_torch.obs.regress --bench BENCH.json \
        --baseline benchmarks/trajectory.json [--out verdict.json]
    python -m repro_torch.obs.regress --bench BENCH.json \
        --baseline benchmarks/trajectory.json --update   # (re)seed

Variability-aware in the spirit of Cornebize & Legrand: wall-clock
metrics on shared CI runners routinely jitter by tens of percent, so a
single-sample time comparison gates on noise, not regressions.  The
policy therefore classifies every metric:

- **time** (``*.us_per_call``, latency/throughput gauges) — wide band
  (default +50%), ADVISORY by default (reported, never failing) unless
  ``--strict-time``; medians across ``--repeats`` runs (the payload's
  ``repeats_raw`` block) are used when present.
- **count** (registry counters: wire words, rounds, hits) — these are
  deterministic replay products; band 2%, gating.  A drifted counter
  means the *code* changed traffic, not the machine.
- **quality** (accuracy/agreement gauges: ``*rel_err*``, ``*agree*``,
  fractions) — band 25% with an absolute floor, gating.

Comparability is fingerprint-checked: a quick run never regresses
against a ``--full`` baseline.  Exit code 0 = pass (advisories allowed),
1 = fail, 2 = incomparable/missing baseline.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

__all__ = ["extract_metrics", "classify", "compare", "dropped_ratio_gate",
           "TRAJECTORY_VERSION"]

TRAJECTORY_VERSION = 1

# (kind, relative band, absolute floor, gating-by-default)
_POLICY = {
    "time": (0.50, 5.0, False),
    "count": (0.02, 1.0, True),
    "quality": (0.25, 0.05, True),
}

_TIME_HINTS = ("us_per_call", "latency", "throughput", "_us", "_s")
_QUALITY_HINTS = ("rel_err", "agree", "frac", "ratio", "err")


def classify(key: str) -> str:
    """Metric kind of a flat trajectory key (see module docstring)."""
    if key.startswith("counter."):
        return "count"
    low = key.lower()
    # cost-model calibration outputs (fitted coefficients, fit/held-out
    # error) are derived from wall-clock timings and inherit their
    # machine-to-machine noise — advisory, like the timings themselves;
    # CI separately gates heldout_rel_err on an ABSOLUTE threshold.  The
    # HLO-agreement ratios in the same namespace are deterministic and
    # fall through to quality.
    if "costmodel." in low and "hlo_ratio" not in low:
        return "time"
    # the pipeline bench's overlap/speedup gauges are wall-clock
    # products of the measured schedule (issue/commit overlap, sync vs
    # pipelined wall ratio) — advisory like timings, despite the
    # "frac"/"speedup" names; CI gates them on ABSOLUTE thresholds
    if "pipeline." in low and ("overlap" in low or "speedup" in low):
        return "time"
    if any(h in low for h in _QUALITY_HINTS):
        return "quality"
    if any(h in low for h in _TIME_HINTS):
        return "time"
    return "quality"


def extract_metrics(payload: dict) -> dict[str, float]:
    """Flatten a BENCH payload to ``{metric_key: value}``:
    ``<bench>.<row>.us_per_call`` per bench row (median across
    ``repeats_raw`` repeats when present), ``gauge.<name>`` and
    ``counter.<name>`` from the telemetry snapshot."""
    out: dict[str, float] = {}
    for k, rows in payload.items():
        if not k.startswith("BENCH_") or not isinstance(rows, list):
            continue
        bench = k[len("BENCH_"):]
        for row in rows:
            v = row.get("us_per_call")
            if isinstance(v, (int, float)) and v == v:
                out[f"{bench}.{row.get('name', '?')}.us_per_call"] = float(v)
    for bench, reps in (payload.get("repeats_raw") or {}).items():
        per: dict[str, list[float]] = {}
        for rep in reps:
            for row in rep:
                v = row.get("us_per_call")
                if isinstance(v, (int, float)) and v == v:
                    per.setdefault(row.get("name", "?"), []).append(float(v))
        for name, vs in per.items():
            out[f"{bench}.{name}.us_per_call"] = float(np.median(vs))
    tel = payload.get("telemetry", {})
    for name, v in tel.get("gauges", {}).items():
        out[f"gauge.{name}"] = float(v)
    for name, v in tel.get("counters", {}).items():
        out[f"counter.{name}"] = float(v)
    return out


def _within(new: float, base: float, rel: float, floor: float) -> bool:
    """Regression test: worse = LARGER for every kind we track (times,
    error rates, traffic counts).  Improvements never fail; counts also
    gate downward drift (they are exact-replay invariants)."""
    return abs(new - base) <= max(rel * abs(base), floor)


def compare(new: dict[str, float], base: dict[str, float], *,
            strict_time: bool = False) -> dict:
    """Per-metric verdicts; see module docstring for the policy."""
    failures, advisories, improved, missing = [], [], [], []
    compared = 0
    for key in sorted(base):
        if key not in new:
            missing.append(key)
            continue
        compared += 1
        kind = classify(key)
        rel, floor, gating = _POLICY[kind]
        b, n = base[key], new[key]
        entry = {"metric": key, "kind": kind, "baseline": b, "new": n,
                 "rel_delta": ((n - b) / abs(b)) if b else float(n != b)}
        if kind == "time":
            # one-sided: slower = worse; getting faster never fails
            ok = n <= b + max(rel * abs(b), floor)
            if ok and n < b:
                improved.append(entry)
        else:
            # counts are exact-replay invariants and quality gauges are
            # deterministic ratios (hit rates, round ratios, rel errors):
            # drift in EITHER direction is a code-behavior change
            ok = _within(n, b, rel, floor)
        if ok:
            continue
        if kind == "time" and not strict_time:
            advisories.append(entry)
        elif gating or strict_time:
            failures.append(entry)
        else:
            advisories.append(entry)
    return {
        "verdict": "fail" if failures else "pass",
        "compared": compared,
        "failures": failures,
        "advisories": advisories,
        "improved": [e["metric"] for e in improved],
        "missing_in_new": missing,
        "new_metrics": sorted(set(new) - set(base)),
    }


def dropped_ratio_gate(metrics_flat: dict[str, float],
                       max_ratio: float) -> dict | None:
    """Silent-loss gate (DESIGN.md §13): the fraction of issued write ops
    the engine dropped on the floor must stay below ``max_ratio``.

    ``engine.dropped`` counts only UNRECOVERED drops — rows a bounded
    retry round re-issued land on ``engine.requeued`` instead — so this
    gates end-to-end write loss, not transient overflow pressure.
    Returns a failure entry (compare() shape) or None."""
    dropped = metrics_flat.get("counter.engine.dropped", 0.0)
    writes = metrics_flat.get("counter.engine.ops.write", 0.0)
    ratio = dropped / writes if writes else 0.0
    if ratio <= max_ratio:
        return None
    return {"metric": "counter.engine.dropped_ratio", "kind": "count",
            "baseline": max_ratio, "new": ratio,
            "rel_delta": (ratio - max_ratio) / max_ratio if max_ratio
            else float("inf")}


def load_bench(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def make_trajectory(payload: dict) -> dict:
    """Baseline trajectory document from one BENCH payload."""
    schema = payload.get("schema", {})
    return {
        "trajectory_version": TRAJECTORY_VERSION,
        "fingerprint": schema.get("fingerprint"),
        "source_schema_version": schema.get("schema_version"),
        "metrics": extract_metrics(payload),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--bench", action="append", required=True,
                    help="fresh BENCH json; repeatable (per-metric median)")
    ap.add_argument("--baseline", required=True,
                    help="committed trajectory json")
    ap.add_argument("--update", action="store_true",
                    help="(re)seed the baseline from --bench and exit")
    ap.add_argument("--out", help="write the verdict json here")
    ap.add_argument("--strict-time", action="store_true",
                    help="gate (not just report) time-metric regressions")
    ap.add_argument("--ignore-fingerprint", action="store_true",
                    help="compare despite differing run configurations")
    ap.add_argument("--max-dropped-ratio", type=float, default=None,
                    metavar="R",
                    help="fail if counter.engine.dropped / "
                         "counter.engine.ops.write exceeds R "
                         "(unrecovered write loss; retried rows count "
                         "as engine.requeued, not dropped)")
    args = ap.parse_args(argv)

    payloads = [load_bench(p) for p in args.bench]
    per_file = [extract_metrics(p) for p in payloads]
    new: dict[str, float] = {}
    for key in sorted(set().union(*per_file)):
        vals = [m[key] for m in per_file if key in m]
        new[key] = float(np.median(vals))
    fp = payloads[0].get("schema", {}).get("fingerprint")

    if args.update:
        traj = make_trajectory(payloads[0])
        traj["metrics"] = new
        with open(args.baseline, "w") as f:
            json.dump(traj, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"seeded {args.baseline}: {len(new)} metrics, "
              f"fingerprint={traj['fingerprint']}")
        return 0

    try:
        with open(args.baseline) as f:
            traj = json.load(f)
    except FileNotFoundError:
        print(f"no baseline at {args.baseline} — run with --update to seed",
              file=sys.stderr)
        return 2
    if (traj.get("fingerprint") != fp and not args.ignore_fingerprint):
        print(f"incomparable: baseline fingerprint {traj.get('fingerprint')} "
              f"!= bench {fp} (differing run config); --ignore-fingerprint "
              f"to override", file=sys.stderr)
        return 2

    verdict = compare(new, traj.get("metrics", {}),
                      strict_time=args.strict_time)
    if args.max_dropped_ratio is not None:
        gate = dropped_ratio_gate(new, args.max_dropped_ratio)
        if gate is not None:
            verdict["failures"].append(gate)
            verdict["verdict"] = "fail"
    verdict["fingerprint"] = fp
    verdict["baseline_fingerprint"] = traj.get("fingerprint")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=1, sort_keys=True)
    print(f"regress: {verdict['verdict']} — {verdict['compared']} compared, "
          f"{len(verdict['failures'])} failing, "
          f"{len(verdict['advisories'])} advisory, "
          f"{len(verdict['improved'])} improved")
    for e in verdict["failures"]:
        print(f"  FAIL {e['metric']} [{e['kind']}]: "
              f"{e['baseline']:.6g} -> {e['new']:.6g} "
              f"({100 * e['rel_delta']:+.1f}%)")
    for e in verdict["advisories"]:
        print(f"  warn {e['metric']} [{e['kind']}]: "
              f"{e['baseline']:.6g} -> {e['new']:.6g} "
              f"({100 * e['rel_delta']:+.1f}%)")
    return 1 if verdict["verdict"] == "fail" else 0


if __name__ == "__main__":
    raise SystemExit(main())
