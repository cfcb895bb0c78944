"""Calibrated α-β round-cost model with scale prediction (PyTorch port of
``repro.obs.costmodel``; DESIGN.md §11).

One engine round decomposes as

    t_round = c_bin·n·log2(n)              (sort-based binning)
            + α·dispatch_rounds            (per-collective latency)
            + β·(wire_send + wire_reply)   (bandwidth: words both legs)
            + c_apply·buffer_rows          (shard-side probe work)
            + c_shard·n_shards             (per-shard fixed overhead)

— the classic latency/bandwidth (α-β) communication model with compute
terms, in the spirit of SMPI's calibrated simulations
(Cornebize & Legrand) and the HPL prediction study (Xu et al.): fit the
five coefficients by non-negative least squares over *measured*
RoundEvents, then evaluate the same expression at shard counts you
cannot run.  Everything the features need (``dispatch_rounds``,
``wire_send_words``/``wire_reply_words``, ``n_shards``, ``capacity``,
op counts) already rides every event the telemetry substrate records — the
model is a pure consumer.

Scale prediction replays the engine's own wire accounting analytically:
expected max bin load (multinomial simulation) → the same pow-2
``capacity_bucket`` lattice → rows·lanes both legs + the count-exchange
prologue — so the predicted traffic is the number the engine's accounting
*would* report at that scale.  The independent side of the standing
cross-check is :func:`profiled_alltoall_words`: the all-to-all words a
``torch.profiler`` trace saw (the port has no compiled HLO to read, which
is where the reference's ``hlo_alltoall_words`` looks).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "RoundCostModel", "event_features", "fit", "predict_round",
    "predict_capacity", "predict_wire_words", "send_reply_lanes",
    "profiled_alltoall_words",
]

# feature order for the design matrix (and the fitted coefficients)
FEATURES = ("dispatch_rounds", "wire_words", "n_log_n", "buffer_rows",
            "n_shards")


@dataclasses.dataclass(frozen=True)
class RoundCostModel:
    """Fitted coefficients, all in seconds per unit (non-negative)."""

    alpha: float          # s per dispatch round (collective latency)
    beta: float           # s per wire word (1/bandwidth)
    c_bin: float          # s per n·log2(n) (binning sort)
    c_apply: float        # s per buffer row (shard-side probe work)
    c_shard: float        # s per shard (per-shard fixed overhead)
    n_events: int         # events the fit consumed
    fit_rel_err: float    # median |pred-meas|/meas over the fit set

    def coef(self) -> np.ndarray:
        return np.array([self.alpha, self.beta, self.c_bin, self.c_apply,
                         self.c_shard])

    def time(self, feats: np.ndarray) -> float | np.ndarray:
        """Predicted round time for one feature row (or a matrix)."""
        return np.asarray(feats) @ self.coef()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RoundCostModel":
        return cls(**{f.name: d[f.name]
                      for f in dataclasses.fields(cls)})


def _ev_fields(ev) -> tuple[dict, dict, float]:
    """(stats, ops, dur) from a RoundEvent or its to_json() dict."""
    if isinstance(ev, dict):
        return ev.get("stats", {}), ev.get("ops", {}), float(ev.get("dur", 0.0))
    return ev.stats, ev.ops, float(ev.dur)


def event_features(ev) -> np.ndarray | None:
    """Feature row [dispatch_rounds, wire_words, n·log2(n), buffer_rows,
    n_shards]
    of one recorded round — ``None`` when the event lacks the lanes
    (older traces) or carries no ops."""
    stats, ops, _dur = _ev_fields(ev)
    n = sum(int(v) for v in ops.values())
    need = ("wire_send_words", "wire_reply_words", "n_shards", "capacity")
    if n <= 0 or any(k not in stats for k in need):
        return None
    wire = float(stats["wire_send_words"]) + float(stats["wire_reply_words"])
    rows = float(stats["n_shards"]) * float(stats["capacity"])
    return np.array([
        float(stats.get("dispatch_rounds", 1)),
        wire,
        n * math.log2(max(n, 2)),
        rows,
        float(stats["n_shards"]),
    ])


def _nnls(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least squares with non-negativity, by exhaustive support search:
    the NNLS optimum solves unconstrained least squares on its positive
    support, so with k=5 features scanning all 2^k-1 supports and taking
    the feasible (all-positive) solution with the smallest residual finds
    it — no scipy dependency, and no premature pruning the way a greedy
    drop-the-most-negative heuristic can."""
    k = X.shape[1]
    best = np.zeros(k)
    best_r = float(np.linalg.norm(y))
    for mask in range(1, 1 << k):
        cols = [i for i in range(k) if (mask >> i) & 1]
        sol, *_ = np.linalg.lstsq(X[:, cols], y, rcond=None)
        if (sol < 0.0).any():
            continue
        r = float(np.linalg.norm(y - X[:, cols] @ sol))
        if r < best_r:
            best_r = r
            best = np.zeros(k)
            best[np.array(cols)] = sol
    return best


def fit(events) -> RoundCostModel:
    """Fit the α-β model over recorded rounds (RoundEvents or their JSON
    dicts).  Events without those lanes, without ops, or without a
    positive duration are skipped; needs >= 4 usable events."""
    rows, durs = [], []
    for ev in events:
        f = event_features(ev)
        _stats, _ops, dur = _ev_fields(ev)
        if f is None or dur <= 0.0:
            continue
        rows.append(f)
        durs.append(dur)
    if len(rows) < len(FEATURES):
        raise ValueError(
            f"cost-model fit needs >= {len(FEATURES)} usable events, "
            f"got {len(rows)}")
    X = np.stack(rows)
    y = np.array(durs)
    # weight by 1/t: relative (not absolute) residuals, so the many fast
    # small-batch rounds are not drowned out by a few slow large ones
    w = 1.0 / np.maximum(y, 1e-9)
    coef = _nnls(X * w[:, None], y * w)
    pred = X @ coef
    rel = np.abs(pred - y) / np.maximum(y, 1e-9)
    return RoundCostModel(
        alpha=float(coef[0]), beta=float(coef[1]),
        c_bin=float(coef[2]), c_apply=float(coef[3]),
        c_shard=float(coef[4]),
        n_events=len(rows), fit_rel_err=float(np.median(rel)),
    )


# ---------------------------------------------------------------------------
# analytic wire replay: the engine's accounting, evaluated at any scale
# ---------------------------------------------------------------------------

def send_reply_lanes(key_words: int, val_words: int, *,
                     kind: str = "read", l1_meta: bool = False,
                     mixed: bool = False, dual: bool = False
                     ) -> tuple[int, int]:
    """Lane widths of the fused dispatch/collect payloads, mirroring
    ``op_engine.dht_execute``: send = base + keys [+ vals][+ op][+ esel]
    + valid; reply = vals + found + code [+ 3 coherence lanes]."""
    send = 1 + key_words + 1
    if kind == "write" or mixed:
        send += val_words
    if mixed:
        send += 1       # op lane
    if dual:
        send += 1       # esel lane
    reply = val_words + 2 + (3 if l1_meta else 0)
    return send, reply


def predict_capacity(n: int, n_shards: int, *, samples: int = 32,
                     seed: int = 0) -> int:
    """Expected count-driven capacity at scale: the max bin load of n
    uniform keys over S destinations (multinomial simulation, mean of
    ``samples`` draws) rounded up ``routing.capacity_bucket``'s pow-2
    lattice — exactly what the count-exchange prologue would agree on."""
    from ..core.routing import capacity_bucket

    n, s = int(n), max(int(n_shards), 1)
    if n <= 0:
        return capacity_bucket(1)
    rng = np.random.default_rng(seed)
    draws = rng.multinomial(n, np.full(s, 1.0 / s), size=samples)
    max_load = int(np.ceil(draws.max(axis=1).mean()))
    return capacity_bucket(max_load, limit=n)


def predict_wire_words(n: int, n_shards: int, *, key_words: int,
                       val_words: int, kind: str = "read",
                       capacity: int | None = None, prologue: bool = True,
                       elide_self: bool = False, l1_meta: bool = False,
                       ) -> dict:
    """Replay ``routing.wire_stats`` analytically: per-leg words of one
    round at (n, S) — the engine's accounting, computed without
    running the round.  Returns send/reply/total words plus the capacity
    and buffer-row count used."""
    cap = (int(capacity) if capacity
           else predict_capacity(n, n_shards))
    send, reply = send_reply_lanes(key_words, val_words, kind=kind,
                                   l1_meta=l1_meta)
    rows = n_shards * cap - (cap if elide_self else 0)
    pro = 2 * n_shards if prologue else 0
    return {
        "capacity": cap,
        "buffer_rows": n_shards * cap,
        "wire_send_words": rows * send + pro,
        "wire_reply_words": rows * reply,
        "wire_words": rows * (send + reply) + pro,
    }


def predict_round(model: RoundCostModel, n: int, n_shards: int, *,
                  key_words: int, val_words: int, kind: str = "read",
                  capacity: int | None = None, prologue: bool = True,
                  elide_self: bool = False) -> dict:
    """Predicted cost of one n-item round at S shards: wall time, items/s
    throughput, and the analytic wire breakdown the prediction used."""
    wire = predict_wire_words(
        n, n_shards, key_words=key_words, val_words=val_words, kind=kind,
        capacity=capacity, prologue=prologue, elide_self=elide_self)
    feats = np.array([
        1.0,
        float(wire["wire_words"]),
        n * math.log2(max(n, 2)),
        float(wire["buffer_rows"]),
        float(n_shards),
    ])
    t = float(model.time(feats))
    return {
        "n": int(n), "n_shards": int(n_shards), "kind": kind,
        "t_pred_s": t,
        "throughput_pred": (n / t) if t > 0 else float("inf"),
        **wire,
    }


# the dispatcher op of ``all_to_all_single``: one event per call whatever
# the backend (gloo and NCCL add events of their own beside it, which are
# not counted, so no call counts twice)
ALLTOALL_OP = "c10d::alltoall_base_"


def profiled_alltoall_words(events) -> int:
    """all-to-all traffic a ``torch.profiler`` trace saw, in 32-bit words:
    the summed size of the input buffer of every ``all_to_all_single``
    call (``events`` from a profile taken with ``record_shapes=True``,
    e.g. ``prof.events()``).  The engine's buffers are int32 lane
    matrices, so a word is an element.  Restricted to the all-to-all
    kind, the engine's data legs: the count-exchange prologue and the
    stat-lane reductions travel in ``all_reduce`` calls and are not in
    it.  The buffer holds the rank's own block too, which the wire
    accounting leaves out of an elided round."""
    words = 0
    for ev in events:
        if ev.name != ALLTOALL_OP:
            continue
        shapes = ev.input_shapes
        if not shapes or not shapes[0]:
            raise ValueError(f"{ALLTOALL_OP} without input shapes: profile "
                             "with record_shapes=True")
        words += math.prod(shapes[0])
    return int(words)
