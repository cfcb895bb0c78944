"""Per-round trace recorder: a bounded ring buffer of structured events
(PyTorch port of ``repro.obs.trace``).

Every executed engine round (each ``dht_commit``, each round a
``ShardedDHT`` wrapper runs, each ``sharded.migrate`` and
``sharded.repair`` round) lands one :class:`RoundEvent` here through
:func:`record_round`, carrying the phase spans (bin / dispatch / apply /
collect / commit), the op mix, and every scalar stat lane of the round
(wire words both legs, fill fraction, capacity against load, L1 hits,
lock-retry rounds, epoch stamps: whatever the round's ``estats`` held).
Host steps that wrap recorded rounds (``migrate.step``, ``repair.step``,
``sharded.apply_ring``, ``sharded.crash``) are trace-only events
(:func:`record_event`).  The ring is bounded (``OBS_TRACE_MAXLEN``,
default 4096 events) so long loops cannot grow host memory without
bound.

Exports: :meth:`TraceRecorder.to_jsonl` (one JSON object per line, the
reference's schema) and :meth:`TraceRecorder.to_chrome_trace` (Chrome
``trace_event`` JSON: load the file in https://ui.perfetto.dev to see
rounds and their phase spans on a timeline).

Getting the lanes to the host: a lane that is a 0-d tensor on the card
would cost one host sync to read.  :func:`record_round` reads all of a
round's tensor lanes with one copy per device.  The engine does better:
its issue half packs the round's tensor lanes and op counts into one
float64 tensor (exact for the int32 counts and the float32 fractions)
and copies it, without waiting, into pinned host memory before it
records the round's CUDA event, so the commit half reads them after the
event with no sync of its own.  Integer lanes come back as ``int``,
float lanes as the ``float`` of their float32 value, as the reference's
``_scalarize`` gives them.

Phase spans and ``OBS_FENCE=1``: CUDA launches are asynchronous, so a
phase span measures the host time to *issue* that phase's work, not the
card's time to run it; the unissued remainder piles into whichever phase
waits for a value (usually ``commit``).  The card's side comes from
device spans instead (:class:`RoundSpans`): in a self-recording engine
round on the card each phase mark, and the ``write`` schedule inside
``apply``, records a pooled timing CUDA event (through the CUDA driver,
which costs less host time than ``torch.cuda.Event``), and the commit
reads the elapsed times after the wait it already makes, so the round
gains lanes ``device_us.<span>`` (histograms
``engine.device_us.<span>``) and no sync.  A device span is the stream's
time from one mark to the next: the phase's kernels and any gap in which
the card waited for the host to launch them.  Every host read of a
device value in such a round goes through :func:`host_read`, which times
it into ``engine.host_syncs`` and ``engine.sync_wait_us.<site>``; the
issue half's reads also sum into the lane ``issue_wait_us``.  While a
``torch.profiler`` is collecting, the phases, the ``write`` span and the
sync sites are also profiler ranges (``engine.<phase>``,
``engine.sync.<site>``), so the program's spans sit in the profiler's
trace on the kernels' clock. ``OBS_FENCE=1`` in the environment (or
:func:`set_fence`) still makes the engine call
``torch.cuda.synchronize`` on the device of each phase's products before
taking the next mark, so the host spans themselves measure device time,
at the cost of serializing the pipeline, which perturbs the very timing
being measured.  The default is therefore off.  On the CPU the fence
does nothing.

The reference's ``count_traced_rounds`` counts dispatches in one
``jax.make_jaxpr`` trace; eager torch has no trace to count, so it has
no port: ``obs.metrics.counting()`` around the eager call gives the
one-round property.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Sequence

from . import metrics

# the reference's names; the engine's device spans and timed host reads
# (RoundSpans, begin_round, device_span, host_read, DEVICE_SPANS) are the
# port's own, used by core/op_engine.py and core/routing.py
__all__ = ["RoundEvent", "TraceRecorder", "get_tracer", "record_round",
           "record_event", "PHASES", "fence_enabled", "set_fence", "fence"]

PHASES = ("bin", "dispatch", "apply", "collect", "commit")
# the device spans of an engine round on the card: its four issue phases
# and the write schedule inside ``apply``
DEVICE_SPANS = ("bin", "dispatch", "apply", "write", "collect")

_FENCE = os.environ.get("OBS_FENCE", "0") in ("1", "true", "yes")


def fence_enabled() -> bool:
    """Are phase marks fenced with ``torch.cuda.synchronize``?
    (``OBS_FENCE=1`` starts it on; default off = non-perturbing.)"""
    return _FENCE


def set_fence(on: bool) -> bool:
    """Toggle phase fencing; returns the previous state (for restore)."""
    global _FENCE
    prev, _FENCE = _FENCE, bool(on)
    return prev


def _tensors(values):
    """The tensors in a nest of tuples, lists and dicts."""
    import torch

    for v in values:
        if torch.is_tensor(v):
            yield v
        elif isinstance(v, (tuple, list)):
            yield from _tensors(v)
        elif isinstance(v, dict):
            yield from _tensors(v.values())


def fence(*values) -> None:
    """Barrier before a phase mark: when fencing is on, wait until the
    card holding the given tensors (the previous phase's products) has
    run everything queued on it, so the span measures device time rather
    than issue time.  Tensors on the CPU need no wait."""
    if _FENCE:
        import torch

        for dev in {t.device for t in _tensors(values) if t.is_cuda}:
            torch.cuda.synchronize(dev)


# estats lanes -> registry counters (plain additive flush).
_COUNTER_LANES = {
    "wire_words": "engine.wire_words",
    "wire_send_words": "engine.wire_send_words",
    "wire_reply_words": "engine.wire_reply_words",
    "dropped": "engine.dropped",
    "mismatches": "engine.mismatches",
    "lock_tokens": "engine.lock_tokens",
    "rounds": "engine.write_rounds",
    "inserted": "engine.inserted",
    "evicted": "engine.evicted",
    "hits": "dht.hits",
    "misses": "dht.misses",
    "l1_hits": "l1.hits",
    # replication lanes (DESIGN.md §13): reads served by a successor
    # because the owner's liveness bit was down, and secondary copies
    # fanned into write rounds (write amplification = writes/acked)
    "fallback_reads": "replica.fallback_reads",
    "replica_writes": "replica.writes",
    "acked": "replica.acked_writes",
    # rows a bounded retry round re-issued after an overflow drop — the
    # final round's unrecovered drops stay on engine.dropped
    "requeued": "engine.requeued",
}


@dataclasses.dataclass
class RoundEvent:
    """One recorded round.  ``ts``/``dur`` in seconds on the host
    ``perf_counter`` clock; ``spans`` maps phase -> (start, dur)."""

    source: str
    ts: float
    dur: float
    spans: dict
    ops: dict
    stats: dict

    def to_json(self) -> dict:
        return {
            "source": self.source,
            "ts": self.ts,
            "dur": self.dur,
            "spans": {k: [v[0], v[1]] for k, v in self.spans.items()},
            "ops": dict(self.ops),
            "stats": dict(self.stats),
        }


class TraceRecorder:
    """Bounded ring buffer of :class:`RoundEvent`."""

    def __init__(self, maxlen: int | None = None):
        if maxlen is None:
            maxlen = int(os.environ.get("OBS_TRACE_MAXLEN", "4096"))
        self._events: deque[RoundEvent] = deque(maxlen=maxlen)
        self.n_recorded = 0        # lifetime count (ring may have evicted)

    @property
    def maxlen(self) -> int:
        return self._events.maxlen or 0

    def record(self, ev: RoundEvent) -> None:
        self._events.append(ev)
        self.n_recorded += 1

    def events(self) -> list[RoundEvent]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.n_recorded = 0

    def to_jsonl(self, path: str) -> int:
        """One JSON object per line; returns the number of events."""
        evs = self.events()
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev.to_json(), sort_keys=True) + "\n")
        return len(evs)

    def to_chrome_trace(self, path: str) -> int:
        """Chrome ``trace_event`` JSON (complete "X" events, µs clock):
        one event per round plus one per phase span, nested on the same
        track so perfetto renders rounds with their phase breakdown."""
        events = []
        for ev in self.events():
            ts_us = ev.ts * 1e6
            events.append({
                "name": ev.source, "cat": "round", "ph": "X",
                "ts": ts_us, "dur": max(ev.dur, 0.0) * 1e6,
                "pid": 1, "tid": 1,
                "args": {"ops": ev.ops, **ev.stats},
            })
            for phase, (start, dur) in ev.spans.items():
                events.append({
                    "name": phase, "cat": "phase", "ph": "X",
                    "ts": start * 1e6, "dur": max(dur, 0.0) * 1e6,
                    "pid": 1, "tid": 1, "args": {},
                })
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return len(events)


_TRACER = TraceRecorder()


def get_tracer() -> TraceRecorder:
    return _TRACER


def _kind(v) -> str | None:
    """'b', 'i' or 'f' for a scalar lane, None for anything else (vectors,
    strings, None)."""
    import numpy as np
    import torch

    if isinstance(v, bool):         # the common host lanes, without numpy
        return "b"
    if isinstance(v, (int, float)):
        return "i" if isinstance(v, int) else "f"
    if torch.is_tensor(v):
        if v.dim() != 0 or v.is_complex():
            return None
        if v.dtype == torch.bool:
            return "b"
        return "f" if v.is_floating_point() else "i"
    try:
        a = np.asarray(v)
    except Exception:
        return None
    if a.ndim != 0 or a.dtype.kind not in "biuf":
        return None
    return "i" if a.dtype.kind == "u" else a.dtype.kind


class _HostLanes:
    """The scalar lanes of ``stats`` on their way to the host.  Python
    and numpy numbers are kept; the 0-d tensors of each device are
    packed into one float64 tensor (``torch.cat`` promotes every lane to
    it: exact for int32 and for int64 below 2**53, and for float32), in
    ``stats``' order.  With ``pin`` a CUDA pack is copied into pinned
    host memory without waiting: read :meth:`get` only after an event
    recorded later on the stream has completed.  Without it, :meth:`get`
    reads each pack with one blocking copy."""

    def __init__(self, stats: dict, *, pin: bool = False):
        import torch

        self.order: list[tuple[str, str]] = []
        self.host: dict = {}
        groups: dict = {}
        for k, v in stats.items():
            kind = _kind(v)
            if kind is None:
                continue
            self.order.append((k, kind))
            if torch.is_tensor(v):
                groups.setdefault(v.device, []).append((k, v.reshape(1)))
            else:
                self.host[k] = v.item() if hasattr(v, "item") else v
        self.packs = []
        for dev, lanes in groups.items():
            buf = torch.cat([torch.empty(0, dtype=torch.float64,
                                         device=dev)]
                            + [t for _, t in lanes])
            if pin and dev.type == "cuda":
                host = torch.empty(buf.shape, dtype=torch.float64,
                                   pin_memory=True)
                host.copy_(buf, non_blocking=True)
                buf = host
            self.packs.append(([k for k, _ in lanes], buf))

    def get(self) -> dict:
        vals = dict(self.host)
        for names, buf in self.packs:
            vals.update(zip(names, buf.tolist()))
        out = {}
        for k, kind in self.order:
            v = vals[k]
            out[k] = (bool(v) if kind == "b" else int(v) if kind == "i"
                      else float(v))
        return out


def _scalarize(stats: dict) -> dict:
    """The scalar stat lanes as plain Python numbers (one copy per
    device; vectors such as ``bin_counts`` are skipped)."""
    return _HostLanes(stats).get()


def record_round(source: str, stats: dict, *, ops: dict | None = None,
                 t_start: float | None = None,
                 phase_marks: Sequence[tuple[str, float]] = (),
                 dur: float | None = None) -> None:
    """Flush one executed round: trace event + registry accumulation.

    ``stats`` is the round's stat-lane dict (0-d tensors fine: fetched
    here, one copy per device).  ``phase_marks`` is ``[(phase,
    start_time), ...]`` in order; each phase ends where the next begins,
    the last at record time.  ``engine.rounds`` advances by the round's
    ``dispatch_rounds`` lane (default 1): the host-side executed-round
    counter.  ``dur`` overrides the measured duration, for callers that
    timed the round externally (e.g. a benchmark recording a median of k
    calls as one event)."""
    if not metrics.enabled():
        return
    scal = _scalarize(stats)
    now = time.perf_counter()
    ts = t_start if t_start is not None else now
    if dur is None:
        dur = max(now - ts, 0.0) if t_start is not None else 0.0
    else:
        dur = max(float(dur), 0.0)

    reg = metrics.get_registry()
    reg.inc("engine.rounds", int(scal.get("dispatch_rounds", 1)))
    for lane, name in _COUNTER_LANES.items():
        if lane in scal:
            reg.inc(name, int(scal[lane]))
    if "fill_frac" in scal:
        reg.observe("engine.fill_frac", scal["fill_frac"],
                    edges=metrics.FRACTION_EDGES)
    # per-round skew lanes (DESIGN.md §11): bin-count imbalance and the
    # hottest-shard traffic fraction ride every round's estats
    if "bin_imbalance" in scal:
        reg.observe("engine.bin_imbalance", scal["bin_imbalance"],
                    edges=metrics.RATIO_EDGES)
    if "hot_frac" in scal:
        reg.observe("engine.hot_frac", scal["hot_frac"],
                    edges=metrics.FRACTION_EDGES)
    # issue/commit pipelining lanes (DESIGN.md §12): what fraction of the
    # round's latency the caller hid by working between the two halves
    if "overlap_frac" in scal:
        reg.observe("engine.overlap_frac", scal["overlap_frac"],
                    edges=metrics.FRACTION_EDGES)
    if "hidden_us" in scal:
        reg.observe("engine.hidden_us", scal["hidden_us"],
                    edges=metrics.LATENCY_EDGES_US)
    # device spans of a round on the card (RoundSpans.lanes)
    for span in DEVICE_SPANS:
        if "device_us." + span in scal:
            reg.observe("engine.device_us." + span,
                        scal["device_us." + span],
                        edges=metrics.LATENCY_EDGES_US)
    if t_start is not None or dur > 0.0:
        reg.observe("engine.round_latency_us", dur * 1e6,
                    edges=metrics.LATENCY_EDGES_US)
    total_ops = 0
    for kind, n in (ops or {}).items():
        reg.inc(f"engine.ops.{kind}", int(n))
        total_ops += int(n)
    if total_ops:
        reg.observe("engine.batch_size", total_ops,
                    edges=metrics.SIZE_EDGES)
    if "l1_hits" in scal:
        reg.inc("l1.queries", total_ops)

    spans = {}
    marks = list(phase_marks)
    for i, (phase, start) in enumerate(marks):
        end = marks[i + 1][1] if i + 1 < len(marks) else now
        spans[phase] = (start, max(end - start, 0.0))
    _TRACER.record(RoundEvent(source=source, ts=ts, dur=dur,
                              spans=spans, ops=dict(ops or {}),
                              stats=scal))


def record_event(source: str, stats: dict | None = None, *,
                 t_start: float | None = None,
                 ops: dict | None = None) -> None:
    """Trace-only event (no ``engine.rounds`` side effect) — for host
    steps that wrap already-recorded rounds, e.g. one
    ``migration_step`` batch or a benchmark iteration."""
    if not metrics.enabled():
        return
    now = time.perf_counter()
    ts = t_start if t_start is not None else now
    _TRACER.record(RoundEvent(
        source=source, ts=ts, dur=max(now - ts, 0.0), spans={},
        ops=dict(ops or {}), stats=_scalarize(stats or {})))


# ---------------------------------------------------------------------------
# device spans, host reads and profiler ranges of an engine round
# ---------------------------------------------------------------------------

_CURRENT: "RoundSpans | None" = None   # the round whose issue half runs
_EVENTS: dict = {}                     # device index -> free timing events
_POOL_MAX = 64
_DRIVER = None


def _driver():
    """``cuEventRecord``, ``cuEventElapsedTime`` and the float the latter
    writes, bound with ctypes at first use.  A record or an elapsed read
    through them skips what ``torch.cuda.Event`` adds around the same
    call (setting the device; querying both events before an elapsed
    read).  A call that fails (a nonzero ``CUresult``) is made again
    through ``torch.cuda.Event``."""
    global _DRIVER
    if _DRIVER is None:
        import ctypes

        lib = ctypes.CDLL("libcuda.so.1")
        P = ctypes.c_void_p
        ms = ctypes.c_float()
        lib.cuEventRecord.argtypes = (P, P)
        lib.cuEventElapsedTime.argtypes = (ctypes.POINTER(ctypes.c_float),
                                           P, P)
        lib.cuEventRecord.restype = ctypes.c_int
        lib.cuEventElapsedTime.restype = ctypes.c_int
        _DRIVER = (lib.cuEventRecord, lib.cuEventElapsedTime, ms,
                   ctypes.pointer(ms))
    return _DRIVER


def _profiler():
    """torch's profiler module: its ``_is_profiler_enabled`` flag says
    whether a ``torch.profiler`` is collecting."""
    import torch.autograd.profiler as prof

    return prof


def _open_range(name: str):
    """Open a profiler range (``record_function``) named ``name``."""
    r = _profiler().record_function(name)
    r.__enter__()
    return r


class RoundSpans:
    """The device side of one self-recording engine round.

    On the card (``card``) each :meth:`phase` mark and each end of a
    :func:`device_span` records a timing CUDA event on the stream that
    was current when the round began (``stream``, which the round's own
    event is recorded on too), taken from a per-device pool so that a
    round makes no ``cudaEventCreate``.  Each timed host read of the
    round (:func:`host_read`) is kept as ``(site, us)``; :meth:`lanes`
    reads the elapsed times once the commit has waited on the round's
    own event, which every mark precedes on the stream, and flushes the
    reads into the registry.  While a ``torch.profiler`` is collecting,
    each phase is a profiler range ``engine.<phase>``, on the CPU too."""

    __slots__ = ("card", "prof", "stream", "raw", "pool", "marks",
                 "children", "waits", "_open")

    def __init__(self, device, prof):
        self.card, self.prof = device.type == "cuda", prof
        self.stream = self.raw = self.pool = None
        if self.card:
            import torch

            self.stream = torch.cuda.current_stream(device)
            self.raw = self.stream.cuda_stream
            self.pool = _EVENTS.setdefault(self.stream.device_index, [])
        self.marks: list = []        # (phase, event) in order
        self.children: list = []     # (span, start event, end event)
        self.waits: list = []        # (site, us) of the timed host reads
        self._open = None

    def _event(self):
        """A timing event, recorded now: ``(torch event, handle)``."""
        if self.pool:
            ev = self.pool.pop()
            if not _driver()[0](ev[1], self.raw):
                return ev
            ev = ev[0]
        else:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev, ev.cuda_event

    def _close(self) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None

    def phase(self, name: str) -> None:
        """End the running phase and start ``name``."""
        self._close()
        if self.prof._is_profiler_enabled:
            self._open = _open_range("engine." + name)
        if self.card:
            self.marks.append((name, self._event()))

    def close(self) -> None:
        """Close the open range (at the end of each half), and stop being
        the round that :func:`host_read` and :func:`device_span`
        charge."""
        global _CURRENT
        self._close()
        if _CURRENT is self:
            _CURRENT = None

    def commit(self) -> None:
        """Open the ``engine.commit`` range (closed by :meth:`close`)."""
        self._close()
        if self.prof._is_profiler_enabled:
            self._open = _open_range("engine.commit")

    def read(self, site: str, read, value):
        """``read(value)`` timed as a host sync of the round at ``site``
        (see :func:`host_read`)."""
        rng = (_open_range("engine.sync." + site)
               if self.prof._is_profiler_enabled else None)
        t = time.perf_counter()
        out = read(value)
        self.waits.append((site, (time.perf_counter() - t) * 1e6))
        if rng is not None:
            rng.__exit__(None, None, None)
        return out

    def lanes(self, end) -> dict:
        """The round's device-span lanes, each phase ending at the next
        mark and the last at ``end`` (the round's own event, already
        waited on), and ``issue_wait_us``, the sum of the issue half's
        timed reads; the timed reads go into ``engine.host_syncs`` and
        ``engine.sync_wait_us.<site>``, the events back to the pool.
        Empty off the card."""
        if not self.card:
            return {}
        _, elapsed, ms, ptr = _driver()

        def us(a, b):
            if elapsed(ptr, a[1], b[1]):
                return a[0].elapsed_time(b[0]) * 1e3
            return ms.value * 1e3

        marks = [ev for _, ev in self.marks]
        ends = marks[1:] + [(end, end.cuda_event)]
        out = {"device_us." + name: us(start, stop)
               for (name, start), stop in zip(self.marks, ends)}
        for name, start, stop in self.children:
            out["device_us." + name] = us(start, stop)
            marks += (start, stop)
        out["issue_wait_us"] = sum(w for s, w in self.waits
                                   if s != "commit")
        reg = metrics.get_registry()
        reg.inc("engine.host_syncs", len(self.waits))
        for site, wait in self.waits:
            reg.observe("engine.sync_wait_us." + site, wait,
                        edges=metrics.LATENCY_EDGES_US)
        self.pool.extend(marks[:_POOL_MAX - len(self.pool)])
        self.marks, self.children, self.waits = [], [], []
        return out


def begin_round(device) -> RoundSpans | None:
    """The :class:`RoundSpans` of a self-recording round on ``device``
    whose issue half starts now, its ``bin`` phase begun; None where it
    would record nothing (a round off the card with no profiler
    collecting)."""
    global _CURRENT
    if _CURRENT is not None:
        _CURRENT.close()
    prof = _profiler()
    if device.type != "cuda" and not prof._is_profiler_enabled:
        return None
    rs = _CURRENT = RoundSpans(device, prof)
    rs.phase("bin")
    return rs


class device_span:
    """``with device_span("write"): ...`` — a span inside the running
    phase of the current round: two timing events on the card, a
    profiler range ``engine.<name>`` while a profiler collects.  Outside
    a round it does nothing."""

    __slots__ = ("name", "rs", "start", "rng")

    def __init__(self, name: str):
        self.name, self.rs = name, _CURRENT

    def __enter__(self):
        rs = self.rs
        if rs is not None:
            self.rng = (_open_range("engine." + self.name)
                        if rs.prof._is_profiler_enabled else None)
            self.start = rs._event() if rs.card else None
        return self

    def __exit__(self, *exc):
        rs = self.rs
        if rs is not None:
            if rs.card:
                rs.children.append((self.name, self.start, rs._event()))
            if self.rng is not None:
                self.rng.__exit__(None, None, None)
        return False


def host_read(site: str, read, value, spans: RoundSpans | None = None):
    """``read(value)``: a host read of a device value in the engine round
    (the capacity plan's largest bin, a write pass's flag, the locked
    schedules' round count, the commit's wait on the round's event).  In
    a self-recording round on the card (``spans``, else the round whose
    issue half runs) the read is timed, and at commit counted in
    ``engine.host_syncs`` and observed into
    ``engine.sync_wait_us.<site>``; a profiler range
    ``engine.sync.<site>`` while a profiler collects.  Anywhere else it
    is the plain read."""
    rs = _CURRENT if spans is None else spans
    if rs is None or not rs.card:
        return read(value)
    return rs.read(site, read, value)
