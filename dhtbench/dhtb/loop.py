"""The closed loop that drives a cell's rounds: at most ``depth`` rounds in
flight, the next issued as soon as the oldest is committed."""
from __future__ import annotations

import collections
import dataclasses
import time


@dataclasses.dataclass
class Window:
    """What a run of rounds left: each round's latency (issue to results
    on the host), the program's per-round stats, the answers of the
    rounds the reference checks, the requests, and the span from the
    first issue to the last commit."""

    latency_s: list
    stats: list
    kept: dict
    ops: int
    rounds: int
    span_s: float


def drive(client, *, seconds: float | None = None, rounds: int | None = None,
          window: bool = False, sampled=None) -> Window:
    """Issue rounds until ``seconds`` have passed since the first issue
    (or ``rounds`` are issued), then drain.  With ``window`` the rounds
    are numbered in the client's log as the window's; ``sampled(i)``
    keeps round ``i``'s answers, and the last round's are always kept."""
    lat, stats, kept = [], [], {}
    inflight = collections.deque()
    ops = 0
    last = None

    def finish():
        nonlocal ops, last
        i, t0, handle = inflight.popleft()
        out, st = client.commit(handle)
        lat.append(time.perf_counter() - t0)
        stats.append(st)
        ops += client.ops(i)
        if window:
            last = (i, out)
            if sampled is not None and sampled(i):
                kept[i] = out

    t_first = time.perf_counter()
    i = 0
    while (time.perf_counter() - t_first < seconds if rounds is None
           else i < rounds):
        t0 = time.perf_counter()
        inflight.append((i, t0, client.issue(i, i if window else None)))
        if len(inflight) >= client.depth:
            finish()
        i += 1
    while inflight:
        finish()
    span = time.perf_counter() - t_first
    if last is not None:
        kept[last[0]] = last[1]
    return Window(latency_s=lat, stats=stats, kept=kept, ops=ops, rounds=i,
                  span_s=span)
