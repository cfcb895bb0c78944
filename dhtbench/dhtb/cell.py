"""One run of one cell: set-up, the measured window, with ``trace`` the
traced rounds after it, then the reference's check of the answers the
window kept.

Set-up (counted in ``setup_s``): the traffic pool made on the device
from the seed, the program's table created and filled, and a few rounds
of the cell's traffic to warm every shape the window uses (the kernels
are built and loaded there).  The window then drives the program in a
closed loop for ``seconds``.  Nothing is read back from the device for
the harness inside it: the answers it checks are kept as the program
returned them and compared once the window has closed, the table freed
and the memory peak read.
"""
from __future__ import annotations

import dataclasses
import glob
import inspect
import math
import os
import statistics
import sys
import time

from . import loop, manifest
from . import trace as tr

# traced runs: the rounds profiled with CUDA activity alone (busy share,
# kernel time, syncs), then with the host's operators (idle gaps)
PROFILE_S = 1.0
GAPS_S = 0.25


def _p95(xs: list) -> float:
    s = sorted(xs)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def sampled_fn(pool):
    every, off = pool.sample_every, pool.sample_offset
    return lambda i: (i + off) % every == 0


def _registry():
    """The program's telemetry registry: counters and histogram
    ``(total, count)`` by name."""
    from repro_torch.obs import metrics

    reg = metrics.get_registry()
    snap = reg.snapshot()
    hists = {k: (reg.histogram(k).total, reg.histogram(k).count)
             for k in snap["histograms"]}
    return dict(snap["counters"]), hists


def _delta(after: tuple, before: tuple) -> tuple:
    c1, h1 = after
    c0, h0 = before
    counters = {k: v - c0.get(k, 0) for k, v in c1.items()}
    hists = {k: (t - h0.get(k, (0.0, 0))[0], n - h0.get(k, (0.0, 0))[1])
             for k, (t, n) in h1.items()}
    return counters, hists


class Labelled:
    """A client whose issue and commit run inside profiler ranges, so the
    trace can say what the host was doing around an idle gap."""

    def __init__(self, client):
        self.d, self.depth = client, client.depth

    def issue(self, i, w):
        from torch.profiler import record_function

        with record_function("dhtbench.issue"):
            return self.d.issue(i, w)

    def commit(self, h):
        from torch.profiler import record_function

        with record_function("dhtbench.commit"):
            return self.d.commit(h)

    def ops(self, i):
        return self.d.ops(i)


def roofline_modules(bench) -> list:
    """Every kernel that has a file under ``roofline/`` (one naming the
    kernel switch's function ``OP``)."""
    names = sorted(os.path.basename(p)[:-3] for p in
                   glob.glob(str(bench / "roofline" / "*.py")))
    mods = [manifest.load_module("roofline", n, bench) for n in names]
    return [m for m in mods if hasattr(m, "OP")]


def capture_work(client, mods) -> dict:
    """One round with each kernel that has a roofline file counted: the
    bytes and operations its calls need, from each call's arguments and
    answer (worked out right after the call, outside any timing)."""
    from repro_torch.kernels import ops

    work = {m.OP: [0, 0, 0] for m in mods}
    orig = {m.OP: getattr(ops, m.OP) for m in mods}

    def wrap(mod, fn):
        sig = inspect.signature(fn)

        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            b, o = mod.work(bound.args, out)
            w = work[mod.OP]
            w[0] += b
            w[1] += o
            w[2] += 1
            return out
        return counted

    for m in mods:
        setattr(ops, m.OP, wrap(m, orig[m.OP]))
    try:
        loop.drive(client, rounds=client.depth)
    finally:
        for name, fn in orig.items():
            setattr(ops, name, fn)
    rounds = client.depth
    return {k: {"bytes": b / rounds, "ops": o / rounds, "calls": c / rounds}
            for k, (b, o, c) in work.items() if c}


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read."""

    window: loop.Window
    counters: dict
    hists: dict
    profile: dict
    work: dict
    kernel_s: dict
    bound_s: object = None

    def stat(self, key: str) -> list:
        return [s[key] for s in self.window.stats if key in s]

    def median(self, key: str):
        xs = self.stat(key)
        return statistics.median(xs) if xs else None

    def hist_mean(self, name: str):
        t, n = self.hists.get(name, (0.0, 0))
        return t / n if n else None

    def per_round(self, key: str):
        n = self.profile.get("rounds", 0)
        return self.profile[key] / n if n and key in self.profile else None

    def roofline_pct(self, op: str):
        """The kernel's share of its roofline: the least time its work
        could take at the published peaks over its device time, per
        round.  None where the kernel did not run."""
        w = self.work.get(op)
        dev, n = self.kernel_s.get(op, (0.0, 0)), self.profile.get("rounds", 0)
        if not w or not dev[1] or not n:
            return None
        return 100.0 * self.bound_s(w["bytes"], w["ops"]) / (dev[0] / n)


def prepare(spec: dict, seed: int, dev, t_start: float):
    """Set-up: the pool from the seed, the program's table filled, and
    the pool's warm-up rounds.  Says on standard error where the
    set-up's time went."""
    import torch

    import repro_torch.core  # noqa: F401  (the program's import is set-up)

    gen = manifest.load_module("traffic", spec["kind"], spec["bench"])
    drv = manifest.load_module("clients", spec["kind"], spec["bench"])
    marks = [("start", t_start), ("imports", time.perf_counter())]
    torch.empty(1, device=dev)
    marks.append(("device", time.perf_counter()))
    pool = gen.make_pool(spec["traffic"], spec["config"], seed, dev)
    client = drv.Client(spec["config"], pool, dev)
    client.sync()
    marks.append(("pool and table", time.perf_counter()))
    client.fill()
    marks.append(("fill", time.perf_counter()))
    loop.drive(client, rounds=pool.warm_rounds + client.depth)
    client.sync()
    marks.append(("warm-up", time.perf_counter()))
    print("setup: " + ", ".join(f"{name} {t - t0:.3f} s" for (_, t0), (name, t)
                                in zip(marks, marks[1:])), file=sys.stderr)
    return pool, client


def run(spec: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> tuple:
    """Run the cell once.  Returns ``(result, checks)``: the result
    line's ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
    and, traced, ``breakdown``; and each number compared beside its
    limit."""
    import torch

    config = spec["config"]
    ref = manifest.load_module("reference", spec["kind"], spec["bench"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    pool, client = prepare(spec, seed, dev, t_start)
    setup_s = time.perf_counter() - t_start

    before = _registry()
    win = loop.drive(client, seconds=seconds, window=True,
                     sampled=sampled_fn(pool))
    counters, hists = _delta(_registry(), before)

    result = {"correct": False, "attempted": win.ops,
              "failed": int(counters.get("engine.dropped", 0))}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else dev.type),
                   "count": 1}
    metrics = {}
    if trace:
        mods = roofline_modules(spec["bench"])
        prof = {}
        if on_card:
            events, window_s = tr.profile_rounds(
                lambda: prof.update(rounds=loop.drive(
                    client, seconds=PROFILE_S).rounds), host_ops=False)
            prof.update(busy_s=tr.busy_s(events), window_s=window_s,
                        host_syncs=tr.host_syncs(events))
            kernel_s = {m.OP: tr.kernel_s(events, m.KERNEL) for m in mods}
            ops_top = tr.device_ops(events)
            events, _ = tr.profile_rounds(
                lambda: loop.drive(Labelled(client), seconds=GAPS_S),
                host_ops=True)
            result["breakdown"] = {"device_ops": ops_top,
                                   "idle_gaps": tr.idle_gaps(events)}
            device_info.update(busy_s=prof["busy_s"],
                               window_s=prof["window_s"])
            del events
        else:
            kernel_s = {}
        ctx = Context(window=win, counters=counters, hists=hists,
                      profile=prof, work=capture_work(client, mods),
                      kernel_s=kernel_s, bound_s=manifest.load_module(
                          "roofline", "peaks", spec["bench"]).bound_s)
        for m in spec["per_layer"]:
            v = manifest.metric_reader(m["name"], spec["bench"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"round_ms_p95": 1e3 * _p95(win.latency_s),
               "setup_s": setup_s}
        for m in spec["end_to_end"]:
            v = (win.ops / win.span_s if m["name"].endswith("_per_s")
                 else e2e[m["name"]])
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    client.sync()
    device_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                        if on_card else 0)
    log = client.log
    client.free()
    del client
    if on_card:
        torch.cuda.empty_cache()

    numbers = ref.check(config, pool, log, win.kept)
    checks = limits_of(ref, numbers)
    result.update(correct=all(c["ok"] for c in checks.values()),
                  metrics=metrics, device=device_info)
    return result, checks


def limits_of(ref, numbers: dict) -> dict:
    """Each number compared beside its limit: at most ``LIMITS[name]``,
    and at least one round checked."""
    out = {k: {"value": numbers[k], "limit": lim, "ok": numbers[k] <= lim}
           for k, lim in ref.LIMITS.items()}
    out["rounds_checked"] = {"value": numbers["rounds_checked"], "limit": 1,
                             "ok": numbers["rounds_checked"] >= 1}
    return out
