"""Reading ``torch.profiler`` traces of a run of rounds: the device's busy
time, each kernel's device time, the host's synchronisations, and what
the host was doing while the device sat idle."""
from __future__ import annotations

import bisect
import re
import time


def profile_rounds(run, *, host_ops: bool):
    """``run()`` under ``torch.profiler``: CUDA activity alone (kernels,
    copies and the CUDA runtime's calls), or with ``host_ops`` the host's
    operators too.  Returns ``(events, window_s)``: the window is the
    host's clock from the start of ``run`` to the end of its device
    work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return prof.events(), window


def _device_events(events):
    """Operations on the device: kernels, copies and sets, without the
    device-side spans the profiler draws for host ranges."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    return [e for e in events if e.device_type != cpu
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("dhtbench.")]


def _host_events(events):
    import torch

    cpu = torch.autograd.DeviceType.CPU
    return [e for e in events if e.device_type == cpu]


def _merged(events) -> list:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    out = []
    for s, t in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_s(events) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(t - s for s, t in _merged(_device_events(events))) / 1e6


def kernel_s(events, pattern: str) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose name matches."""
    rx = re.compile(pattern)
    hit = [e for e in _device_events(events) if rx.search(e.name)]
    return sum(e.time_range.end - e.time_range.start for e in hit) / 1e6, len(hit)


def host_syncs(events) -> int:
    """The program's waits on the device: the runtime's stream and event
    synchronisations and blocking copies (the harness's own waits are
    ``cudaDeviceSynchronize`` and are left out)."""
    return sum(1 for e in _host_events(events)
               if e.name in ("cudaStreamSynchronize", "cudaEventSynchronize",
                             "cudaMemcpy"))


def device_ops(events, top: int = 10) -> list:
    """``[[name, seconds], ...]``: the device operations that took most
    time."""
    tot: dict[str, float] = {}
    for e in _device_events(events):
        name = e.name[:120]
        tot[name] = tot.get(name, 0.0) + (e.time_range.end
                                          - e.time_range.start) / 1e6
    return sorted(([n, s] for n, s in tot.items()), key=lambda r: -r[1])[:top]


def idle_gaps(events, top: int = 10) -> list:
    """``[[name, seconds], ...]``: the device's idle gaps between two
    operations, summed by the innermost host operation under way at each
    gap's middle (with the harness range around it, where there is one)."""
    gaps = _merged(_device_events(events))
    host = sorted(_host_events(events), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    tot: dict[str, float] = {}
    for (_, a), (b, _) in zip(gaps, gaps[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner, outer = None, None
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            e = host[j]
            if e.time_range.end >= mid:
                if inner is None:
                    inner = e.name
                if e.name.startswith("dhtbench."):
                    outer = e.name
                    break
            if mid - e.time_range.start > 1e6:   # no range spans 1 s
                break
        if inner is None:
            name = "no host operation"
        elif outer is None or outer == inner:
            name = inner
        else:
            name = f"{outer}/{inner}"
        tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
    return sorted(([n, s] for n, s in tot.items()), key=lambda r: -r[1])[:top]
