"""Torch's intra-op threads in a pytest-xdist worker: the workers share
the machine's cores, so each takes its share of them, at least one.
Every ``tests/test_torch_*.py`` imports this module; outside xdist
(``PYTEST_XDIST_WORKER_COUNT`` unset) torch keeps its default.  The gloo
ranks that ``tests/torch_dist_ranks.py`` runs take one thread each."""
from __future__ import annotations

import os

import torch


def worker_threads() -> int | None:
    """The threads a worker gets: the cores it may run on over the
    workers, or None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else (os.cpu_count() or 1)
    return max(1, cores // int(workers))


_n = worker_threads()
if _n is not None:
    torch.set_num_threads(_n)
