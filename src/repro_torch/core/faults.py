"""Fault injection for the replicated DHT (PyTorch port of
``repro.core.faults``).

Two fault classes, both deterministic so a failure reproduces:

- **Abrupt shard death**: :func:`crash_shard` drops the ring's liveness
  bit *without* rebuilding placement (``membership.ring_crash``) and, by
  default, zeroes the dead shard's slab rows (its memory is gone: a
  crash, not a graceful ``shard_leave``).  Every key keeps its owner and
  successor set, so reads fail over to the first live successor and
  replicated writes land on the surviving copies.  :func:`recover_shard`
  brings the shard back empty; anti-entropy repair
  (``core/migrate.plan_repair`` / ``repair_step``) heals it from the
  surviving replicas.
- **Message drops and delays**: an installed :class:`FaultPlan` makes
  the op-engine (``op_engine.dht_issue``) drop a fraction of each
  eligible round's rows before routing.  A dropped row reports exactly
  like a routing overflow (``W_DROPPED`` / not found), so the retry paths
  under test cannot tell an injected fault from a real one.
  ``delay_us`` sleeps the host before the issue.  The engine consults
  the plan on the single-device backend only (``axis_name`` None), as
  the reference's traced sharded closures never see it; with no plan
  installed the hook costs nothing on the card.

The plan is process-wide (one process, one fault domain): install it
with :func:`install` / :func:`clear` or the :func:`injected` context
manager.  The drop mask comes from numpy's ``default_rng((seed,
rounds_seen))``, so a plan drops the same rows as the reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from .layout import DHTState
from .membership import ring_crash, ring_recover

__all__ = ["FaultPlan", "clear", "crash_shard", "get_plan", "injected",
           "install", "recover_shard"]


@dataclasses.dataclass
class FaultPlan:
    """Deterministic drop/delay schedule for engine rounds.

    ``drop_frac`` of each eligible round's valid rows are masked out
    before routing; a round is eligible when its op kinds meet ``kinds``
    (default: the write-ish rounds, the ones with retry paths).  The mask
    derives from ``(seed, rounds_seen)`` only, so a re-run with the same
    plan and call sequence injects the same faults."""

    seed: int = 0
    drop_frac: float = 0.0
    delay_us: float = 0.0
    kinds: tuple[str, ...] = ("write", "migrate")
    rounds_seen: int = 0
    injected: int = 0

    def perturb(self, ops, kinds: tuple[str, ...]):
        """Apply this plan to one round's ``OpBatch``; returns the
        (possibly masked) batch.  Drawing a mask reads the round's valid
        lane back to the host once."""
        if self.kinds and not (set(kinds) & set(self.kinds)):
            return ops
        self.rounds_seen += 1
        if self.delay_us:
            time.sleep(self.delay_us * 1e-6)
        if not self.drop_frac:
            return ops
        rng = np.random.default_rng((self.seed, self.rounds_seen))
        valid = ops.valid.cpu().numpy()
        drop = (rng.random(valid.shape[0]) < self.drop_frac) & valid
        n = int(drop.sum())
        if n == 0:
            return ops
        self.injected += n
        obs_metrics.inc("faults.injected_drops", n)
        keep = torch.from_numpy(~drop).to(ops.valid.device)
        return dataclasses.replace(ops, valid=ops.valid & keep)


_PLAN: FaultPlan | None = None


def install(plan: FaultPlan) -> None:
    """Install the process-wide fault plan (replaces any other)."""
    global _PLAN
    _PLAN = plan


def clear() -> None:
    global _PLAN
    _PLAN = None


def get_plan() -> FaultPlan | None:
    return _PLAN


@contextlib.contextmanager
def injected(**kw):
    """``with injected(drop_frac=0.1, seed=3): ...``: a scoped plan."""
    plan = FaultPlan(**kw)
    install(plan)
    try:
        yield plan
    finally:
        clear()


def _whole(state: DHTState) -> None:
    if state.ring is None:
        raise ValueError("crash tolerance needs a membership ring")
    if state.n_local != state.cfg.n_shards:
        raise ValueError("a rank's shard crashes through ShardedDHT.crash")


def wipe_shard(state: DHTState, local: int) -> None:
    """Zero the slab rows of the table's ``local``-th shard in place (a
    rank's own shard is its 0th); the dump row is not one of them."""
    b = state.cfg.buckets_per_shard
    rows = slice(local * b, (local + 1) * b)
    for buf in (state.flat_keys, state.flat_vals, state.flat_meta,
                state.flat_csum):
        buf[rows] = 0


def crash_shard(state: DHTState, shard_id: int, *,
                wipe: bool = True) -> DHTState:
    """Abrupt shard death: liveness bit down, epoch + 1, placement kept
    (``membership.ring_crash``) and, unless ``wipe=False``, the dead
    shard's slab rows zeroed in place (the dump row is not one of them).
    The epoch bump is the L1's crash fence: every line cached before the
    crash is epoch-stale and stops serving.  Returns the table under the
    new ring; its buffers are ``state``'s."""
    _whole(state)
    ring = ring_crash(state.ring, shard_id)
    if wipe:
        wipe_shard(state, shard_id)
    obs_metrics.inc("faults.crashes")
    return DHTState(state.cfg, state.flat_keys, state.flat_vals,
                    state.flat_meta, state.flat_csum, ring)


def recover_shard(state: DHTState, shard_id: int) -> DHTState:
    """The crashed shard returns (empty) at epoch + 1; anti-entropy
    repair (``core/migrate.repair_run``) re-converges its replica set
    from the surviving copies."""
    _whole(state)
    obs_metrics.inc("faults.recoveries")
    return DHTState(state.cfg, state.flat_keys, state.flat_vals,
                    state.flat_meta, state.flat_csum,
                    ring_recover(state.ring, shard_id))
