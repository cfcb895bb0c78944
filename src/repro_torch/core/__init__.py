"""Core of the port: slab layout, hashing, key rounding, routing, the
one-round op-engine in its three modes and its issue/commit halves, the
DHT wrappers (synchronous and split), the pipelining store buffer and
round queue, the L1 locality tier, the surrogate cache with its
pipelined driver and its neighbourhood interpolation (with the stencil
and key-rounding functions it is built from), the consistent-hash ring
and online resharding with its dual-epoch reads, k-successor
replication with crash failover, fault injection (``core.faults``) and
anti-entropy repair.  ``core.async_sim`` is the host-level torn-read
simulator and the issue/commit oracle."""
from .dht import (
    dht_read,
    dht_read_async,
    dht_read_cached,
    dht_read_commit,
    dht_read_dual,
    dht_read_many,
    dht_read_many_async,
    dht_read_many_commit,
    dht_read_many_dual,
    dht_write,
    dht_write_async,
    dht_write_commit,
    dht_write_replicated,
)
from .faults import (
    FaultPlan,
    clear,
    crash_shard,
    get_plan,
    injected,
    install,
    recover_shard,
)
from .interp import PROV_EXACT, PROV_INTERP, PROV_MISS, InterpConfig
from .l1cache import L1Config, L1State, l1_create, l1_flush
from .layout import (
    MODE_COARSE,
    MODE_FINE,
    MODE_LOCKFREE,
    MODES,
    DHTConfig,
    DHTState,
    dht_create,
    dht_free,
    dht_occupancy,
    occupancy,
    pack_floats,
    shard_watermark,
    unpack_floats,
    with_ring,
)
from .membership import (
    MAX_REPLICAS,
    RingState,
    ring_create,
    ring_crash,
    ring_join,
    ring_leave,
    ring_owner_of,
    ring_recover,
    ring_resize,
    ring_successors,
)
from .migrate import (
    Migration,
    MigrationPlan,
    Repair,
    RepairPlan,
    adopt_ring,
    dht_resize,
    migration_begin,
    migration_finish,
    migration_read,
    migration_step,
    plan_migration,
    plan_repair,
    repair_begin,
    repair_diff,
    repair_run,
    repair_step,
    shard_join,
    shard_leave,
)
from .neighbors import (
    dedup_mask,
    lattice_step,
    n_stencil,
    round_significant,
    stencil_keys,
    stencil_offsets,
    stencil_points,
)
from .op_engine import (
    OP_MIGRATE,
    OP_READ,
    OP_WRITE,
    W_DROPPED,
    W_EVICT,
    W_INSERT,
    W_SKIP,
    W_UPDATE,
    InFlightRound,
    OpBatch,
    dht_commit,
    dht_execute,
    dht_issue,
    dual_fusable,
    migrate_ops,
    mixed_ops,
    read_ops,
    replica_placement,
    write_ops,
)
from .pipeline import PendingWrites, RoundQueue
from .surrogate import (
    SurrogateConfig,
    lookup,
    lookup_cached,
    lookup_interpolate_or_compute,
    lookup_or_compute,
    lookup_or_compute_pipelined,
    lookup_or_interpolate,
    make_keys,
    store,
    surrogate_create,
)

__all__ = [
    "DHTConfig", "DHTState", "FaultPlan", "InFlightRound", "InterpConfig",
    "L1Config", "L1State", "MAX_REPLICAS", "MODES", "MODE_COARSE",
    "MODE_FINE", "MODE_LOCKFREE", "Migration", "MigrationPlan",
    "OP_MIGRATE", "OP_READ", "OP_WRITE", "OpBatch", "PROV_EXACT",
    "PROV_INTERP", "PROV_MISS", "PendingWrites", "Repair", "RepairPlan",
    "RingState", "RoundQueue", "SurrogateConfig", "W_DROPPED", "W_EVICT",
    "W_INSERT", "W_SKIP", "W_UPDATE", "adopt_ring", "clear", "crash_shard",
    "dedup_mask", "dht_commit", "dht_create", "dht_execute", "dht_free",
    "dht_issue", "dht_occupancy", "dht_read", "dht_read_async",
    "dht_read_cached", "dht_read_commit", "dht_read_dual", "dht_read_many",
    "dht_read_many_async", "dht_read_many_commit", "dht_read_many_dual",
    "dht_resize", "dht_write", "dht_write_async", "dht_write_commit",
    "dht_write_replicated", "dual_fusable", "get_plan", "injected",
    "install", "l1_create", "l1_flush", "lattice_step", "lookup",
    "lookup_cached", "lookup_interpolate_or_compute", "lookup_or_compute",
    "lookup_or_compute_pipelined", "lookup_or_interpolate", "make_keys",
    "migrate_ops", "migration_begin", "migration_finish", "migration_read",
    "migration_step", "mixed_ops", "n_stencil", "occupancy", "pack_floats",
    "plan_migration", "plan_repair", "read_ops", "recover_shard",
    "repair_begin", "repair_diff", "repair_run", "repair_step",
    "replica_placement", "ring_crash", "ring_create", "ring_join",
    "ring_leave", "ring_owner_of", "ring_recover", "ring_resize",
    "ring_successors", "round_significant", "shard_join", "shard_leave",
    "shard_watermark", "stencil_keys", "stencil_offsets", "stencil_points",
    "store", "surrogate_create", "unpack_floats", "with_ring", "write_ops",
]
