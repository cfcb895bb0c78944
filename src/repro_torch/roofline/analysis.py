"""Three-term roofline from a dry-run record (``launch/dryrun.py``): the
port of ``repro/roofline/analysis.py`` on one NVIDIA H100 SXM's
constants.

    compute    = FLOPs            / (chips * PEAK_FLOPS)
    memory     = bytes accessed   / (chips * HBM_BW)
    collective = collective_bytes / (chips * LINK_BW)

FLOPs and bytes come from the dry run's per-device counts (rank 0's aten
ops under ``FlopCounterMode`` and their input and output bytes).
Collective bytes come from the collectives DTensor issued on rank 0, as
the dry run's ``CommDebugMode`` records them: ``collective_bytes_of``
takes the place of the reference's HLO-text parser.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

# NVIDIA H100 SXM5 (data sheet; dense rates, no sparsity, at 700 W)
PEAK_FLOPS = 989.4e12      # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s

# The links of the production mesh.  An H100 SXM node joins 8 GPUs by
# NVLink 4 (900 GB/s a GPU, both directions together: 450e9 each way);
# nodes are joined by one 400 Gb/s NDR InfiniBand adapter a GPU (DGX
# H100: eight ConnectX-7).  The (data=16, model=16) mesh puts 16 GPUs on
# each axis, so each axis's groups span two 8-GPU NVLink domains, and a
# ring collective over either axis runs at the rate of its slowest hop:
# InfiniBand.  The collective term uses that rate.
NVLINK_BW = 450e9          # bytes/s a GPU, one direction
IB_BW = 400e9 / 8          # bytes/s a GPU, one direction (400 Gb/s NDR)
LINK_BW = IB_BW            # the collective term's rate

# what each collective op DTensor issues is, by the reference's kinds
_KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all",
          "permute")
_OP_KIND = {
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "allgather_": "all_gather",
    "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "all_reduce": "all_reduce",
    "all_reduce_coalesced": "all_reduce",
    "allreduce_": "all_reduce",
    "allreduce_coalesced_": "all_reduce",
    "reduce_scatter_tensor": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "all_to_all_single": "all_to_all",
    "alltoall_": "all_to_all",
    "alltoall_base_": "all_to_all",
    "shard_dim_alltoall": "all_to_all",
    "permute_tensor": "permute",
    "send": "permute",
    "recv_": "permute",
    "send_": "permute",
}


def _kind(op_name: str) -> str:
    """The kind (``all_gather`` ...) of a collective op's name, e.g.
    ``_c10d_functional.all_gather_into_tensor.default``; an op of no
    known kind raises."""
    parts = op_name.split(".")
    for part in parts[1:] + parts[:1]:
        if part in _OP_KIND:
            return _OP_KIND[part]
    raise ValueError(f"collective op {op_name!r} has no known kind")


def collective_bytes_of(comm_ops: Iterable[tuple[str, int, int]]) -> dict:
    """Bytes per collective kind over ``(op name, operand bytes, output
    bytes)`` records (the dry run's ``CommDebugMode`` log of rank 0).

    As in the reference: for all-gather and all-to-all the output is the
    traffic, for all-reduce it equals the operand, for reduce-scatter the
    operand is the traffic; each op counts max(operand, output).  The
    counts per kind are under ``_counts``."""
    out: dict = {k: 0 for k in _KINDS}
    counts = {k: 0 for k in _KINDS}
    for op, operand, output in comm_ops:
        kind = _kind(op)
        out[kind] += max(int(operand), int(output))
        counts[kind] += 1
    out["_counts"] = counts
    return out


@dataclasses.dataclass
class Roofline:
    flops: float               # total FLOPs (global, per step)
    hbm_bytes: float           # total bytes accessed (global)
    coll_bytes: float          # total collective bytes (global)
    chips: int
    model_flops: float = 0.0   # 6*N*D analytic useful flops

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline-bound step time."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * PEAK_FLOPS)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck, "useful_ratio": self.useful_ratio,
            "mfu_bound": self.mfu,
        }


def overlap_speedup_bound(t_compute: float, t_round: float) -> dict:
    """Perfect-overlap bound for the pipelined issue/commit engine -- the
    same max-of-terms rule as :attr:`Roofline.step_time`, applied to the
    surrogate loop's two terms.  The synchronous schedule pays
    ``t_compute + t_round`` per batch; a pipelined one that fully hides
    the in-flight round behind the miss compute floors at
    ``max(t_compute, t_round)``.

    Returns the two step times, the resulting ``speedup_bound``, and
    ``hideable_frac`` -- the fraction of the round's latency that compute
    is long enough to hide (the ceiling ``overlap_frac`` can reach)."""
    sync = t_compute + t_round
    pipe = max(t_compute, t_round)
    return {
        "t_sync_s": sync,
        "t_overlap_s": pipe,
        "speedup_bound": (sync / pipe) if pipe > 0 else 1.0,
        "hideable_frac": (min(t_compute, t_round) / t_round)
        if t_round > 0 else 0.0,
    }


def analyze(record: dict, chips: int, model_flops: float) -> Roofline:
    """The roofline of one dry-run record (``launch.dryrun.run_cell``):
    its per-device FLOPs, bytes accessed and collective bytes times
    ``chips``."""
    cost = record["cost_per_device"]
    coll = sum(v for k, v in record["collective_bytes_per_device"].items()
               if not k.startswith("_"))
    return Roofline(
        flops=float(cost.get("flops", 0.0)) * chips,
        hbm_bytes=float(cost.get("bytes accessed", 0.0)) * chips,
        coll_bytes=float(coll) * chips,
        chips=chips,
        model_flops=model_flops,
    )


def model_flops_for(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (forward-only), with
    N = active params (MoE counts routed+shared only)."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        tokens = seq * batch
        return 6.0 * n_active * tokens
    if shape_kind == "prefill":
        tokens = seq * batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n_active * batch
