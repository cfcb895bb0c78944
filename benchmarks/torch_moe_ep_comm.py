"""What one expert-parallel MoE layer (``models/moe_ep.py``) moves and
holds on a production mesh, counted as the dry run counts it: rank 0 of a
fake 256- or 512-rank world, ``meta`` shards, DTensor's collectives as
``CommDebugMode`` sees them.  No device is used.

    PYTHONPATH=src python benchmarks/torch_moe_ep_comm.py \\
        --arch qwen3-moe-235b-a22b --shape train_4k [--multi-pod]

The layer's input lies as the dry run's residual hint puts it (batch over
the data axes, sequence over ``model``; a decode step's batch over the
data axes), its parameters by ``launch/shardings.py``.  A train shape
runs the forward, and then the backward of the output and the aux loss
(each with a gradient of ones); remat runs the forward once more, so a
layer of a train step moves ``2 x forward + backward``.  Prints one JSON
object: the collective bytes and counts by kind of each pass, the
forward's temp bytes, and the per-layer and whole-model totals.
"""
from __future__ import annotations

import argparse
import json

import torch
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import dp_axes, fake_world, make_production_mesh
from repro_torch.launch.shardings import distribute_lm, placements
from repro_torch.models import init_lm
from repro_torch.models.moe_ep import moe_forward
from repro_torch.roofline.analysis import collective_bytes_of


def _counted(fn):
    """(collective bytes by kind, counts, temp bytes) of ``fn()``."""
    comm, cost = dryrun._CommLog(), dryrun._Rank0Cost()
    with dryrun._native_alltoall(), implicit_replication(), comm, cost:
        out = fn()
    coll = collective_bytes_of(comm.ops)
    return out, coll, coll.pop("_counts"), cost.peak


def layer_collectives(arch: str, shape_name: str, multi_pod: bool) -> dict:
    shape = SHAPES[shape_name]
    cfg = dryrun.probe_cfg(get_config(arch), 1)
    train = shape.kind == "train"
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        lm = init_lm(cfg, generator=torch.Generator(), device="meta")
        dryrun._cast_params(lm, torch.float32 if train else torch.bfloat16)
        lm.requires_grad_(train)
        distribute_lm(lm, mesh)
        moe = lm.stack.layers[0].moe
        dp = dp_axes(mesh)
        if shape.kind == "decode":
            spec, seq = (dp, None, None), 1
        else:
            spec, seq = (dp, "model", None), shape.seq
        x = distribute_tensor(
            torch.empty((shape.batch, seq, cfg.d_model),
                        dtype=getattr(torch, cfg.dtype), device="meta"),
            mesh, placements(spec, mesh)).requires_grad_(train)
        (y, stats), fwd, fwd_n, temp = _counted(lambda: moe_forward(moe, cfg, x))
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "pod2x16x16" if multi_pod else "pod16x16",
               "layers": get_config(arch).n_layers,
               "forward": fwd, "forward_counts": fwd_n,
               "forward_temp_bytes": temp}
        passes = {"forward": 1}
        if train:
            aux = stats["aux_loss"]
            ones = [torch.ones_like(y), torch.ones_like(aux)]
            _, bwd, bwd_n, _ = _counted(
                lambda: torch.autograd.backward([y, aux], ones))
            rec.update(backward=bwd, backward_counts=bwd_n)
            passes = {"forward": 2, "backward": 1}        # remat
        del y, stats
        per_layer = {k: sum(n * rec[p].get(k, 0) for p, n in passes.items())
                     for k in fwd}
        rec["per_layer"] = per_layer
        rec["per_layer_gb"] = sum(per_layer.values()) / 1e9
        rec["model"] = {k: v * rec["layers"] for k, v in per_layer.items()}
        rec["model_gb"] = rec["per_layer_gb"] * rec["layers"]
        rec["input_placements"] = str(x.placements)
        rec["expert_placements"] = str(moe["wi"]["w"].placements)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    print(json.dumps(layer_collectives(args.arch, args.shape, args.multi_pod)))


if __name__ == "__main__":
    main()
