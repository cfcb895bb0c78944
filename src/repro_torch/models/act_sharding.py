"""Activation sharding on DTensor: the residual and decode hints of
``repro/models/act_sharding.py``, and every other decision of how a
layer's activations lie on the mesh when its parameters are DTensors
(``launch.shardings.distribute_lm``).

The launcher installs placements for the (B, S, E) residual stream;
``Stack`` applies them at every period-group boundary, so the layer
inputs that remat keeps stay sharded (batch over DP, sequence over TP).
With no placements installed, or on a plain tensor, a hint returns its
input.  A redistribution that DTensor cannot make raises.

The layers (``layers.dense``/``embed``/``unembed``, ``flash`` and
``attention``, ``model.loss_fn``/``greedy_sample``) keep one path for
plain tensors and hand a call whose input is a DTensor to the function
of this module that does the same work on DTensors.  Every function
below but the hints takes DTensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

_ACT = None      # (mesh, placements) or None
_DECODE = None


def set_activation_spec(spec) -> None:
    """spec: ``(mesh, placements)`` for the (B, S, E) residual, or None."""
    global _ACT
    _ACT = spec


def set_decode_spec(spec) -> None:
    """Decode-path residual placements (B, 1, E), or None.  Sharding E
    over the FSDP axes makes every weight matmul a local partial dot and
    an activation-sized all-reduce instead of a weight all-gather."""
    global _DECODE
    _DECODE = spec


def _hint(x: torch.Tensor, spec) -> torch.Tensor:
    if spec is None or x.dim() != 3 or not isinstance(x, DTensor):
        return x
    mesh, pl = spec
    if x.device_mesh != mesh:
        raise ValueError(f"residual on {x.device_mesh}, hint on {mesh}")
    return x.redistribute(mesh, pl)


def hint_residual(x: torch.Tensor) -> torch.Tensor:
    return _hint(x, _ACT)


def hint_decode(x: torch.Tensor) -> torch.Tensor:
    return _hint(x, _DECODE)


# ---------------------------------------------------------------------------
# placements of products and reshapes
# ---------------------------------------------------------------------------

def _split_on(x: DTensor, dim: int) -> bool:
    return any(isinstance(p, Shard) and p.dim == dim for p in x.placements)


def reduce_partial(x: DTensor, like: torch.Tensor | None = None) -> DTensor:
    """Partial sums (a product contracted over a split dim) reduced: onto
    ``like``'s batch split (dim 0) on the mesh dims where ``like`` has
    one, else onto a batch split where dim 0 divides the mesh dim (a
    reduce-scatter), else replicated (an all-reduce).  Without partial
    sums ``x`` is returned as it is."""
    if not any(p.is_partial() for p in x.placements):
        return x
    mesh = x.device_mesh
    ref = like.placements if isinstance(like, DTensor) else (None,) * mesh.ndim

    def settled(i, p, lp):
        if not p.is_partial():
            return p
        if isinstance(lp, Shard) and lp.dim == 0:
            return lp
        if like is None and not _split_on(x, 0) and x.shape[0] % mesh.size(i) == 0:
            return Shard(0)
        return Replicate()

    return x.redistribute(mesh, [settled(i, p, lp) for i, (p, lp)
                                 in enumerate(zip(x.placements, ref))])


def merge_heads(x: DTensor) -> DTensor:
    """(B, S, H, D) -> (B, S, H*D).  A split over the last dim (head_dim,
    where the heads do not divide the tensor-parallel axis) is gathered
    first, and the flat result is pinned to its placements, so that the
    backward hands the reshape a gradient it can split back into (H, D):
    DTensor cannot split H*D when H does not divide the mesh dim."""
    shape = (*x.shape[:2], -1)
    last = x.dim() - 1
    if not _split_on(x, last):
        return x.reshape(shape)
    pl = [Replicate() if isinstance(p, Shard) and p.dim == last else p
          for p in x.placements]
    y = x.redistribute(x.device_mesh, pl).reshape(shape)
    return y.redistribute(y.device_mesh, y.placements)


def _gather_inner(x: torch.Tensor) -> torch.Tensor:
    """An activation split over a dim between its first and last (the
    sequence, under the sequence-parallel residual hint) gathered over
    it: the matmul folds the leading dims into one, and DTensor folds two
    split dims only in some versions.  A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    inner = [isinstance(p, Shard) and 0 < p.dim < x.dim() - 1
             for p in x.placements]
    if not any(inner):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if i else p for i, p
                                          in zip(inner, x.placements)])


def _pin_grad(y: DTensor) -> DTensor:
    """``y``, whose gradient is handed back in ``y``'s placements (a
    redistribution to them, a no-op forward): a matmul's backward folds
    its gradient's leading dims, which DTensor does not where a later
    split of the residual (the sequence) has reached it."""
    return y.redistribute(y.device_mesh, y.placements)


# ---------------------------------------------------------------------------
# the layers' DTensor versions
# ---------------------------------------------------------------------------

def dense(w: torch.Tensor, x: torch.Tensor,
          b: torch.Tensor | None = None) -> DTensor:
    """``layers.dense`` where ``w`` or ``x`` is a DTensor.  A weight
    (in, o1, o2) split over its last dim is flattened as (in, o2*o1), the
    split dim outermost: DTensor cannot split the product o1*o2 back into
    (o1, o2) when o1 does not divide the mesh dim."""
    w = w.to(x.dtype)
    x = _gather_inner(x)
    if isinstance(w, DTensor) and w.dim() == 3 and _split_on(w, 2):
        o1, o2 = w.shape[1:]
        y = x @ w.permute(0, 2, 1).reshape(w.shape[0], o2 * o1)
        y = y.reshape(*x.shape[:-1], o2, o1).transpose(-1, -2)
    else:
        y = (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])
    y = _pin_grad(y)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def embed(table: DTensor, ids: torch.Tensor, scale: bool) -> DTensor:
    """``layers.embed`` on a DTensor table.  A table split over its rows
    is gathered over them first: DTensor's masked lookup into a row-split
    table loses its mask when the ids are split too."""
    table = table.redistribute(table.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == 0 else p
        for p in table.placements])
    y = F.embedding(ids, table)
    if scale:
        y = y * math.sqrt(table.shape[-1])
    return y


def unembed(table: torch.Tensor, x: DTensor) -> DTensor:
    """``layers.unembed`` on a DTensor activation."""
    return _pin_grad(_gather_inner(x) @ table.to(x.dtype).T)


def argmax(logits: DTensor) -> DTensor:
    """The first index of the maximum over the last dim, as ``argmax``,
    from two reductions that a vocabulary split over devices turns into
    all-reduces (max, min): DTensor's own split argmax fails on meta
    shards."""
    iota = torch.arange(logits.shape[-1], device=logits.device)
    top = logits.amax(dim=-1, keepdim=True)
    return torch.where(logits == top, iota, logits.shape[-1]).amin(dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def align_heads(q, k, v):
    """``(q, k, v)`` laid out so that DTensor can group the query heads
    by KV head, (B, S, H, D) -> (B, S, Hk, G, D), and score them where
    they lie.

    A partial sum in ``q`` (a projection contracted over a split model
    dim) is reduced first, onto the keys' batch split where they have
    one.  Where the keys are not split over their heads (KV heads that do
    not divide the tensor-parallel mesh dim) and the queries are fewer
    (decode) while ``k`` is split over head_dim (D), ``q`` is split over D
    as ``k`` is and the scores are partial sums over D: the smaller
    tensor moves.  Where the queries are as many (training, prefill) and
    split over their heads, each KV head is repeated for its group of
    query heads and split as they are: DTensor cannot split a sharded H
    into (Hk, G)."""
    if not isinstance(k, DTensor):
        return q, k, v
    mesh = q.device_mesh
    q = reduce_partial(q, like=k)
    h, hk = q.shape[2], k.shape[2]
    d_split = [isinstance(p, Shard) and p.dim == 3 for p in k.placements]
    if _split_on(k, 2):
        return q, k, v
    if q.shape[1] < k.shape[1] and any(d_split):
        return q.redistribute(mesh, [Shard(3) if split else qp for qp, split
                                     in zip(q.placements, d_split)]), k, v
    if hk == h or not _split_on(q, 2):
        return q, k, v

    def placement(qp, kp):
        if isinstance(qp, Shard) and qp.dim == 2:
            return qp                  # the heads, as the queries'
        if isinstance(kp, Shard) and kp.dim in (0, 1):
            return kp                  # batch or length, as the keys'
        return qp if isinstance(qp, Shard) and qp.dim == 0 else Replicate()

    def rep(t):
        b, n, _, d = t.shape
        t = t[:, :, :, None, :].expand(b, n, hk, h // hk, d).reshape(b, n, h, d)
        return t.redistribute(mesh, [
            placement(qp, kp) for qp, kp in zip(q.placements, t.placements)])

    return q, rep(k), rep(v)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes its gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _on_local_shards(heads_fn, q, k, v, *rows):
    """``heads_fn(q, k, v, *rows)`` ((B, S, H, D)) run on each device's
    shards, flattened to (B, S, H*D) split as ``q`` (heads outermost in
    H*D), where ``q``, ``k`` and ``v`` are split alike over batch (dim 0)
    and heads (dim 2) only: attention is independent across both, so no
    op of it needs planning and no collective.  ``rows`` (positions,
    masks: plain tensors, the same on every rank) are split over the
    batch as ``q`` is where they have its batch, else replicated.  None
    where the inputs are not so split."""
    if not (isinstance(k, DTensor) and isinstance(v, DTensor)):
        return None
    pl = q.placements
    if not (pl == k.placements == v.placements and all(
            isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim in (0, 2))
            for p in pl)):
        return None
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    batch = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in pl)
    rep = (Replicate(),) * mesh.ndim
    rows = [r if isinstance(r, DTensor) else
            DTensor.from_local(r, mesh, rep, run_check=False) for r in rows]

    def local(q, k, v, *rows):
        # contiguous gradients and output: DTensor views the gradients it
        # is handed back as the shards it handed out
        q, k, v = (_ContiguousGrad.apply(t) for t in (q, k, v))
        return heads_fn(q, k, v, *rows).flatten(2).contiguous()

    run = local_map(local, out_placements=list(pl),
                    in_placements=(pl, pl, pl, *[batch if r.shape[0] == q.shape[0]
                                                 else rep for r in rows]),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(q, k, v, *rows)


def attention(heads_fn, q, k, v, *rows) -> DTensor:
    """``heads_fn(q, k, v, *rows)`` -- an attention in plain ops, q (B,
    S, H, D), k/v (B, L, Hk, D) -> (B, S, H, D) -- on DTensors, flattened
    to (B, S, H*D).  On each device's shards where ``align_heads`` leaves
    the inputs split over batch and heads only; otherwise through
    DTensor op by op (scores split over D are partial sums)."""
    q, k, v = align_heads(q, k, v)
    out = _on_local_shards(heads_fn, q, k, v, *rows)
    return merge_heads(heads_fn(q, k, v, *rows)) if out is None else out


def _on_card(x: DTensor) -> bool:
    return x.device.type == "cuda"


def local_attention(kernel, banded, q, k, v, *rows) -> DTensor:
    """A causal sliding-window layer on DTensors, (B, S, H*D).  On the
    card ``kernel(q, k, v)`` (the local-attention kernel, (B, S, H, D))
    runs on each device's shards, which must be split over batch and
    heads only -- the kernel takes plain tensors and needs all of a
    row's keys and all of head_dim -- and any other layout raises: the
    card never takes the plain path.  Elsewhere (a CPU or meta mesh: the
    tests, the dry run) ``banded(q, k, v, *rows)``, the same function in
    plain ops on the banded chunks, goes through ``attention``."""
    q, k, v = align_heads(q, k, v)
    if not _on_card(q):
        return attention(banded, q, k, v, *rows)
    out = _on_local_shards(kernel, q, k, v)
    if out is None:
        raise ValueError(
            "local attention on the card runs the kernel on shards split "
            f"over batch and heads only; q, k, v lie as {q.placements}, "
            f"{k.placements}, {v.placements}")
    return out
