"""The write pass's slot decision (``kernels/csrc/apply.cu``, launched
through ``kernels.ops.shard_apply``): bytes and operations one call
needs.

What the decision needs: each query's key and base, the meta word of
every distinct candidate bucket, the key words of the distinct occupied
ones, the value and checksum of the distinct selected ones, and the
outputs.  Operations: the checksum chain (~11 a word) of each selected
query.  Counted from the call's inputs and answer."""
import torch

OP = "shard_apply"
KERNEL = r"\bshard_apply_kernel\b"


def work(args, result) -> tuple[int, int]:
    skeys, svals, smeta, scsum, q, base, n_probe = args[:7]
    _vals, found, rsel, _wsel, _wkind = result
    c, kw = q.shape
    vw = svals.shape[1]
    off = torch.arange(n_probe, device=base.device, dtype=torch.int64)
    idx = (base.long()[:, None] + off).clamp(0, smeta.shape[0] - 1)
    cand = torch.unique(idx.reshape(-1))
    occ = int(((smeta[cand] & 1) != 0).sum())
    sel = torch.unique((base.long() + rsel.long())[found != 0])
    nbytes = 4 * (c * (kw + 1) + cand.numel() + occ * kw
                  + sel.numel() * (vw + 1) + c * (vw + 4))
    ops = int((found != 0).sum()) * (kw + vw) * 11
    return nbytes, ops
