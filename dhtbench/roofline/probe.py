"""The read probe (``kernels/csrc/probe.cu``, launched through
``kernels.ops.probe``): bytes and operations one call needs.

What the answer needs: each query's key and base, the meta word of every
distinct candidate up to the selected one (all of the window where none
is), the key words of the distinct live ones among them, the value and
checksum of the distinct selected ones, and the outputs.  Operations:
the checksum chain (~11 a word) of each selected query.  Counted from
the call's inputs and answer, so any implementation is held to the same
work."""
import torch

OP = "probe"
KERNEL = r"\bprobe_kernel\b"


def work(args, result) -> tuple[int, int]:
    skeys, svals, smeta, scsum, q, base, n_probe = args[:7]
    validate = args[7] if len(args) > 7 else True
    _vals, found, rsel = result
    c, kw = q.shape
    vw = svals.shape[1]
    off = torch.arange(n_probe, device=base.device, dtype=torch.int64)
    last = torch.where(found != 0, rsel.long(), n_probe - 1)
    idx = (base.long()[:, None] + off).clamp(0, smeta.shape[0] - 1)
    cand = torch.unique(idx[off[None, :] <= last[:, None]])
    m = smeta[cand]
    live = int((((m & 1) != 0) & ((m & 2) == 0)).sum())
    sel = torch.unique((base.long() + rsel.long())[found != 0])
    nbytes = 4 * (c * (kw + 1) + cand.numel() + live * kw
                  + sel.numel() * (vw + 1) + c * (vw + 2))
    ops = int((found != 0).sum()) * (kw + vw) * 11 if validate else 0
    return nbytes, ops
