"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): HBM3 bandwidth and the non-tensor
32-bit rate, which bounds the integer and float32 ALU work of the DHT's
kernels.  A share of these is stated beside the card's power limit."""

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take for that work."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S)
