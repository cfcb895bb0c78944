"""The three-term roofline of the port's dry-run records, on the H100's
constants."""
from .analysis import (  # noqa: F401
    HBM_BW,
    IB_BW,
    LINK_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    Roofline,
    analyze,
    collective_bytes_of,
    model_flops_for,
    overlap_speedup_bound,
)
