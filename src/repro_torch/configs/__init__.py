"""Architecture shapes of the port (random init, no weights) and the
assigned input shapes of the dry run."""
from .common import (  # noqa: F401
    LONG_CONTEXT_ARCHS,
    SHAPES,
    ShapeSpec,
    applicable,
    input_specs,
    reduced,
)
from .registry import all_arch_ids, get_config  # noqa: F401
