"""Architecture shapes of the port (random init, no weights)."""
from .common import reduced  # noqa: F401
from .registry import all_arch_ids, get_config  # noqa: F401
