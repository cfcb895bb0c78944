"""Architecture shapes of the port (random init, no weights)."""
from .common import reduced  # noqa: F401
from .registry import get_config  # noqa: F401
