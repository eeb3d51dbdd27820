"""Host-side utilities: config loading and overrides, seeding, the name
registry, metric meters, the step timer, logging and the TensorBoard
writer."""

from .config import apply_overrides, get_cfg, parse_override_strings, resolve_subconfig
from .seed import make_deterministic

__all__ = [
    "apply_overrides",
    "get_cfg",
    "make_deterministic",
    "parse_override_strings",
    "resolve_subconfig",
]
