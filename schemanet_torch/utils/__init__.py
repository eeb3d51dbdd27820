"""Host-side utilities: config loading and overrides, seeding, the name
registry, metric meters, the step timer, profiler traces, logging and the
TensorBoard writer."""

from .config import apply_overrides, get_cfg, parse_override_strings, resolve_subconfig
from .profiling import StepTimer, block_tree, trace
from .seed import make_deterministic

__all__ = [
    "StepTimer",
    "apply_overrides",
    "block_tree",
    "get_cfg",
    "make_deterministic",
    "parse_override_strings",
    "resolve_subconfig",
    "trace",
]
