"""Training of the SchemaNet predictor: the schedule, the optimizer groups and
the step."""

from .common import epoch_schedule, make_optimizer
from .trainer import SCHEMA_NET_FROZEN, Trainer, TrainerConfig
