"""Training: the schedule, the optimizer groups, gradient clipping, the step
(stage 0's backbone or stage 4's SchemaNet predictor) and the worker setups."""

from .common import clip_by_global_norm, epoch_schedule, make_optimizer
from .trainer import SCHEMA_NET_FROZEN, Trainer, TrainerConfig
from .workers import backbone_trainer, schema_net_trainer
