"""Training: the schedule, the optimizer groups, gradient clipping,
checkpoints, the step and its epoch loop (stage 0's backbone or stage 4's
SchemaNet predictor), the evaluation loops and the workers."""

from .common import (CheckpointManager, clip_by_global_norm, epoch_schedule, load_metadata,
                     make_optimizer, merge_restored, save_metadata)
from .evaluator import CBEvaluation, Evaluation, IncEvaluation
from .trainer import SCHEMA_NET_FROZEN, Trainer, TrainerConfig
from .workers import (WORKER_REGISTRY, LaunchArgs, backbone_trainer, backbone_worker,
                      eval_worker, schema_net_trainer, schema_net_worker)
