"""Training: optimizer and freezing, the train state with its EMA, the
pretrain and episodic train steps, and checkpoints."""

from .checkpoint import (CheckpointManager, filter_params_by_module,
                         load_params_any, merge_state_dict)
from .optimizer import (SGD, build_freeze_mask, build_lr_schedule,
                        build_optimizer, flax_param_path)
from .steps import make_episodic_train_step, make_pretrain_train_step
from .train_state import TrainState

__all__ = ["CheckpointManager", "filter_params_by_module", "load_params_any",
           "merge_state_dict", "SGD", "build_freeze_mask",
           "build_lr_schedule", "build_optimizer", "flax_param_path",
           "make_episodic_train_step", "make_pretrain_train_step",
           "TrainState"]
