"""Training core of the port: optimizers and schedules, the train state,
the trainers, hooks, checkpoints and the experiment manager."""

from .experiment_manager import ExperimentManager
from .train_state import TrainState, param_count
from .trainer_base import HookBase, TrainerBase
from .trainers.seg_trainer import SegTrainer

__all__ = ["ExperimentManager", "TrainState", "param_count", "HookBase", "TrainerBase", "SegTrainer"]
