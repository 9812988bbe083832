"""Training harness: config, train state, loop, checkpointing, logging."""

from admm_deconv.train.config import TrainConfig, load_config, parse_args
from admm_deconv.train.trainer import Trainer, TrainState

__all__ = ["TrainConfig", "load_config", "parse_args", "Trainer", "TrainState"]
