"""Optimizer schedules: reduce-LR-on-plateau over optax."""

from admm_deconv.optim.plateau import ReduceLROnPlateau

__all__ = ["ReduceLROnPlateau"]
