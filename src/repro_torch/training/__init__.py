"""Training substrate of the port: AdamW, LM loss/train step, data
pipeline, checkpoints (the JAX package's ``repro.training``, in PyTorch)."""

from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.training.data import DataConfig, SyntheticLM, data_iterator
from repro_torch.training.optimizer import (
    AdamState,
    AdamWConfig,
    adamw_update,
    init_adamw,
    lr_schedule,
)
from repro_torch.training.train import chunked_lm_loss, lm_loss, make_eval_step, make_train_step

__all__ = [
    "restore_checkpoint",
    "save_checkpoint",
    "DataConfig",
    "SyntheticLM",
    "data_iterator",
    "AdamState",
    "AdamWConfig",
    "adamw_update",
    "init_adamw",
    "lr_schedule",
    "chunked_lm_loss",
    "lm_loss",
    "make_eval_step",
    "make_train_step",
]
