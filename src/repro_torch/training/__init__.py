from repro_torch.training.optimizer import AdamW, AdamWState, warmup_cosine
from repro_torch.training.loop import (eval_exit_metrics, make_loss_fn,
                                       make_train_step)
from repro_torch.training.data import FEATURE_DIM, DifficultyDataset
from repro_torch.training import checkpoint

__all__ = ["AdamW", "AdamWState", "warmup_cosine", "make_loss_fn",
           "make_train_step", "eval_exit_metrics", "FEATURE_DIM",
           "DifficultyDataset", "checkpoint"]
