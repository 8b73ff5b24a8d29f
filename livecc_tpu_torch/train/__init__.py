"""Single-GPU training: the step (``step.py``), collation and packing
(``data.py``) and the loop with checkpoints (``trainer.py``)."""

from livecc_tpu_torch.train.step import (Batch, TrainConfig, loss_fn, lr_schedule, make_optimizer,
                                         make_train_step, split_frozen)

__all__ = ["Batch", "TrainConfig", "loss_fn", "lr_schedule", "make_optimizer", "make_train_step",
           "split_frozen"]
