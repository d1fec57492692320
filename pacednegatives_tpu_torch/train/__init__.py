"""Training: state and optimizer, the pair / LCE train step and the
meta-weight step, the loop with checkpoints, and the runner (the port of
train/)."""

from pacednegatives_tpu_torch.train.loop import (
    MetricWriter,
    TrainLoop,
    latest_checkpoint,
    pair_index_stream,
    restore_checkpoint,
    save_checkpoint,
)
from pacednegatives_tpu_torch.train.state import (
    TrainState,
    init_train_state,
    make_optimizer,
)
from pacednegatives_tpu_torch.train.step import (
    make_fused_step,
    make_meta_train_step,
    make_train_step,
)

__all__ = [
    "MetricWriter",
    "TrainLoop",
    "TrainState",
    "init_train_state",
    "latest_checkpoint",
    "make_fused_step",
    "make_meta_train_step",
    "make_optimizer",
    "make_train_step",
    "pair_index_stream",
    "restore_checkpoint",
    "save_checkpoint",
]
