"""Training substrate: optimizer, sharding rules, train step (single-device
and over a mesh), fault-tolerant loop (port of `repro.training`)."""
from repro_torch.training.loop import TrainLoopConfig, train_loop
from repro_torch.training.optimizer import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    adamw_update_,
    global_norm,
    lr_schedule,
)
from repro_torch.training.sharding_rules import batch_pspecs, maybe_shard, param_pspecs
from repro_torch.training.train_step import (
    TrainState,
    init_train_state,
    make_train_step,
    value_and_grad,
)

__all__ = [
    "AdamWConfig",
    "OptState",
    "adamw_init",
    "adamw_update",
    "adamw_update_",
    "global_norm",
    "lr_schedule",
    "param_pspecs",
    "batch_pspecs",
    "maybe_shard",
    "TrainState",
    "make_train_step",
    "init_train_state",
    "value_and_grad",
    "TrainLoopConfig",
    "train_loop",
]
