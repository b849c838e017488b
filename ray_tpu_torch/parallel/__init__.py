"""Training on one device: train state, optimizer, train and eval steps
(counterpart of ``ray_tpu/parallel``; meshes and shardings come with the
collectives slice)."""

from .train_step import (
    AdamWState,
    Optimizer,
    TrainState,
    create_train_state,
    default_optimizer,
    global_norm,
    make_eval_step,
    make_train_step,
    tree_leaves,
    tree_map,
)

__all__ = [
    "AdamWState",
    "Optimizer",
    "TrainState",
    "create_train_state",
    "default_optimizer",
    "global_norm",
    "make_eval_step",
    "make_train_step",
    "tree_leaves",
    "tree_map",
]
