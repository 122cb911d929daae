"""Training of the port: ``repro.training`` (AdamW, schedules, the train
step) in PyTorch."""
from .optimizer import AdamW, AdamWState, constant_schedule, cosine_schedule
from .train_step import (TrainState, TrainTree, compress_grads, compress_int8,
                         decompress_int8, fp32_reductions, init_state, load_state_tree,
                         make_train_step, state_tree)

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "constant_schedule",
           "TrainState", "TrainTree", "state_tree", "load_state_tree", "make_train_step",
           "init_state", "fp32_reductions", "compress_grads", "compress_int8", "decompress_int8"]
