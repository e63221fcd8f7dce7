"""Training of the port: the microbatched train step, checkpoints and
fault tolerance."""
from .loop import make_train_step, pick_microbatches, train_loop

__all__ = ["make_train_step", "pick_microbatches", "train_loop"]
