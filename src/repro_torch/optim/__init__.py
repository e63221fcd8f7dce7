"""Optimizers of the port (functional updates over param trees)."""
from .optim import (Optimizer, adamw, clip_by_global_norm, cosine_schedule,
                    global_norm, linear_warmup, lion, sgd)

__all__ = ["Optimizer", "adamw", "sgd", "lion", "cosine_schedule",
           "linear_warmup", "clip_by_global_norm", "global_norm"]
