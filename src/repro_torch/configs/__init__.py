"""Config registry of the port (the architectures ported so far)."""
from .base import ModelConfig, scale_down
from . import qwen15_05b

ARCHS = {"qwen1.5-0.5b": qwen15_05b.CONFIG}

__all__ = ["ModelConfig", "scale_down", "ARCHS"]
