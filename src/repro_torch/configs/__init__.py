"""Config registry of the port (the architectures ported so far)."""
from .base import ModelConfig, scale_down
from . import gemma3_12b, phi4_mini, qwen15_05b, qwen2_05b

ARCHS = {
    "gemma3-12b": gemma3_12b.CONFIG,
    "qwen1.5-0.5b": qwen15_05b.CONFIG,
    "qwen2-0.5b": qwen2_05b.CONFIG,
    "phi4-mini-3.8b": phi4_mini.CONFIG,
}

__all__ = ["ModelConfig", "scale_down", "ARCHS"]
