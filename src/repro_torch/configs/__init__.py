"""Config registry of the port: every architecture of the reference's."""
from .base import SHAPES, SMOKE_SHAPE, ModelConfig, ShapeConfig, scale_down
from . import (deepseek_v2_lite, gemma3_12b, jamba_v01, llava_next_34b,
               mixtral_8x7b, phi4_mini, qwen15_05b, qwen2_05b, whisper_medium,
               xlstm_13b)

ARCHS = {
    "gemma3-12b": gemma3_12b.CONFIG,
    "qwen1.5-0.5b": qwen15_05b.CONFIG,
    "qwen2-0.5b": qwen2_05b.CONFIG,
    "phi4-mini-3.8b": phi4_mini.CONFIG,
    "whisper-medium": whisper_medium.CONFIG,
    "llava-next-34b": llava_next_34b.CONFIG,
    "deepseek-v2-lite-16b": deepseek_v2_lite.CONFIG,
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "jamba-v0.1-52b": jamba_v01.CONFIG,
    "xlstm-1.3b": xlstm_13b.CONFIG,
}


def get_smoke(name: str) -> ModelConfig:
    """The reference's smoke config of ``name`` (``scale_down`` defaults)."""
    return scale_down(ARCHS[name])


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "SMOKE_SHAPE",
           "scale_down", "get_smoke", "ARCHS"]
