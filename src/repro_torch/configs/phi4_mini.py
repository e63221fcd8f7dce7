"""phi4-mini-3.8b [arXiv:2412.08905; dense RoPE SwiGLU GQA, untied head].

Checked against ``repro/configs/phi4_mini.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200_064,
)
