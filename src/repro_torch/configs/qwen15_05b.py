"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B; dense MHA + QKV bias].

Checked against ``repro/configs/qwen15_05b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151_936, qkv_bias=True, tie_embeddings=True,
)
