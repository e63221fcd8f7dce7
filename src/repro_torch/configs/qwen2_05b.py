"""qwen2-0.5b [arXiv:2407.10671; dense GQA kv=2 + QKV bias].

Checked against ``repro/configs/qwen2_05b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151_936, qkv_bias=True, tie_embeddings=True,
)
