"""mixtral-8x7b [arXiv:2401.04088; MoE 8 experts top-2, sliding window].

32 layers, d_model 4096, 32 heads (GQA kv 8), 8 experts top-2 of d_ff
14336 in every layer, sliding-window attention (W = 4096) on every layer,
vocab 32000, untied head.

Checked against ``repro/configs/mixtral_8x7b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32_000,
    block_pattern=("attn_local",), swa_window=4096,
    n_experts=8, top_k=2, expert_dff=14336,
)
