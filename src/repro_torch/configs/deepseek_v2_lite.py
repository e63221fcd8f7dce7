"""deepseek-v2-lite-16b [arXiv:2405.04434; MoE + MLA].

27 layers, d_model 2048, MLA with a compressed KV cache of 512 (16 heads;
rope 64 / nope 128 / v 128 per head), the first layer dense (d_ff 10944),
26 MoE layers of 64 routed experts top-6 plus 2 shared, expert d_ff 1408,
vocab 102400, untied head.

Checked against ``repro/configs/deepseek_v2_lite.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102_400,
    attn_type="mla", kv_lora=512, q_lora=0,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, expert_dff=1408,
    first_dense_layers=1,
)
