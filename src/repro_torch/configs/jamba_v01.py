"""jamba-v0.1-52b [arXiv:2403.19887; hybrid Mamba + attention 1:7, MoE].

32 layers, d_model 4096, superblocks of 8 (attention at slot 4: 32 heads,
GQA kv 8; Mamba elsewhere: d_in 8192, state 16, conv 4, dt rank 256); an
MoE MLP of 16 experts top-2 (d_ff 14336) on odd slots, a dense SwiGLU of
14336 on even slots; vocab 65536, untied head.

Checked against ``repro/configs/jamba_v01.py``."""
from .base import ModelConfig

_PAT = tuple("attn" if i == 4 else "mamba" for i in range(8))

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65_536,
    block_pattern=_PAT,
    n_experts=16, top_k=2, expert_dff=14336,
    moe_pattern=tuple(1 if i % 2 else 0 for i in range(8)),
    ssm_state=16, ssm_conv=4, ssm_expand=2,
)
