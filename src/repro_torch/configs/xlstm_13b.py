"""xlstm-1.3b [arXiv:2405.04517; sLSTM + mLSTM blocks 1:7].

48 blocks, d_model 2048, 4 heads; superblocks of 7 mLSTM blocks (matrix
memory, projection factor 2: d_in 4096 in heads of 1024) and 1 sLSTM
block (scalar memory, heads of 512, a gated FFN of 2730); d_ff 0 (no MLP
half: the expansion lives inside the blocks), vocab 50304, untied head.

Checked against ``repro/configs/xlstm_13b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50_304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    ssm_expand=2,
)
