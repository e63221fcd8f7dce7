"""gemma3-12b [hf:google/gemma-3-1b-pt family; dense, 5:1 local:global].

48 layers, d_model 3840, 16 heads of 240 (GQA kv 8), d_ff 15360, vocab
262144, untied head; sliding-window local layers (W = 1024) with one
global layer per 6, GELU MLPs, rope theta 1e6.

Checked against ``repro/configs/gemma3_12b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=240,
    d_ff=15360, vocab=262_144,
    block_pattern=("attn_local",) * 5 + ("attn_global",),
    swa_window=1024, rope_theta=1_000_000.0, act="gelu",
)
