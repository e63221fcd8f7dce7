"""llava-next-34b [hf:llava-hf family; VLM with a vision stub].

60 layers, d_model 7168, 56 heads of 128 (GQA kv 8), d_ff 20480, vocab
64000, untied head; the vision tower is a stub: 576 precomputed patch
embeddings go through ``patch_proj`` [7168, 7168] and are prepended to
the text tokens.

Checked against ``repro/configs/llava_next_34b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64_000,
    frontend="vision_stub", n_frontend_tokens=576,
)
