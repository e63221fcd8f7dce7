"""whisper-medium [arXiv:2212.04356; audio enc-dec, conv frontend stub].

24 encoder + 24 decoder layers, d_model 1024, 16 heads MHA, d_ff 4096,
vocab 51865, biased q/k/v, GELU MLPs, LayerNorm, sinusoidal positions;
the audio frontend is a stub: precomputed frame embeddings [B, S_src, D]
go straight into the encoder.

Checked against ``repro/configs/whisper_medium.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51_865, qkv_bias=True,
    norm="layernorm", act="gelu", frontend="audio_stub",
)
