"""Model configuration and the benchmark input shapes.

Checked against ``repro/configs/base.py``: same field names and defaults
for every field the ported paths read (sliding-window local/global
layouts, the GELU MLP, MLA attention, MoE MLPs with shared experts and
leading dense layers, the vision frontend's prefix, the Mamba and xLSTM
blocks' state, conv and expansion, the encoder-decoder family's encoder
depth, LayerNorm and audio stub), and the same ``scale_down`` rules for
them, so a config built by either package describes the same model
(``tests/test_torch_model.py``, ``test_torch_family.py``,
``test_torch_moe.py`` and ``test_torch_encdec.py`` compare the two field
by field).  ``ShapeConfig``, ``SHAPES`` and ``SMOKE_SHAPE`` are copies of
the reference's, for ``train.pick_microbatches``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "SMOKE_SHAPE",
           "scale_down"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    attn_type: str = "gqa"          # gqa | mla
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    swa_window: int = 0             # 0 = full attention (all layers)
    # per-superblock layer layout; empty -> n_layers x one "attn" slot
    # attn | attn_local | attn_global | mamba | mlstm | slstm
    block_pattern: Tuple[str, ...] = ()
    # --- MLA (deepseek) ---
    kv_lora: int = 0
    q_lora: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_dff: int = 0
    moe_pattern: Tuple[int, ...] = ()     # per slot: 1 = MoE MLP, 0 = dense
    first_dense_layers: int = 0           # leading dense blocks (deepseek)
    capacity_factor: float = 1.25
    # --- SSM (mamba / xlstm) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0                 # 0 -> decoder-only
    frontend: str = ""                    # "" | audio_stub | vision_stub
    n_frontend_tokens: int = 0            # patch embeddings prepended
    act: str = "swiglu"             # swiglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"         # activation/compute dtype

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern or ("attn",)

    @property
    def n_super(self) -> int:
        """Superblocks after the ``first_dense_layers``: block layer ``s *
        len(pattern) + j`` is slot ``j`` of superblock ``s``.
        ``n_layers`` counts decoder layers only for an enc-dec model (its
        encoder depth is ``n_enc_layers``)."""
        body = self.n_layers - self.first_dense_layers
        assert body % len(self.pattern) == 0, \
            (self.name, self.n_layers, self.pattern)
        return body // len(self.pattern)

    def moe_for_slot(self, slot: int) -> bool:
        if not self.n_experts:
            return False
        if not self.moe_pattern:
            return True
        return bool(self.moe_pattern[slot])


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """A benchmark input shape (the reference's): what
    ``train.pick_microbatches`` sizes microbatches for."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

SMOKE_SHAPE = ShapeConfig("smoke", 32, 2, "train")


def scale_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU tests (the reference's rules for
    the fields above: the leading dense layers and one superblock, 64
    wide, 4 heads of 16, vocab 256, a window of at most 8, at most 4
    experts of 64 with top-2, an MLA cache of 32 with rope/nope/v heads of
    8/16/16, an SSM state of at most 8, 8 frontend tokens, at most 2
    encoder layers; an enc-dec model's decoder depth counts its encoder
    layers too, as the reference's does)."""
    mla = cfg.attn_type == "mla"
    small = dict(
        n_layers=cfg.first_dense_layers + len(cfg.pattern)
        + cfg.n_enc_layers, d_model=64,
        n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=16,
        d_ff=128 if cfg.d_ff else 0, vocab=256,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        expert_dff=64 if cfg.expert_dff else 0,
        kv_lora=32 if cfg.kv_lora else 0, q_lora=0,
        rope_head_dim=8 if mla else cfg.rope_head_dim,
        nope_head_dim=16 if mla else cfg.nope_head_dim,
        v_head_dim=16 if mla else cfg.v_head_dim,
        swa_window=min(cfg.swa_window, 8) if cfg.swa_window else 0,
        ssm_state=min(cfg.ssm_state, 8),
        n_frontend_tokens=8 if cfg.frontend else 0,
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
