"""Model configuration: the dense decoder-only subset of the reference's.

Checked against ``repro/configs/base.py``: same field names and defaults
for every field the dense GQA path reads (sliding-window local/global
layouts and the GELU MLP included), and the same ``scale_down`` rules for
them, so a config built by either package describes the same model
(``tests/test_torch_model.py`` and ``test_torch_family.py`` compare the two
field by field).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ModelConfig", "scale_down"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    swa_window: int = 0             # 0 = full attention (all layers)
    # per-superblock layer layout; empty -> n_layers x one "attn" slot
    block_pattern: Tuple[str, ...] = ()   # attn | attn_local | attn_global
    act: str = "swiglu"             # swiglu | gelu
    norm: str = "rmsnorm"
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
        """Superblocks: layer ``s * len(pattern) + j`` is slot ``j`` of
        superblock ``s``."""
        assert self.n_layers % len(self.pattern) == 0, \
            (self.name, self.n_layers, self.pattern)
        return self.n_layers // len(self.pattern)


def scale_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU tests (the reference's rules for
    the fields above: one superblock, 64 wide, 4 heads of 16, vocab 256,
    a window of at most 8)."""
    small = dict(
        n_layers=len(cfg.pattern), d_model=64, n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=16,
        d_ff=128 if cfg.d_ff else 0, vocab=256,
        swa_window=min(cfg.swa_window, 8) if cfg.swa_window else 0,
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
