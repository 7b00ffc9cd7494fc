"""Architecture configuration schema (torch port of ``repro.models.config``;
the dense fields only: MoE, MLA, Mamba, xLSTM and encoder fields wait)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position inside the repeating super-block."""

    mixer: str = "attn"  # attn (the only mixer ported so far)
    ffn: str = "swiglu"  # swiglu
    window: Optional[int] = None  # sliding-window size; None = global attn


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    # layer layout: pattern x repeats (parameters stacked over repeats)
    pattern: Sequence[LayerSpec] = (LayerSpec(),)
    repeats: int = 1
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        total = self.vocab * d * (1 if self.tie_embeddings else 2) + d
        attn = d * self.n_heads * hd * 2 + 2 * d * self.kv_heads * hd
        return total + self.n_layers * (attn + 3 * d * self.d_ff + 2 * d)
