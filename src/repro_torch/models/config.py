"""Architecture configuration schema (torch port of ``repro.models.config``).

A model is a prefix of unstacked layers, then a super-block ``pattern``
repeated ``repeats`` times (each pattern position's parameters stacked over
the repeats): gemma's 5:1 local:global layout is a 6-layer pattern with
its 2 remainder local layers in the prefix, jamba's 1:7 attention:Mamba
interleave an 8-layer pattern, xlstm's 7:1 mLSTM:sLSTM mix another.  An
encoder-decoder model (whisper) adds ``n_enc_layers`` attention + SwiGLU
encoder layers over stubbed frame embeddings and a cross-attention in
every decoder layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int = 0  # routed experts
    top_k: int = 0
    n_shared: int = 0  # always-on shared experts
    d_expert: int = 0  # expert FFN hidden size


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512  # latent dim for compressed KV
    q_lora: int = 0  # 0 = full-rank queries (counted, never built: see param_count)
    rope_dim: int = 64  # decoupled RoPE sub-dim per head


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position inside the repeating super-block (or the prefix)."""

    mixer: str = "attn"  # attn | mla | mamba | mlstm | slstm
    ffn: str = "swiglu"  # swiglu | moe | none
    window: Optional[int] = None  # sliding-window size; None = global attn


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    # layer layout: prefix (unstacked) + pattern x repeats (stacked)
    pattern: Sequence[LayerSpec] = (LayerSpec(),)
    repeats: int = 1
    prefix: Sequence[LayerSpec] = ()
    head_dim: Optional[int] = None  # default d_model // n_heads
    moe: MoECfg = MoECfg()
    mla: MLACfg = MLACfg()
    mamba: MambaCfg = MambaCfg()
    # encoder-decoder (whisper): n_enc_layers attention + SwiGLU encoder
    # layers over stubbed frame embeddings (B, enc_seq, D) from the batch
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500  # stub frontend sequence length
    frontend: str = "none"  # none | audio_stub | vision_stub (embeddings enter the batch)
    rope_theta: float = 10000.0
    mrope: bool = False  # qwen2-vl M-RoPE: text-only positions make it plain RoPE
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    sub_quadratic: bool = False  # eligible for long-context serving cells
    notes: str = ""

    @property
    def n_layers(self) -> int:
        return len(self.prefix) + len(self.pattern) * self.repeats

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Exact parameter count (the element count of ``transformer.init``):
        embeddings (one table when tied), the final norm, and per layer its
        mixer, FFN, ``norm1``, ``norm2`` where it has an FFN and ``normx``
        in an encoder-decoder model; then the encoder's layers, its norm and
        positions, and a cross-attention in every decoder layer."""
        d = self.d_model
        total = self.vocab * d * (1 if self.tie_embeddings else 2) + d
        for s in list(self.prefix) + list(self.pattern) * self.repeats:
            total += self._mixer_params(s.mixer) + self._ffn_params(s.ffn) + d
            if s.ffn != "none":
                total += d  # norm2
            if self.enc_dec:
                total += d  # normx
        if self.enc_dec:
            total += self.n_enc_layers * (self._mixer_params("attn")
                                          + self._ffn_params("swiglu") + 2 * d)
            total += d + self.enc_seq * d  # enc_norm, enc_pos
            total += self.n_layers * self._mixer_params("attn")  # cross-attention
        return total

    def _mixer_params(self, mixer: str) -> int:
        d, hd = self.d_model, self.hd
        if mixer == "attn":
            return 2 * d * self.n_heads * hd + 2 * d * self.kv_heads * hd
        if mixer == "mla":
            # the reference's count: a q_lora path counts two factors, but
            # its init (and this port's) always builds the full-rank wq
            m, qd = self.mla, self.n_heads * (hd + self.mla.rope_dim)
            q = d * qd if not m.q_lora else d * m.q_lora + m.q_lora * qd
            return (q + d * (m.kv_lora + m.rope_dim) + m.kv_lora * self.n_heads * 2 * hd
                    + self.n_heads * hd * d)
        if mixer == "mamba":  # in_proj, conv, B/C/dt, A, out_proj, d_skip + dt_bias
            mc = self.mamba
            di = mc.expand * d
            return (d * 2 * di + di * mc.d_conv + di * (2 * mc.d_state + 1)
                    + di * mc.d_state + di * d + 2 * di)
        if mixer in ("mlstm", "slstm"):  # q, k, v, the i/f gates, o
            return (2 * d * self.n_heads * hd + 2 * d * self.kv_heads * hd
                    + 2 * d * self.n_heads)
        raise ValueError(mixer)

    def _ffn_params(self, ffn: str) -> int:
        if ffn == "swiglu":
            return 3 * self.d_model * self.d_ff
        if ffn == "moe":  # routed and shared experts, the router
            m = self.moe
            return (m.n_experts + m.n_shared) * 3 * self.d_model * m.d_expert + \
                self.d_model * m.n_experts
        if ffn == "none":
            return 0
        raise ValueError(ffn)

    def active_param_count(self) -> int:
        """Parameters a token uses: an MoE layer's top-k routed experts and
        its shared ones, not the rest."""
        m = self.moe
        specs = list(self.prefix) + list(self.pattern) * self.repeats
        n_moe = sum(s.ffn == "moe" for s in specs)
        return self.param_count() - n_moe * (m.n_experts - m.top_k) * 3 * self.d_model * \
            m.d_expert
