"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Super-block of 8 (Jamba paper layout): attention at position 4, Mamba
elsewhere; MoE replaces the MLP every other layer (odd positions).
Mamba layers are O(S) -> eligible for long_500k (the 4 attention layers
use context-parallel KV over the data axis at 500k).
"""
from repro_torch.models.config import ArchConfig, LayerSpec, MambaCfg, MoECfg

_M = lambda ffn: LayerSpec(mixer="mamba", ffn=ffn)
_A = lambda ffn: LayerSpec(mixer="attn", ffn=ffn)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=65536,
    head_dim=128,
    pattern=(
        _M("swiglu"), _M("moe"), _M("swiglu"), _M("moe"),
        _A("swiglu"), _M("moe"), _M("swiglu"), _M("moe"),
    ),
    repeats=4,
    moe=MoECfg(n_experts=16, top_k=2, n_shared=0, d_expert=14336),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="jamba-smoke",
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=128,
    vocab=256,
    pattern=(
        LayerSpec(mixer="mamba", ffn="swiglu"),
        LayerSpec(mixer="mamba", ffn="moe"),
        LayerSpec(mixer="attn", ffn="swiglu"),
        LayerSpec(mixer="mamba", ffn="moe"),
    ),
    repeats=1,
    moe=MoECfg(n_experts=4, top_k=2, n_shared=0, d_expert=64),
    mamba=MambaCfg(d_state=8, d_conv=4, expand=2),
    sub_quadratic=True,
)
