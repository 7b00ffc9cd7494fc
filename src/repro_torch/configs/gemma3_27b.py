"""gemma3-27b [dense] — 5:1 local:global attention, 128k ctx
[hf:google/gemma-3-1b-pt; unverified].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
Pattern: 5 sliding-window (1024) layers then 1 global layer; 62 = 10x6 + 2
remainder local layers carried in the prefix.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_LOCAL = LayerSpec(mixer="attn", ffn="swiglu", window=1024)
_GLOBAL = LayerSpec(mixer="attn", ffn="swiglu", window=None)

CONFIG = ArchConfig(
    name="gemma3-27b",
    d_model=5376,
    n_heads=32,
    kv_heads=16,
    d_ff=21504,
    vocab=262144,
    head_dim=128,
    prefix=(_LOCAL, _LOCAL),
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    repeats=10,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    notes="global layers are full attention -> long_500k skipped",
)

SMOKE = ArchConfig(
    name="gemma3-smoke",
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=128,
    vocab=256,
    prefix=(LayerSpec(mixer="attn", ffn="swiglu", window=8),),
    pattern=(
        LayerSpec(mixer="attn", ffn="swiglu", window=8),
        LayerSpec(mixer="attn", ffn="swiglu", window=None),
    ),
    repeats=1,
    tie_embeddings=True,
)
