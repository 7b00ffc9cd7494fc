"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385; hf].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    d_model=2048,
    n_heads=32,
    kv_heads=4,
    d_ff=5632,
    vocab=32000,
    pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
    repeats=22,
    rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="tinyllama-smoke",
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=176,
    vocab=256,
    pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
    repeats=2,
)
