"""mistral-nemo-12b [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407; hf].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.  head_dim=128.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    d_model=5120,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
    repeats=40,
    rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="mistral-nemo-smoke",
    d_model=80,
    n_heads=4,
    kv_heads=2,
    d_ff=224,
    vocab=256,
    head_dim=20,
    pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
    repeats=2,
    rope_theta=1_000_000.0,
)
