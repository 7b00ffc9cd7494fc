"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, tied embeddings.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="smollm-135m",
    d_model=576,
    n_heads=9,
    kv_heads=3,
    d_ff=1536,
    vocab=49152,
    pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
    repeats=30,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="smollm-smoke",
    d_model=48,
    n_heads=3,
    kv_heads=3,
    d_ff=128,
    vocab=256,
    pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
    repeats=2,
    tie_embeddings=True,
)
