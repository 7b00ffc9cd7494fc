"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
The vision frontend is a stub: the batch carries precomputed patch
embeddings ``vision_embeds`` (B, S_v, D) that replace the leading token
positions (``models.registry.make_batch``).  M-RoPE degenerates to standard
RoPE for the stubbed text-grid positions.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=29568,
    vocab=152064,
    pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
    repeats=80,
    rope_theta=1_000_000.0,
    mrope=True,
    frontend="vision_stub",
)

SMOKE = ArchConfig(
    name="qwen2-vl-smoke",
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=160,
    vocab=256,
    pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
    repeats=2,
    mrope=True,
    frontend="vision_stub",
)
