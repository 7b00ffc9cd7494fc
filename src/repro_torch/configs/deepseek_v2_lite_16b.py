"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, shared+routed MoE
[arXiv:2405.04434; hf].

27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6,
2 shared experts, expert hidden 1408.  First layer dense (DeepSeek-V2
convention), remaining 26 MoE.
"""
from repro_torch.models.config import ArchConfig, LayerSpec, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    d_ff=1408,  # assigned d_ff (expert hidden; dense prefix uses the same)
    vocab=102400,
    head_dim=128,
    prefix=(LayerSpec(mixer="mla", ffn="swiglu"),),
    pattern=(LayerSpec(mixer="mla", ffn="moe"),),
    repeats=26,
    moe=MoECfg(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    mla=MLACfg(kv_lora=512, rope_dim=64),
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-smoke",
    d_model=64,
    n_heads=4,
    kv_heads=4,
    d_ff=128,
    vocab=256,
    head_dim=16,
    prefix=(LayerSpec(mixer="mla", ffn="swiglu"),),
    pattern=(LayerSpec(mixer="mla", ffn="moe"),),
    repeats=2,
    moe=MoECfg(n_experts=8, top_k=2, n_shared=1, d_expert=32),
    mla=MLACfg(kv_lora=32, rope_dim=8),
)
