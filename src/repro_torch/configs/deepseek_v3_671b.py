"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].

61L d_model=7168 128H (GQA kv=128) d_ff=2048 vocab=129280, MoE 256e top-8.
First 3 layers dense (DeepSeek-V3 convention), remaining 58 MoE (58 = 2x29).
677.7 B parameters (one MoE layer alone 11.3 B) need several cards: the
port holds it at SMOKE size and counts the full one through ``meta``
tensors.
"""
from repro_torch.models.config import ArchConfig, LayerSpec, MLACfg, MoECfg

_DENSE = LayerSpec(mixer="mla", ffn="swiglu")
_MOE = LayerSpec(mixer="mla", ffn="moe")

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    d_model=7168,
    n_heads=128,
    kv_heads=128,
    d_ff=2048,  # assigned d_ff (expert hidden; dense prefix uses the same)
    vocab=129280,
    head_dim=128,
    prefix=(_DENSE, _DENSE, _DENSE),
    pattern=(_MOE, _MOE),
    repeats=29,
    moe=MoECfg(n_experts=256, top_k=8, n_shared=1, d_expert=2048),
    mla=MLACfg(kv_lora=512, rope_dim=64),
    notes="MTP head available via train cfg (mtp=True); adafactor states",
)

SMOKE = ArchConfig(
    name="deepseek-v3-smoke",
    d_model=64,
    n_heads=4,
    kv_heads=4,
    d_ff=192,
    vocab=256,
    head_dim=16,
    prefix=(_DENSE,),
    pattern=(_MOE, _MOE),
    repeats=1,
    moe=MoECfg(n_experts=8, top_k=2, n_shared=1, d_expert=32),
    mla=MLACfg(kv_lora=32, rope_dim=8),
)
