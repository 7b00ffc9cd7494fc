"""glm4-9b [dense] — the paper's own RL-training workload (Table 1,
Fig. 10a/12: weight tensors collected during GLM4-9B training) [hf:THUDM].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
Its weight tensors (gate_up_proj, 214 MB class) are those of the paper's
weight-update experiment.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="glm4-9b",
    d_model=4096,
    n_heads=32,
    kv_heads=2,
    d_ff=13696,
    vocab=151552,
    pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
    repeats=40,
)

SMOKE = ArchConfig(
    name="glm4-smoke",
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=160,
    vocab=256,
    pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
    repeats=2,
)
