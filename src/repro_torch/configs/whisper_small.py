"""whisper-small [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356;
unverified].

12L (decoder) d_model=768 12H (kv=12) d_ff=3072 vocab=51865; 12 encoder
layers.  The conv frontend is a STUB: ``registry.make_batch``
provides precomputed frame embeddings (B, 1500, D) directly to the encoder.
Decoder layers carry cross-attention to the encoder output.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper-small",
    d_model=768,
    n_heads=12,
    kv_heads=12,
    d_ff=3072,
    vocab=51865,
    pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
    repeats=12,
    enc_dec=True,
    n_enc_layers=12,
    enc_seq=1500,
    frontend="audio_stub",
    notes="decode/prefill shapes exercise the decoder backbone as assigned",
)

SMOKE = ArchConfig(
    name="whisper-smoke",
    d_model=64,
    n_heads=4,
    kv_heads=4,
    d_ff=128,
    vocab=256,
    pattern=(LayerSpec(mixer="attn", ffn="swiglu"),),
    repeats=2,
    enc_dec=True,
    n_enc_layers=2,
    enc_seq=30,
    frontend="audio_stub",
)
