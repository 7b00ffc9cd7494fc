"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.  xLSTM[7:1]-style mix:
7 mLSTM blocks then 1 sLSTM block per super-block (24 = 3x8).  No FFN
(d_ff=0): the (m/s)LSTM blocks carry the full per-layer compute.
Recurrent state is O(1) in sequence length -> eligible for long_500k.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_M = LayerSpec(mixer="mlstm", ffn="none")
_S = LayerSpec(mixer="slstm", ffn="none")

CONFIG = ArchConfig(
    name="xlstm-350m",
    d_model=1024,
    n_heads=4,
    kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=(_M, _M, _M, _M, _M, _M, _M, _S),
    repeats=3,
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="xlstm-smoke",
    d_model=64,
    n_heads=2,
    kv_heads=2,
    d_ff=0,
    vocab=256,
    pattern=(LayerSpec(mixer="mlstm", ffn="none"), LayerSpec(mixer="slstm", ffn="none")),
    repeats=1,
    sub_quadratic=True,
)
