"""Model registry (torch port of ``repro.models.registry``): arch name ->
config, model functions and input builders."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs, kernels
from repro_torch.core import codec
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    return configs.get_smoke(name) if smoke else configs.get(name)


def _vision_len(seq: int) -> int:
    """Positions the vision stub's patch embeddings take: a quarter."""
    return max(1, seq // 4)


def make_batch(cfg: ArchConfig, batch: int, seq: int, *, rng=None, device="cuda") -> dict:
    """A concrete batch on ``device``: ``tokens`` and ``labels`` (B, S)
    int64; for an encoder-decoder model the stubbed ``frames`` (B,
    enc_seq, D), for the vision stub ``vision_embeds`` (B, S // 4, D), both
    in the model dtype.  Drawn with the reference's numpy calls in its
    order, so one ``rng`` gives the reference's values (the embeddings
    rounded from float64 through float32, as JAX converts them)."""
    dev = kernels.resolve_device(device)
    rng = rng or np.random.default_rng(0)
    dt = codec.LAYOUTS[cfg.dtype].dtype
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int64)).to(dev)
         for k in ("tokens", "labels")}
    if cfg.enc_dec:
        fr = rng.normal(0, 1, (batch, cfg.enc_seq, cfg.d_model))
        b["frames"] = torch.from_numpy(fr.astype(np.float32)).to(device=dev, dtype=dt)
    if cfg.frontend == "vision_stub":
        ve = rng.normal(0, 1, (batch, _vision_len(seq), cfg.d_model))
        b["vision_embeds"] = torch.from_numpy(ve.astype(np.float32)).to(device=dev, dtype=dt)
    return b


def batch_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """``meta`` tensors standing in for every model input (no storage)."""
    dt = codec.LAYOUTS[cfg.dtype].dtype
    s = {k: torch.empty((batch, seq), dtype=torch.int64, device="meta")
         for k in ("tokens", "labels")}
    if cfg.enc_dec:
        s["frames"] = torch.empty((batch, cfg.enc_seq, cfg.d_model), dtype=dt, device="meta")
    if cfg.frontend == "vision_stub":
        s["vision_embeds"] = torch.empty((batch, _vision_len(seq), cfg.d_model), dtype=dt,
                                         device="meta")
    return s


model = transformer  # module-level alias: init / forward / prefill / decode_step
