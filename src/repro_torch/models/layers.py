"""Dense building blocks (torch port of ``repro.models.layers``): RMSNorm,
RoPE, GQA causal attention as plain PyTorch math, SwiGLU.

The reference's rounding points are kept: RMSNorm normalises in f32 and
casts back before the weight; q is pre-scaled in f32 and cast back to the
storage dtype; scores, softmax and the value product run in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig, LayerSpec


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope_table(positions: torch.Tensor, dim: int, theta: float):
    """positions (S,) -> cos/sin (S, dim//2), f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[:, None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (S, hd//2)."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(x.dtype)


def attention(p: dict, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
              cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Causal GQA self-attention.  p: {wq, wk, wv, wo} of one layer."""
    B, S, _ = x.shape
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.kv_heads
    q = apply_rope((x @ p["wq"]).reshape(B, S, H, hd), cos, sin)
    k = apply_rope((x @ p["wk"]).reshape(B, S, Hkv, hd), cos, sin)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    qs = (q.to(torch.float32) * (1.0 / math.sqrt(hd))).to(q.dtype)
    qf = qs.to(torch.float32).reshape(B, S, Hkv, H // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(torch.float32))
    pos = torch.arange(S, device=x.device)
    mask = pos[:, None] >= pos[None, :]
    if spec.window is not None:
        mask &= pos[:, None] - pos[None, :] < spec.window
    s = s.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(B, S, H * hd).to(x.dtype) @ p["wo"]


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
