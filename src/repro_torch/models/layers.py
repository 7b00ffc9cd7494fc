"""Dense building blocks (torch port of ``repro.models.layers``): RMSNorm,
RoPE, GQA causal attention (global or sliding-window) with its KV-cache
forms (prefill, decode) as plain PyTorch math, SwiGLU.

The reference's rounding points are kept: RMSNorm normalises in f32 and
casts back before the weight; q is pre-scaled in f32 and cast back to the
storage dtype; scores, softmax and the value product run in f32.  Training
takes one softmax over the whole sequence; prefill and decode take the
reference's online-softmax forms, divided by the softmax sum last, so that
greedy tokens follow the reference's.
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
    """positions (S,) -> cos/sin (S, dim//2), f32.  Also the table of M-RoPE
    (``ArchConfig.mrope``): with the vision frontend stubbed, every position
    is a text position, whose three M-RoPE sections are equal, which makes
    it plain RoPE (as in the reference).  The angles are the
    reference's f32 products; cos and sin are taken in f64 and rounded, which
    agrees with XLA's f32 cos/sin far more often than torch's f32 ones do
    (measured on the CPU: 0.9% vs 5% of a 1024 x 8 table differ)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = (positions.to(torch.float32)[:, None] * inv).to(torch.float64)
    return torch.cos(ang).to(torch.float32), torch.sin(ang).to(torch.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (S, hd//2)."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(x.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window) -> torch.Tensor:
    """Causal attention of the training forward, one softmax over the whole
    sequence: q (B, S, H, hd), k/v (B, S, Hkv, hd) -> (B, S, H, hd) in q's
    dtype."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qs = (q.to(torch.float32) * (1.0 / math.sqrt(hd))).to(q.dtype)
    qf = qs.to(torch.float32).reshape(B, S, Hkv, H // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(torch.float32))
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    s = s.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(B, S, H, -1).to(q.dtype)


def _attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """The reference's chunked flash attention (``_attend_chunked``), the
    forward in its arithmetic: q pre-scaled in f32 and cast back, then per
    (q chunk, kv tile) an online softmax in f32 (running max, rescaled sum
    and accumulator), divided at the end.  q (B, Sq, H, hd), k/v (B, Sk,
    Hkv, hd); returns (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Sk)
    if Sq % q_chunk:
        q_chunk = Sq
    if Sk % kv_chunk:
        kv_chunk = Sk
    qs = (q.to(torch.float32) * (1.0 / math.sqrt(hd))).to(q.dtype)
    qf = qs.to(torch.float32).reshape(B, Sq, Hkv, G, hd)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dev = q.device
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qh = qf[:, q0:q0 + q_chunk]
        qpos = torch.arange(q0, q0 + q_chunk, device=dev)
        m = torch.full((B, Hkv, G, q_chunk), float("-inf"), device=dev)
        l = torch.zeros((B, Hkv, G, q_chunk), device=dev)
        acc = torch.zeros((B, Hkv, G, q_chunk, vf.shape[-1]), device=dev)
        for k0 in range(0, Sk, kv_chunk):
            kpos = torch.arange(k0, k0 + kv_chunk, device=dev)
            s = torch.einsum("bchgd,bshd->bhgcs", qh, kf[:, k0:k0 + kv_chunk])
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= qpos[:, None] - kpos[None, :] < window
            s = s.masked_fill(~mask, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgcs,bshd->bhgcd", p, vf[:, k0:k0 + kv_chunk])
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, C, Hkv, G, dv)
    return torch.cat(outs, 1).reshape(B, Sq, H, -1).to(q.dtype)


def _decode_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                   cache_pos: int, window) -> torch.Tensor:
    """Single-token attention over the cache (the reference's
    ``_decode_attend``): q (B, 1, H, hd) against every cache position
    ``<= cache_pos``, scores scaled after the product, softmax in f32 with
    the division last."""
    B, _, H, hd = q.shape
    Hkv = ck.shape[2]
    kpos = torch.arange(ck.shape[1], device=q.device)
    valid = kpos <= cache_pos
    if window is not None:
        valid &= (cache_pos - kpos) < window
    qh = q.reshape(B, Hkv, H // Hkv, hd).to(torch.float32)
    scores = torch.einsum("bhgd,bshd->bhgs", qh, ck.to(torch.float32)) * (
        1.0 / math.sqrt(hd))
    scores = torch.where(valid, scores, -1e30)
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    o = torch.einsum("bhgs,bshd->bhgd", e, cv.to(torch.float32))
    out = o / torch.clamp_min(e.sum(-1, keepdim=True), 1e-30)
    return out.reshape(B, 1, H, cv.shape[-1]).to(q.dtype)


def attention(p: dict, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
              cos: torch.Tensor, sin: torch.Tensor, cache: dict | None = None,
              cache_pos: int | None = None) -> torch.Tensor:
    """Causal GQA self-attention.  p: {wq, wk, wv, wo} of one layer.

    ``cache`` ({"k", "v"}, each (B, max_len, Hkv, hd), this layer's slice of
    the stacked cache) is written IN PLACE: with ``cache_pos`` None (prefill)
    the fresh K/V fill positions [0, S) and attention is causal over the
    prompt; with ``cache_pos`` (decode, S == 1) they are spliced in at
    ``cache_pos`` (clamped to the cache, as the reference's dynamic update
    clamps) and the query attends over every cache position
    ``<= cache_pos``."""
    B, S, _ = x.shape
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.kv_heads
    q = apply_rope((x @ p["wq"]).reshape(B, S, H, hd), cos, sin)
    k = apply_rope((x @ p["wk"]).reshape(B, S, Hkv, hd), cos, sin)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    if cache is None:
        out = _attend(q, k, v, spec.window)
    elif cache_pos is None:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        out = _attend_chunked(q, k, v, causal=True, window=spec.window)
    else:
        at = min(max(cache_pos, 0), cache["k"].shape[1] - S)
        cache["k"][:, at:at + S] = k
        cache["v"][:, at:at + S] = v
        out = _decode_attend(q, cache["k"], cache["v"], cache_pos, spec.window)
    return out.reshape(B, S, H * hd) @ p["wo"]


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
