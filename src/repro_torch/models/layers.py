"""Building blocks (torch port of ``repro.models.layers``): RMSNorm, RoPE,
GQA causal attention (global or sliding-window), cross-attention and the
encoder's bidirectional attention, DeepSeek's latent attention (MLA) with
their KV-cache forms (prefill, decode), SwiGLU, the capacity-based top-k
MoE, the Mamba selective SSM and the xLSTM cells (mLSTM, sLSTM) with their
recurrent-state forms, as plain PyTorch math (the reference computes them
in plain ``jnp``, outside Pallas).

The reference's rounding points are kept: RMSNorm normalises in f32 and
casts back before the weight; q is pre-scaled in f32 and cast back to the
storage dtype; scores, softmax and the value product run in f32.  Training
takes one softmax over the whole sequence; prefill and decode take the
reference's online-softmax forms, divided by the softmax sum last, so that
greedy tokens follow the reference's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import tp
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
    sequence: q/k (B, S, H or Hkv, hd), v (B, S, Hkv, dv) -> (B, S, H, dv)
    in q's dtype; the scale is 1/sqrt(hd), q's width."""
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
    and accumulator), divided at the end.  q/k (B, Sq or Sk, H or Hkv, hd),
    v (B, Sk, Hkv, dv); returns (B, Sq, H, dv) in q's dtype."""
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
                   cache_pos: int, window, *, start: int = 0, mg=None) -> torch.Tensor:
    """Single-token attention over the cache (the reference's
    ``_decode_attend``): q (B, 1, H, hd) against every cache position
    ``<= cache_pos``, scores scaled after the product, softmax in f32 with
    the division last.

    Context-parallel (the reference's ``cp_axis``): ``ck``/``cv`` hold
    this rank's block of positions, from global position ``start``; the
    ranks' partial softmaxes are combined over ``mg``, the max first
    (``tp.all_max``), then the sums and the value products (``tp.all_sum``,
    rank order in f32), and the division last, so every rank gets the same
    bits."""
    B, _, H, hd = q.shape
    Hkv = ck.shape[2]
    kpos = start + torch.arange(ck.shape[1], device=q.device)
    valid = kpos <= cache_pos
    if window is not None:
        valid &= (cache_pos - kpos) < window
    qh = q.reshape(B, Hkv, H // Hkv, hd).to(torch.float32)
    scores = torch.einsum("bhgd,bshd->bhgs", qh, ck.to(torch.float32)) * (
        1.0 / math.sqrt(hd))
    scores = torch.where(valid, scores, -1e30)
    e = torch.exp(scores - tp.all_max(scores.amax(-1, keepdim=True), mg))
    o = tp.all_sum(torch.einsum("bhgs,bshd->bhgd", e, cv.to(torch.float32)), mg)
    out = o / torch.clamp_min(tp.all_sum(e.sum(-1, keepdim=True), mg), 1e-30)
    return out.reshape(B, 1, H, cv.shape[-1]).to(q.dtype)


def _cache_write(cache: dict, new: dict, start: int, mg) -> None:
    """Write fresh K/V (or MLA latents) ``new`` of positions ``[start, start
    + S)`` into ``cache`` in place.  On one rank at ``start`` clamped into
    the cache (as the reference's dynamic update clamps); where ``mg``
    splits the cache's positions (block ``r`` holds ``[r s_loc, (r + 1)
    s_loc)``), the rank writes only the positions its block holds, as the
    reference's owner shard writes."""
    S = next(iter(new.values())).shape[1]
    s_loc = next(iter(cache.values())).shape[1]
    if not tp.active(mg):
        at = max(min(start, s_loc - S), 0)
        for k, t in new.items():
            cache[k][:, at:at + S] = t
        return
    p0 = mg.rank * s_loc
    a, b = max(start, p0), min(start + S, p0 + s_loc)
    for k, t in new.items():
        if a < b:
            cache[k][:, a - p0:b - p0] = t[:, a - start:b - start]


def _head_blocks(x: torch.Tensor, width: int, heads: int, mg) -> tuple:
    """This rank's heads of a column-parallel projection ``x`` (B, S, its
    block of ``heads * width`` columns): ``(x, h0, h1)`` with ``x`` (B, S,
    h1 - h0, width) holding heads [h0, h1).  A block that is not whole
    heads is gathered over the group first (GSPMD's reshard), and then
    holds every head."""
    cols = x.shape[-1]
    if cols % width:
        return _split_heads(tp.gather(x, mg, -1), width), 0, heads
    h0 = mg.rank * cols // width
    return _split_heads(x, width), h0, h0 + cols // width


def _split_heads(x: torch.Tensor, width: int) -> torch.Tensor:
    return x.reshape(*x.shape[:2], x.shape[2] // width, width)


def _kv_heads(t: torch.Tensor, hd: int, Hkv: int, G: int, h0: int, h1: int,
              mg) -> torch.Tensor:
    """The KV heads that query heads [h0, h1) read in GQA's global map
    (query head ``h`` reads KV head ``h // G``), from a column-parallel
    projection ``t`` (B, S, this rank's block of ``Hkv * hd`` columns):
    its own heads when they are exactly those, else the projection
    gathered over the group and cut to them (:func:`_query_kv`)."""
    k0, k1 = h0 // G, (h1 - 1) // G + 1
    t, kh0, _ = _head_blocks(t, hd, Hkv, mg)
    if (kh0, t.shape[2]) == (k0, k1 - k0):
        return _query_kv(t, G, h0, h1, k0)
    if t.shape[2] != Hkv:  # whole heads, not the ones these queries read
        t = _split_heads(tp.gather(t.flatten(2), mg, -1), hd)
    return _query_kv(t, G, h0, h1)


def _query_kv(t: torch.Tensor, G: int, h0: int, h1: int, base: int = 0) -> torch.Tensor:
    """The KV heads query heads [h0, h1) read, from ``t`` (B, S, heads, hd)
    holding KV heads from ``base`` on: (B, S, k1 - k0, hd) for KV heads
    [k0, k1), or one a query head where the block of query heads is not
    whole GQA groups."""
    k0, k1 = h0 // G, (h1 - 1) // G + 1
    t = t[:, :, k0 - base:k1 - base]
    if (h1 - h0) != (k1 - k0) * G:
        idx = torch.tensor([h // G - k0 for h in range(h0, h1)], device=t.device)
        t = t.index_select(2, idx)
    return t


def _own_columns(out: torch.Tensor, w: torch.Tensor, mg) -> torch.Tensor:
    """``out`` (B, S, every head's columns, where they were all computed)
    cut to the rows ``w``, this rank's block of a row-parallel projection,
    holds; ``out`` itself where it has those columns (one rank)."""
    cols = w.shape[0]
    if out.shape[-1] != cols:
        out = out[..., mg.rank * cols:(mg.rank + 1) * cols]
    return out


def _attention_tp(p: dict, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec, cos, sin,
                  kv_src: torch.Tensor | None, mg) -> torch.Tensor:
    """:func:`attention` (training form) on this rank's blocks: ``wq``,
    ``wk``, ``wv`` column-parallel, ``wo`` row-parallel.  The rank computes
    its block of query heads (all of them where its ``wq`` columns split a
    head) against the KV heads they read (:func:`_kv_heads`).  Its block
    of the output columns goes through its rows of ``wo``, and the ranks'
    products are summed."""
    B, S, _ = x.shape
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.kv_heads
    xin = tp.copy(x, mg)
    src = xin if kv_src is None else tp.copy(kv_src, mg)
    q, h0, h1 = _head_blocks(xin @ p["wq"], hd, H, mg)
    k, v = (_kv_heads(src @ p[w], hd, Hkv, H // Hkv, h0, h1, mg) for w in ("wk", "wv"))
    if kv_src is None:
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        out = _attend(q, k, v, spec.window)
    else:
        out = _attend_chunked(q, k, v, causal=False, window=spec.window)
    return tp.reduce(_own_columns(out.reshape(B, S, -1), p["wo"], mg) @ p["wo"], mg)


def _attention_cached_tp(p: dict, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec, cos,
                         sin, cache: dict, cache_pos: int | None, mg) -> torch.Tensor:
    """:func:`attention` with a cache on this rank's blocks: the weights as
    :func:`_attention_tp`, the cache this rank's block of positions (its
    ``s_loc`` of ``n s_loc``, every KV head).  K/V of every head are
    gathered over the group, and the rank writes the positions its block
    holds (:func:`_cache_write`).  Prefill: the rank's query heads over
    the fresh K/V they read, causal with the window (a prompt may be
    longer than a block).  Decode: the query's heads gathered, each rank
    attends with every head over its positions, and the partial softmaxes
    are combined (:func:`_decode_attend`).  The rank's block of the output
    columns goes through its rows of ``wo``, and the products are
    summed."""
    B, S, _ = x.shape
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.kv_heads
    k, v = (_split_heads(tp.gather(x @ p[w], mg, -1), hd) for w in ("wk", "wv"))
    k = apply_rope(k, cos, sin)
    start = 0 if cache_pos is None else cache_pos
    _cache_write(cache, {"k": k, "v": v}, start, mg)
    if cache_pos is None:
        q, h0, h1 = _head_blocks(x @ p["wq"], hd, H, mg)
        k, v = (_query_kv(t, H // Hkv, h0, h1) for t in (k, v))
        out = _attend_chunked(apply_rope(q, cos, sin), k, v, causal=True, window=spec.window)
    else:
        q = apply_rope(_split_heads(tp.gather(x @ p["wq"], mg, -1), hd), cos, sin)
        out = _decode_attend(q, cache["k"], cache["v"], cache_pos, spec.window,
                             start=mg.rank * cache["k"].shape[1], mg=mg)
    return tp.reduce(_own_columns(out.reshape(B, S, -1), p["wo"], mg) @ p["wo"], mg)


def attention(p: dict, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
              cos: torch.Tensor | None, sin: torch.Tensor | None, cache: dict | None = None,
              cache_pos: int | None = None, *, kv_src: torch.Tensor | None = None,
              mg=None) -> torch.Tensor:
    """Causal GQA self-attention.  p: {wq, wk, wv, wo} of one layer.

    ``kv_src`` (B, T, D): attention of the queries ``x @ wq`` over the keys
    and values ``kv_src @ wk``, ``kv_src @ wv`` instead, with no RoPE on
    either and no causal mask (the window still applies), in the
    reference's chunked form whatever ``cache``: a decoder layer's
    cross-attention over the encoder output, and the encoder's own
    bidirectional attention (the reference's ``kv_override`` of those
    projections).

    ``cache`` ({"k", "v"}, each (B, max_len, Hkv, hd), this layer's slice of
    the stacked cache) is written IN PLACE: with ``cache_pos`` None (prefill)
    the fresh K/V fill positions [0, S) and attention is causal over the
    prompt; with ``cache_pos`` (decode, S == 1) they are spliced in at
    ``cache_pos`` (clamped to the cache, as the reference's dynamic update
    clamps) and the query attends over every cache position
    ``<= cache_pos``.

    ``mg``: the model group (``models/tp``) whose rank holds its blocks of
    the leaves: :func:`_attention_tp` without a cache,
    :func:`_attention_cached_tp` with one (the rank's block of its
    positions)."""
    if tp.active(mg):
        if cache is not None and kv_src is None:
            return _attention_cached_tp(p, x, cfg, spec, cos, sin, cache, cache_pos, mg)
        return _attention_tp(p, x, cfg, spec, cos, sin, kv_src, mg)
    B, S, _ = x.shape
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.kv_heads
    if kv_src is not None:
        T = kv_src.shape[1]
        k, v = ((kv_src @ p[w]).reshape(B, T, Hkv, hd) for w in ("wk", "wv"))
        q = (x @ p["wq"]).reshape(B, S, H, hd)
        out = _attend_chunked(q, k, v, causal=False, window=spec.window)
        return out.reshape(B, S, H * hd) @ p["wo"]
    q = apply_rope((x @ p["wq"]).reshape(B, S, H, hd), cos, sin)
    k = apply_rope((x @ p["wk"]).reshape(B, S, Hkv, hd), cos, sin)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    if cache is None:
        out = _attend(q, k, v, spec.window)
    elif cache_pos is None:
        _cache_write(cache, {"k": k, "v": v}, 0, None)
        out = _attend_chunked(q, k, v, causal=True, window=spec.window)
    else:
        _cache_write(cache, {"k": k, "v": v}, cache_pos, None)
        out = _decode_attend(q, cache["k"], cache["v"], cache_pos, spec.window)
    return out.reshape(B, S, H * hd) @ p["wo"]


def swiglu(p: dict, x: torch.Tensor, mg=None) -> torch.Tensor:
    """SwiGLU; at a model group ``mg``, ``w1``/``w3`` column-parallel and
    ``w2`` row-parallel (``models/tp``)."""
    x = tp.copy(x, mg)
    return tp.reduce((F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"], mg)


def mla_attention(p: dict, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
                  cos: torch.Tensor, sin: torch.Tensor, cache: dict | None = None,
                  cache_pos: int | None = None, *, mg=None) -> torch.Tensor:
    """DeepSeek's multi-head latent attention (the reference's
    ``mla_attention``).  p: {w_dkv, w_krope, w_uk, w_uv, wq, wo} of one
    layer; cos/sin: the table at ``cfg.mla.rope_dim``.

    The cache holds the latents, ``{"c_kv": (B, max_len, kv_lora),
    "k_rope": (B, max_len, rope_dim)}``, written in place as in
    :func:`attention` (prefill at [0, S), decode at ``cache_pos``).  Per-head
    keys and values are rebuilt from ``c_kv`` at every call; the rotated
    ``k_rope`` is one head, broadcast to all.  Scores are those of the
    augmented vectors ``[q_nope | q_rope] . [k_nope | k_rope]``, so the
    scale is 1/sqrt(hd + rope_dim) while values are hd wide.  No window.

    At a model group ``mg``: ``w_dkv``/``w_krope`` replicated, so every
    rank computes the same latents; ``wq``, ``w_uk`` and ``w_uv``
    column-parallel over whole heads, ``wo`` row-parallel.  The latents,
    the query input and the rank's head products enter its block through
    ``tp.copy``, the output leaves through ``tp.reduce``.  With a cache (the
    rank's block of its positions) the rank writes only the positions its
    block holds (where the reference's ``cp_axis`` decode writes at the
    global position on every shard); a prefill attends over the fresh
    latents, a decode step over every position's latents gathered over
    the group, with the rank's heads."""
    B, S, _ = x.shape
    hd, H, r = cfg.hd, cfg.n_heads, cfg.mla.rope_dim
    c_kv = x @ p["w_dkv"]
    k_rope = apply_rope((x @ p["w_krope"])[:, :, None, :], cos, sin)[:, :, 0]
    if tp.active(mg):
        H = p["wq"].shape[1] // (hd + r)
        if p["wq"].shape[1] != H * (hd + r) or p["w_uk"].shape[1] != H * hd:
            raise ValueError(f"MLA at model = {mg.size}: {cfg.n_heads} heads do not split "
                             f"into whole heads a rank")
        x, c_kv, k_rope = (tp.copy(t, mg) for t in (x, c_kv, k_rope))
    q = (x @ p["wq"]).reshape(B, S, H, hd + r)
    q_aug = torch.cat([q[..., :hd], apply_rope(q[..., hd:], cos, sin)], -1)
    if cache is not None:
        _cache_write(cache, {"c_kv": c_kv, "k_rope": k_rope},
                     0 if cache_pos is None else cache_pos, mg)
        if cache_pos is not None:  # every position's latents
            c_kv, k_rope = (tp.gather(cache[k], mg, 1) for k in ("c_kv", "k_rope"))
    Sk = c_kv.shape[1]
    k_aug = torch.cat([(c_kv @ p["w_uk"]).reshape(B, Sk, H, hd),
                       k_rope[:, :, None, :].expand(B, Sk, H, r)], -1)
    v = (c_kv @ p["w_uv"]).reshape(B, Sk, H, hd)
    if cache is None:
        out = _attend(q_aug, k_aug, v, None)
    elif cache_pos is None:
        out = _attend_chunked(q_aug, k_aug, v, causal=True, window=None)
    else:
        out = _decode_attend(q_aug, k_aug, v, cache_pos, None)
    return tp.reduce(out.reshape(B, S, H * hd) @ p["wo"], mg)


def moe_capacity(cfg: ArchConfig, n_tokens: int, capacity_factor: float = 1.25,
                 dropless_below: int = 512) -> int:
    """Slots an expert has: all ``n_tokens`` up to ``dropless_below`` (no
    token can be dropped: an expert takes a token at most once), else
    ``n_tokens * top_k / n_experts * capacity_factor``."""
    m = cfg.moe
    if n_tokens <= dropless_below:
        return n_tokens
    return max(1, int(n_tokens * m.top_k / m.n_experts * capacity_factor))


def moe_route(logits: torch.Tensor, cfg: ArchConfig, capacity: int) -> tuple:
    """The reference's routing and dispatch tables from router logits (T, E)
    in f32: ``gates`` (T, k) f32 and ``eids`` (T, k), the top-k of the
    softmax with ties to the lower expert id (a stable descending sort, as
    ``jax.lax.top_k``), gates renormalised by max(sum, 1e-9); ``slot``
    (E, C), the flat pick index (token * k + j) each expert slot takes, T*k
    where empty; ``where`` (T*k,), the slot (e * C + c) each pick went to,
    E*C where dropped.

    Picks fill an expert's slots in token order (a stable sort of the flat
    expert ids).  The reference writes its slot table with every
    overflowing pick clipped onto slot C-1 carrying the empty marker, and
    the last write stands: an expert with more than C picks keeps only C-1
    (a fault of the reference that the port keeps, ROADMAP Queue C).  Here
    that is a formula, not a write to a repeated index: the pick at rank
    C-1 is dropped too when its expert has more than C."""
    m = cfg.moe
    T, k, E, C = logits.shape[0], m.top_k, m.n_experts, capacity
    dev = logits.device
    probs, ranked = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True,
                               stable=True)
    gates, eids = probs[:, :k], ranked[:, :k]
    total = gates[:, 0]
    for j in range(1, k):
        total = total + gates[:, j]
    gates = gates / torch.clamp_min(total, 1e-9)[:, None]
    flat_e = eids.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    experts = torch.arange(E, device=dev)
    start = torch.searchsorted(sorted_e, experts)
    count = torch.searchsorted(sorted_e, experts, right=True) - start

    def kept(rank, n):  # the slot table's fill, its C-1 quirk included
        return (rank < n) & (rank < C) & ~((rank == C - 1) & (n > C))

    rank = torch.arange(T * k, device=dev) - start[sorted_e]
    placed = torch.where(kept(rank, count[sorted_e]), sorted_e * C + rank, E * C)
    where = placed[torch.argsort(order)]
    c = torch.arange(C, device=dev)[None]
    slot = torch.where(kept(c, count[:, None]),
                       order[torch.clamp_max(start[:, None] + c, T * k - 1)], T * k)
    return gates, eids, slot, where


def moe_combine(weighted: torch.Tensor, where: torch.Tensor,
                eids: torch.Tensor) -> torch.Tensor:
    """Each token's gated expert outputs summed in f32: ``weighted`` (E*C,
    D), slot by slot; ``where`` (T*k,) and ``eids`` (T, k) from
    :func:`moe_route`.  A token's kept picks add in ascending expert id onto
    0.0, the order of the reference's slot-order (expert-major) scatter-add;
    a dropped pick reads an appended zero row, which leaves the sum as it
    is (a sum begun at +0.0 is never -0.0)."""
    (T, k), D = eids.shape, weighted.shape[1]
    picks = torch.gather(where.reshape(T, k), 1, torch.sort(eids, -1).indices)
    contrib = F.embedding(picks, torch.cat([weighted, weighted.new_zeros(1, D)]))
    out = contrib.new_zeros(T, D)
    for j in range(k):
        out = out + contrib[:, j]
    return out


class MoEDispatch(NamedTuple):
    """One MoE layer's routing and expert products (:func:`moe_dispatch`):
    ``gates``, ``eids``, ``slot`` and ``where`` as :func:`moe_route`;
    ``tok`` (E, C), the token each slot holds (T where empty); ``xg`` (E,
    C, D), those tokens (a zero row where empty); ``h`` (E, C, D), the
    expert SwiGLU's outputs."""
    gates: torch.Tensor
    eids: torch.Tensor
    slot: torch.Tensor
    where: torch.Tensor
    tok: torch.Tensor
    xg: torch.Tensor
    h: torch.Tensor


def moe_dispatch(p: dict, xt: torch.Tensor, cfg: ArchConfig, capacity: int) -> MoEDispatch:
    """Route tokens ``xt`` (T, D) as :func:`moe_route` over the bf16 router
    product cast to f32, gather each expert's C slots' tokens into (E, C,
    D) and run the expert SwiGLU as batched products.  The gather is
    ``F.embedding`` over ``xt`` with a zero row appended (see :func:`moe`)."""
    T, D = xt.shape
    k = cfg.moe.top_k
    gates, eids, slot, where = moe_route((xt @ p["router"]).to(torch.float32), cfg, capacity)
    tok = torch.where(slot < T * k, slot // k, T)
    xg = F.embedding(tok, torch.cat([xt, xt.new_zeros(1, D)]))
    h = torch.bmm(F.silu(torch.bmm(xg, p["we1"])) * torch.bmm(xg, p["we3"]), p["we2"])
    return MoEDispatch(gates, eids, slot, where, tok, xg, h)


def moe(p: dict, x: torch.Tensor, cfg: ArchConfig, *, capacity_factor: float = 1.25,
        dropless_below: int = 512, mg=None) -> torch.Tensor:
    """Capacity-based top-k MoE with shared experts (the reference's
    ``moe``): x (B, S, D) -> (B, S, D).  Routing, dispatch and the expert
    SwiGLU as :func:`moe_dispatch`; each slot's output times its gate (f32)
    goes back to its token (:func:`moe_combine`); the sum is cast to the
    model dtype and the shared experts' SwiGLU added.

    Every gather of a float is ``F.embedding`` over a table with a zero row
    appended: its CUDA backward is deterministic, and a slot's row receives
    the gradient of at most one pick.  So no float scatter-add or index-add
    (atomic on CUDA) runs, forward or backward.

    At a model group ``mg`` (expert parallelism, :func:`_moe_ep`): the
    router replicated, the routed experts split by expert over the group,
    the shared experts a tensor-parallel SwiGLU."""
    B, S, D = x.shape
    E = cfg.moe.n_experts
    T = B * S
    C = moe_capacity(cfg, T, capacity_factor, dropless_below)
    xt = x.reshape(T, D)
    if tp.active(mg):
        return _moe_ep(p, xt, cfg, C, mg).reshape(B, S, D)
    d = moe_dispatch(p, xt, cfg, C)
    gate_of_slot = F.embedding(d.slot, torch.cat([d.gates.reshape(-1, 1),
                                                  d.gates.new_zeros(1, 1)]))  # (E, C, 1)
    out = moe_combine((d.h.to(torch.float32) * gate_of_slot).reshape(E * C, D), d.where,
                      d.eids)
    y = out.to(x.dtype)
    if cfg.moe.n_shared:
        y = y + swiglu(p["shared"], xt)
    return y.reshape(B, S, D)


def _moe_ep(p: dict, xt: torch.Tensor, cfg: ArchConfig, C: int, mg) -> torch.Tensor:
    """:func:`moe` over tokens ``xt`` (T, D), replicated over the model
    group, with this rank's block of ``E / n`` experts (the reference's
    ``P("model", None, None)`` on ``we1``/``we3``/``we2``).  Every rank
    computes the same route and slot table (:func:`moe_route` on the
    replicated router, the C-1 quirk kept), runs only its own experts'
    slots and combines their gated outputs in f32 as :func:`moe_combine`
    does (the other ranks' picks read the zero row); the partial sums are
    added over the group in f32 before the cast.  The tokens and the gates
    enter the expert block through ``tp.copy``, so their gradients (and
    the router's) are summed over the group."""
    T, D = xt.shape
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    n_loc = p["we1"].shape[0]
    e0 = mg.rank * n_loc
    gates, eids, slot, where = moe_route((xt @ p["router"]).to(torch.float32), cfg, C)
    slot = slot[e0:e0 + n_loc]
    xe, ge = tp.copy(xt, mg), tp.copy(gates, mg)
    tok = torch.where(slot < T * k, slot // k, T)
    xg = F.embedding(tok, torch.cat([xe, xe.new_zeros(1, D)]))
    h = torch.bmm(F.silu(torch.bmm(xg, p["we1"])) * torch.bmm(xg, p["we3"]), p["we2"])
    gate_of_slot = F.embedding(slot, torch.cat([ge.reshape(-1, 1), ge.new_zeros(1, 1)]))
    local = where - e0 * C
    local = torch.where((where < E * C) & (local >= 0) & (local < n_loc * C), local, n_loc * C)
    out = moe_combine((h.to(torch.float32) * gate_of_slot).reshape(n_loc * C, D), local, eids)
    y = tp.reduce(out, mg).to(xt.dtype)
    if cfg.moe.n_shared:
        y = y + swiglu(p["shared"], xt, mg)
    return y


# ---------------------------------------------------------------------------
# Mamba selective SSM (jamba)
# ---------------------------------------------------------------------------

def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _scan_chunk(da: torch.Tensor, db: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The states of one chunk, time-major: da/db (ch, B, di, ds) f32, h0
    (B, di, ds) -> h (ch, B, di, ds) with h_t = da_t h_{t-1} + db_t.  The
    pairs (a, b) are combined as the reference's associative scan combines
    them, ``(a1 a2, b1 a2 + b2)``, by a doubling scan (log2(ch) steps over
    the whole chunk), then ``h = h0 a + b``: the same recurrence with the
    f32 products in another order than XLA's combine tree."""
    a, b = da, db
    off = 1
    while off < a.shape[0]:
        a, b = (torch.cat([a[:off], a[off:] * a[:-off]]),
                torch.cat([b[:off], b[:-off] * a[off:] + b[off:]]))
        off *= 2
    return h0[None] * a + b


def _state_block(state: dict | None, lo: int, n: int, dims: dict) -> dict | None:
    """This rank's block ``[lo, lo + n)`` of a whole recurrent ``state`` on
    each leaf's dim in ``dims``."""
    if state is None:
        return None
    return {k: t.narrow(dims[k], lo, n) for k, t in state.items()}


def _state_whole(state: dict, dims: dict, mg) -> dict:
    """A recurrent state of the ranks' blocks on each leaf's dim in
    ``dims`` gathered over the group in rank order: the whole state, the
    same bits on every rank."""
    return {k: tp.gather(t, mg, dims[k]) for k, t in state.items()}


def mamba(p: dict, x: torch.Tensor, cfg: ArchConfig, *, state: dict | None = None,
          chunk: int = 256, return_state: bool = False, mg=None) -> tuple:
    """Selective SSM (the reference's ``mamba``): x (B, S, D) -> (out, state).
    p: {in_proj, conv_w, w_bc_dt, a_log, d_skip, out_proj, dt_bias}, the
    last three and ``a_log`` f32.

    Without ``state`` (training, prefill): a causal depthwise conv by
    shifted adds, SiLU; ``w_bc_dt`` gives B, C and ONE dt column, which is
    broadcast over the inner width before ``dt_bias`` and softplus; then
    the scan over ``n_ch = max(1, S // chunk)`` chunks, each chunk's states
    by :func:`_scan_chunk` on (ch, B, di, ds) slices (never the whole
    sequence's), h carried across chunks.  S must split into ``n_ch``
    equal chunks, else ValueError (the reference asserts it).
    ``return_state`` also returns ``{"h": (B, di, ds) f32, "conv": (B, k-1,
    di)}``, ``conv`` the last k-1 PRE-activation inputs, else None.

    With ``state`` (decode, S == 1): the conv over the state's history and
    the new input, one recurrence step; returns the next state.

    At a model group ``mg`` (``spec_mamba``): the rank holds a block of the
    inner channels, ``[r di / n, (r + 1) di / n)``, of
    ``conv_w``, ``a_log``, ``d_skip``, ``dt_bias`` and the rows of
    ``w_bc_dt`` and ``out_proj``, but its block of ``in_proj``'s columns is
    the reference's contiguous ``P(None, "model")`` block of ``[xs | z]``,
    not its channels of both halves.  So ``x @ in_proj`` is gathered over
    the group (``tp.gather``: its backward sums the gradient over the group
    and keeps this rank's columns, which routes each channel's gradient to
    the rank holding its column, exactly: one rank's value and zeros), and
    the rank takes its channels of ``xs`` and ``z``.  B, C and the one dt
    column are the sum over the group of the ranks' ``w_bc_dt`` rows
    (``tp.reduce``) before ``dt_bias`` and softplus, re-entering the
    channel-split region through ``tp.copy``; ``out_proj`` is row-parallel
    and its products are summed.  A state is whole on every rank: the rank
    reads its channels of ``state`` and returns the next state gathered
    whole over the group."""
    B, S, D = x.shape
    mc = cfg.mamba
    di, ds, k = mc.expand * D, mc.d_state, mc.d_conv
    xz = tp.gather(tp.copy(x, mg) @ p["in_proj"], mg, -1)
    dl = p["conv_w"].shape[1]  # this rank's channels: di, or di / n at a model group
    c0 = mg.rank * dl if tp.active(mg) else 0
    xs, z = xz[..., c0:c0 + dl], xz[..., di + c0:di + c0 + dl]
    dims = {"h": 1, "conv": 2}  # the channel dim of each state leaf
    if tp.active(mg):
        state = _state_block(state, c0, dl, dims)
    conv_w = p["conv_w"]
    hist = xs if state is None else torch.cat([state["conv"], xs], 1)
    lead = hist.shape[1] - S  # 0, or the k-1 positions of the state
    acc = torch.zeros_like(xs)
    for i in range(k):
        if state is None:  # x shifted right by i positions, zeros in front
            shifted = torch.cat([xs.new_zeros(B, min(i, S), dl), xs[:, :max(S - i, 0)]], 1)
        else:
            shifted = hist[:, lead - i:lead - i + S]
        acc = acc + shifted * conv_w[k - 1 - i]
    xc = F.silu(acc)
    bcd = tp.copy(tp.reduce(xc @ p["w_bc_dt"], mg), mg)
    Bm, Cm = bcd[..., :ds], bcd[..., ds:2 * ds]
    dt = _softplus(bcd[..., -1:].to(torch.float32) + p["dt_bias"])  # (B, S, dl)
    A = -torch.exp(p["a_log"])  # (dl, ds)
    xcf = xc.to(torch.float32)

    def gates(sl):  # da, db of positions ``sl``, time-major (s, B, dl, ds)
        dt_s = dt[:, sl].transpose(0, 1)[..., None]
        da = torch.exp(dt_s * A)
        db = (dt_s * Bm[:, sl].transpose(0, 1)[:, :, None, :]).to(torch.float32) * \
            xcf[:, sl].transpose(0, 1)[..., None]
        return da, db

    if state is not None:
        da, db = gates(slice(0, 1))
        h = state["h"] * da[0] + db[0]
        y = torch.einsum("bds,bs->bd", h, Cm[:, 0].to(torch.float32))[:, None]
        y = (y + xcf * p["d_skip"]) * F.silu(z.to(torch.float32))
        new = {"h": h, "conv": hist[:, -(k - 1):]}
        return (tp.reduce(y.to(x.dtype) @ p["out_proj"], mg),
                _state_whole(new, dims, mg) if tp.active(mg) else new)
    n_ch = max(1, S // chunk)
    if S % n_ch:
        raise ValueError(f"mamba: {S} positions do not split into {n_ch} equal chunks")
    ch = S // n_ch
    h = torch.zeros((B, dl, ds), dtype=torch.float32, device=x.device)
    ys = []
    Cf = Cm.to(torch.float32)
    for c0 in range(0, S, ch):
        hs = _scan_chunk(*gates(slice(c0, c0 + ch)), h)
        ys.append(torch.einsum("sbdn,sbn->sbd", hs, Cf[:, c0:c0 + ch].transpose(0, 1)))
        h = hs[-1]
    y = torch.cat(ys).transpose(0, 1)
    y = (y + xcf * p["d_skip"]) * F.silu(z.to(torch.float32))
    out = tp.reduce(y.to(x.dtype) @ p["out_proj"], mg)
    if return_state:
        new = {"h": h, "conv": xs[:, S - (k - 1):]}
        return out, _state_whole(new, dims, mg) if tp.active(mg) else new
    return out, None


# ---------------------------------------------------------------------------
# xLSTM cells (mLSTM: matrix memory, sLSTM: scalar memory), stepped in time
# ---------------------------------------------------------------------------

def _xlstm_inputs_tp(p: dict, x: torch.Tensor, cfg: ArchConfig, kv: tuple, mg) -> tuple:
    """An xLSTM cell's projections on this rank's heads at a model group
    ``mg`` (``spec_xlstm_full``): ``(q, {name: (B, S, h, hd)} of the ``kv``
    leaves, one a query head (GQA's KV heads repeated), (log input gate,
    log forget gate) each (B, S, h) f32)``, q (B, S, h, hd) from ``wq``, in
    the model dtype but the gates.  The rank computes its block of query
    heads with the KV heads they read, as TP attention does
    (:func:`_head_blocks`, :func:`_kv_heads`); where the projections' block
    splits a head, the columns are gathered over the group first and every
    rank computes every head.  Its gates are its columns of ``wi``/``wf``
    where those split over the heads; where ``sanitize_specs`` keeps them
    whole (fewer heads than ranks) every rank computes them whole, and the
    product enters the head region through ``tp.copy``, so the gates'
    gradient, and the replicated leaves', is summed over the group."""
    H, hd, Hkv = cfg.n_heads, cfg.hd, cfg.kv_heads
    G = H // Hkv
    xin = tp.copy(x, mg)
    q, h0, h1 = _head_blocks(xin @ p["wq"], hd, H, mg)
    kvs = {}
    for w in kv:
        t = _kv_heads(xin @ p[w], hd, Hkv, G, h0, h1, mg)
        kvs[w] = t if t.shape[2] == h1 - h0 else torch.repeat_interleave(t, G, dim=2)
    if p["wi"].shape[1] == H:  # the gates whole on every rank: this rank's heads of them
        gi, gf = (tp.copy(x @ p[w], mg)[..., h0:h1] for w in ("wi", "wf"))
    else:  # the rank's block of the gates' columns: its heads [h0, h1)
        gi, gf = xin @ p["wi"], xin @ p["wf"]
    return q, kvs, (gi.to(torch.float32), F.logsigmoid(gf.to(torch.float32)))


def _heads_block(state: dict | None, H: int, cfg: ArchConfig, mg) -> dict | None:
    """This rank's heads ``[r H, (r + 1) H)`` of a whole xLSTM ``state``
    (every leaf's head dim is 1) where the rank computes ``H`` of the
    model's heads; ``state`` as it is where it computes every head."""
    if state is None or not tp.active(mg) or H == cfg.n_heads:
        return state
    return _state_block(state, mg.rank * H, H, dict.fromkeys(state, 1))


def _heads_whole(state: dict, H: int, cfg: ArchConfig, mg) -> dict:
    """An xLSTM state of the rank's ``H`` heads gathered whole over the
    group; ``state`` as it is where the rank computes every head."""
    if not tp.active(mg) or H == cfg.n_heads:
        return state
    return _state_whole(state, dict.fromkeys(state, 1), mg)


def _gate_logs(p: dict, x: torch.Tensor) -> tuple:
    """(log input gate, log forget gate), each (B, S, H) f32."""
    return ((x @ p["wi"]).to(torch.float32),
            F.logsigmoid((x @ p["wf"]).to(torch.float32)))


def mlstm(p: dict, x: torch.Tensor, cfg: ArchConfig, *, state: dict | None = None,
          mg=None, serve: bool = False) -> tuple:
    """mLSTM (the reference's ``mlstm``): per head a matrix memory C (hd x
    hd) with an exponential input gate and a sigmoid forget gate,
    stabilised by the running max m.  p: {wq, wk, wv, wi, wf, wo}; k and v
    are repeated over the GQA groups, then k scaled by 1/sqrt(hd); the
    output divides by max(|q . n|, 1).  Steps over time in f32 from
    ``state`` ({"C", "n", "m"}; None: zeros and m = -1e30); returns (out,
    the state after the last step).  ``mg``: heads split over a model group
    (:func:`_xlstm_inputs_tp`; ``wo`` row-parallel, the rank's block of the
    heads' columns, cut from every head where it computed them all, summed
    over the group); a given ``state`` is whole and the rank reads its
    heads of it (:func:`_heads_block`); the state returned is the rank's
    heads', or with ``serve`` gathered whole (:func:`_heads_whole`).  On
    one rank the projections are taken in the order below: it sets the
    order in which the bf16 gradient of ``x`` sums its parts."""
    B, S, _ = x.shape
    H, hd, G = cfg.n_heads, cfg.hd, cfg.n_heads // cfg.kv_heads
    if tp.active(mg):
        q, kvs, (logi, logf) = _xlstm_inputs_tp(p, x, cfg, ("wk", "wv"), mg)
        H = q.shape[2]
        state = _heads_block(state, H, cfg, mg)
        q = q.to(torch.float32)
        k = kvs["wk"].to(torch.float32) / math.sqrt(hd)
        v = kvs["wv"].to(torch.float32)
    else:
        q = (x @ p["wq"]).reshape(B, S, H, hd).to(torch.float32)
        k = (x @ p["wk"]).reshape(B, S, cfg.kv_heads, hd).to(torch.float32)
        v = (x @ p["wv"]).reshape(B, S, cfg.kv_heads, hd).to(torch.float32)
        k = torch.repeat_interleave(k, G, dim=2) / math.sqrt(hd)
        v = torch.repeat_interleave(v, G, dim=2)
        logi, logf = _gate_logs(p, x)
    if state is None:
        C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        m = torch.full((B, H), -1e30, dtype=torch.float32, device=x.device)
    else:
        C, n, m = state["C"], state["n"], state["m"]
    ys = []
    for t in range(S):
        m_new = torch.maximum(logf[:, t] + m, logi[:, t])
        i_g = torch.exp(logi[:, t] - m_new)[..., None]
        f_g = torch.exp(logf[:, t] + m - m_new)[..., None]
        C = f_g[..., None] * C + i_g[..., None] * torch.einsum("bhd,bhe->bhde", k[:, t], v[:, t])
        n = f_g * n + i_g * k[:, t]
        num = torch.einsum("bhd,bhde->bhe", q[:, t], C)
        den = torch.abs(torch.einsum("bhd,bhd->bh", q[:, t], n))[..., None]
        ys.append(num / torch.clamp_min(den, 1.0))
        m = m_new
    y = torch.stack(ys, 1).reshape(B, S, H * hd).to(x.dtype)
    new = {"C": C, "n": n, "m": m}
    return (tp.reduce(_own_columns(y, p["wo"], mg) @ p["wo"], mg),
            _heads_whole(new, H, cfg, mg) if serve else new)


def slstm(p: dict, x: torch.Tensor, cfg: ArchConfig, *, state: dict | None = None,
          mg=None, serve: bool = False) -> tuple:
    """sLSTM (the reference's ``slstm``): per head a scalar-memory cell with
    exponential gating and a normaliser state.  p: {wq, wk, wv, wi, wf,
    wo}: ``wq`` gives the sigmoid output gate and ``wk`` is never read (as
    in the reference: its gradient is zero, in every block at a model
    group).  Steps over time in f32 from ``state`` ({"c", "n", "m"}; None:
    zeros and m = -1e30); returns (out, the state after the last step).
    ``mg`` as in :func:`mlstm`."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    if tp.active(mg):
        q, kvs, (logi, logf) = _xlstm_inputs_tp(p, x, cfg, ("wv",), mg)
        H = q.shape[2]
        state = _heads_block(state, H, cfg, mg)
        v = kvs["wv"].to(torch.float32)
        o = torch.sigmoid(q.to(torch.float32))
    else:
        v = (x @ p["wv"]).reshape(B, S, cfg.kv_heads, hd).to(torch.float32)
        v = torch.repeat_interleave(v, H // cfg.kv_heads, dim=2)
        o = torch.sigmoid((x @ p["wq"]).reshape(B, S, H, hd).to(torch.float32))
        logi, logf = _gate_logs(p, x)
    if state is None:
        c = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, H), dtype=torch.float32, device=x.device)
        m = torch.full((B, H), -1e30, dtype=torch.float32, device=x.device)
    else:
        c, n, m = state["c"], state["n"], state["m"]
    ys = []
    for t in range(S):
        m_new = torch.maximum(logf[:, t] + m, logi[:, t])
        i_g = torch.exp(logi[:, t] - m_new)
        f_g = torch.exp(logf[:, t] + m - m_new)
        c = f_g[..., None] * c + i_g[..., None] * v[:, t]
        n = f_g * n + i_g
        ys.append(o[:, t] * c / torch.clamp_min(n, 1.0)[..., None])
        m = m_new
    y = torch.stack(ys, 1).reshape(B, S, H * hd).to(x.dtype)
    new = {"c": c, "n": n, "m": m}
    return (tp.reduce(_own_columns(y, p["wo"], mg) @ p["wo"], mg),
            _heads_whole(new, H, cfg, mg) if serve else new)


# ---------------------------------------------------------------------------
# tensor-parallel layouts: per leaf, one spec entry a dim (``launch/mesh``):
# 'model' on the column dim of the input projections, the row dim of the
# output projections and of Mamba's inner-width leaves, the expert dim of
# the routed experts; MLA's down-projections and the router replicated
# ---------------------------------------------------------------------------

def spec_attention(cfg: ArchConfig) -> dict:
    return {"wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
            "wo": ("model", None)}


def spec_mla(cfg: ArchConfig) -> dict:
    return {"w_dkv": (None, None), "w_krope": (None, None), "w_uk": (None, "model"),
            "w_uv": (None, "model"), "wq": (None, "model"), "wo": ("model", None)}


def spec_swiglu() -> dict:
    return {"w1": (None, "model"), "w3": (None, "model"), "w2": ("model", None)}


def spec_moe(cfg: ArchConfig) -> dict:
    s = {"router": (None, None), "we1": ("model", None, None),
         "we3": ("model", None, None), "we2": ("model", None, None)}
    if cfg.moe.n_shared:
        s["shared"] = spec_swiglu()
    return s


def spec_mamba(cfg: ArchConfig) -> dict:
    return {"in_proj": (None, "model"), "conv_w": (None, "model"),
            "w_bc_dt": ("model", None), "a_log": ("model", None), "d_skip": ("model",),
            "out_proj": ("model", None), "dt_bias": ("model",)}


def spec_xlstm_full(cfg: ArchConfig) -> dict:
    return dict(spec_attention(cfg), wi=(None, "model"), wf=(None, "model"))
