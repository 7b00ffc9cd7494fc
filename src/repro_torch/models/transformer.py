"""Decoder stack (torch port of ``repro.models.transformer``): each layer
is GQA attention or MLA, then SwiGLU or MoE, as its ``LayerSpec`` says.

Parameters keep the reference's layout: the prefix layers ``prefix_<i>``
are unstacked and run first; per pattern position, every layer leaf is
STACKED over repeats (``(repeats, ...)``).  The parameters are registered
in the order of the reference's ``jax.tree_util.tree_leaves`` (dict keys
sorted as strings: ``blocks/...``, ``embed``, ``final_norm``, ``lm_head``,
then ``prefix_0``, ``prefix_1``, ``prefix_10``, ``prefix_2``, ...), named by
their path in the reference's tree (``blocks/0/ffn/w1``, ...,
``prefix_0/mixer/wq``).  So the ZeRO-1 bucket of the port holds the same
bytes as ``zero1.flatten_buckets`` of the reference for the same weights,
and :func:`load_reference_params` carries weights across.  A batch's
``vision_embeds`` (the VLM frontend stub) replace the leading positions'
token embeddings.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels
from repro_torch.core import codec
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig, LayerSpec


def _dense(*shape) -> tuple:
    """A dense leaf's (shape, init scale): 1/sqrt(shape[0]), the reference's
    ``_dense_init``; for the stacked experts (E, ., .) that is
    1/sqrt(n_experts), not the fan-in."""
    return shape, 1.0 / np.sqrt(shape[0])


def _swiglu_shapes(d: int, f: int) -> dict:
    return {"w1": _dense(d, f), "w3": _dense(d, f), "w2": _dense(f, d)}


def _layer_shapes(cfg: ArchConfig, spec: LayerSpec) -> dict:
    """(shape, init scale) per leaf of one layer of ``spec``; scale None =
    ones (norms), 0.02 for the router, :func:`_dense` else."""
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    if spec.mixer == "attn":
        mixer = {"wq": _dense(d, H * hd), "wk": _dense(d, cfg.kv_heads * hd),
                 "wv": _dense(d, cfg.kv_heads * hd), "wo": _dense(H * hd, d)}
    elif spec.mixer == "mla":
        m = cfg.mla
        mixer = {"w_dkv": _dense(d, m.kv_lora), "w_krope": _dense(d, m.rope_dim),
                 "w_uk": _dense(m.kv_lora, H * hd), "w_uv": _dense(m.kv_lora, H * hd),
                 "wq": _dense(d, H * (hd + m.rope_dim)), "wo": _dense(H * hd, d)}
    else:
        raise NotImplementedError(f"layer {spec} is not ported yet")
    if spec.ffn == "swiglu":
        ffn = _swiglu_shapes(d, cfg.d_ff)
    elif spec.ffn == "moe":
        m = cfg.moe
        ffn = {"router": ((d, m.n_experts), 0.02), "we1": _dense(m.n_experts, d, m.d_expert),
               "we3": _dense(m.n_experts, d, m.d_expert),
               "we2": _dense(m.n_experts, m.d_expert, d)}
        if m.n_shared:
            ffn["shared"] = _swiglu_shapes(d, m.n_shared * m.d_expert)
    else:
        raise NotImplementedError(f"layer {spec} is not ported yet")
    return {"norm1": ((d,), None), "mixer": mixer, "norm2": ((d,), None), "ffn": ffn}


def _tree_shapes(cfg: ArchConfig) -> dict:
    tree = {
        "embed": ((cfg.vocab, cfg.d_model), 0.02),
        "final_norm": ((cfg.d_model,), None),
        "blocks": tuple(_layer_shapes(cfg, spec) for spec in cfg.pattern),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((cfg.vocab, cfg.d_model), 0.02)
    for i, spec in enumerate(cfg.prefix):
        tree[f"prefix_{i}"] = _layer_shapes(cfg, spec)
    return tree


# per leaf of one layer, the dims that the reference's tensor-parallel
# layout (``repro.models.transformer.specs``) puts on its 'model' mesh axis:
# the column dim of the input projections (q/k/v, MLA's up-projections and
# queries, the FFNs'), the row dim of the output projections, the expert
# dim of the routed experts; none for MLA's down-projections and the router
_SWIGLU_MODEL_AXIS_DIMS = {"w1": (1,), "w3": (1,), "w2": (0,)}
_MIXER_MODEL_AXIS_DIMS = {
    "attn": {"wq": (1,), "wk": (1,), "wv": (1,), "wo": (0,)},
    "mla": {"w_dkv": (), "w_krope": (), "w_uk": (1,), "w_uv": (1,), "wq": (1,), "wo": (0,)}}


def _layer_model_axis_dims(cfg: ArchConfig, spec: LayerSpec) -> dict:
    if spec.ffn == "moe":
        ffn = {"router": (), "we1": (0,), "we3": (0,), "we2": (0,)}
        if cfg.moe.n_shared:
            ffn["shared"] = _SWIGLU_MODEL_AXIS_DIMS
    else:
        ffn = _SWIGLU_MODEL_AXIS_DIMS
    return {"norm1": (), "norm2": (), "mixer": _MIXER_MODEL_AXIS_DIMS[spec.mixer], "ffn": ffn}


def model_axis_dims(cfg: ArchConfig) -> dict:
    """The parameter tree of :func:`abstract_params` with, at each leaf, the
    tuple of dims the reference gives to its 'model' axis (the embedding's
    vocabulary rows; the blocks' dims shifted past the stacked one, the
    prefix layers' as they are).  The port runs no tensor parallelism, but
    FSDP leaves these dims alone as the reference does, so both shard the
    same dim of every leaf."""
    def stacked(dims):
        if isinstance(dims, dict):
            return {k: stacked(v) for k, v in dims.items()}
        return tuple(d + 1 for d in dims)

    tree = {"embed": (0,), "final_norm": (),
            "blocks": tuple(stacked(_layer_model_axis_dims(cfg, spec)) for spec in cfg.pattern)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (0,)
    for i, spec in enumerate(cfg.prefix):
        tree[f"prefix_{i}"] = _layer_model_axis_dims(cfg, spec)
    return tree


def tree_paths(tree, prefix: str = ""):
    """``(path, leaf)`` pairs in ``jax.tree_util.tree_leaves`` order (dict
    keys sorted, sequences in order); a leaf is anything that is not a dict
    and not a sequence of subtrees."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)) and tree and isinstance(tree[0], dict):
        for i, t in enumerate(tree):
            yield from tree_paths(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _map_paths(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path)``, paths as in
    :func:`tree_paths`."""
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and tree and isinstance(tree[0], dict):
        return tuple(_map_paths(t, fn, f"{prefix}{i}/") for i, t in enumerate(tree))
    return fn(prefix[:-1])


class Transformer(nn.Module):
    """Decoder over stacked layer parameters; ``forward`` returns the
    hidden states before the head, as the reference's ``forward``."""

    def __init__(self, cfg: ArchConfig, tensors: dict):
        super().__init__()
        self.cfg = cfg
        self.params = nn.ParameterDict()
        for path, _ in tree_paths(_tree_shapes(cfg)):
            self.params[path] = nn.Parameter(tensors[path])

    def leaves(self) -> list:
        """Parameters in the reference's ``tree_leaves`` order."""
        return list(self.params.values())

    def tree(self) -> dict:
        """The parameters, detached, as the reference's parameter tree
        (``{"blocks": ({...},), "embed", "final_norm"}``): its flatten order
        is :meth:`leaves`' and ``jax.tree_util``'s.  The leaves share the
        parameters' storage."""
        return _map_paths(_tree_shapes(self.cfg), lambda p: self.params[p].detach())

    def head(self) -> torch.Tensor:
        return self.params["embed" if self.cfg.tie_embeddings else "lm_head"]

    def _layer(self, pre: str, r: int | None, spec: LayerSpec, top: dict) -> dict:
        """One layer's parameters: the leaves under ``pre`` (``blocks/<pi>/``
        sliced at repeat ``r``, or ``prefix_<i>/`` whole, taken from ``top``
        where it holds them), as the tree of ``spec``'s leaves."""
        if r is None:
            get = lambda k: top.get(pre + k, self.params[pre + k])  # noqa: E731
        else:
            get = lambda k: self.params[pre + k][r]  # noqa: E731
        return _map_paths(_layer_shapes(self.cfg, spec), get)

    def ropes(self, positions: torch.Tensor) -> dict:
        """The RoPE tables (cos, sin) at ``positions`` (S,) that the layers
        take, by width: hd for attention, ``mla.rope_dim`` for MLA."""
        cfg = self.cfg
        mixers = {s.mixer for s in (*cfg.prefix, *cfg.pattern)}
        dims = {cfg.hd} if "attn" in mixers else set()
        if "mla" in mixers:
            dims.add(cfg.mla.rope_dim)
        return {d: L.rope_table(positions, d, cfg.rope_theta) for d in dims}

    def run_layers(self, h: torch.Tensor, positions: torch.Tensor, cache: dict | None = None,
                   cache_pos: int | None = None, *, top: dict | None = None,
                   block_param_fn=None, remat: bool = False):
        """Every layer over hidden states ``h`` (B, S, D) at ``positions``
        (S,), the prefix layers first, then the final norm.  ``top``:
        unstacked leaves by path (``final_norm``, ``prefix_<i>/...``) to use
        in place of the model's.  ``cache``/``cache_pos``: the KV cache
        written in place (see ``layers.attention`` and
        ``layers.mla_attention``).  ``block_param_fn(layer_params, index)``
        maps each layer's parameters before the layer runs, as the
        reference's hook: ``index`` is the pattern position of a stacked
        layer (its slice of the stacked leaves) and ``-i - 1`` for prefix
        layer ``i``; the FSDP step gathers stacked layers there.  ``remat``:
        each layer, hook included, runs under ``torch.utils.checkpoint``, so
        its backward recomputes it, gathers and all, as the reference's
        ``jax.checkpoint`` of its layer does."""
        cfg = self.cfg
        top = {} if top is None else top
        ropes = self.ropes(positions)
        layers = [(f"prefix_{i}/", None, -i - 1, spec, f"prefix_{i}")
                  for i, spec in enumerate(cfg.prefix)]
        layers += [(f"blocks/{pi}/", r, pi, spec, pi)
                   for r in range(cfg.repeats) for pi, spec in enumerate(cfg.pattern)]
        for pre, r, idx, spec, where in layers:
            kv = None
            if cache is not None:
                c = (cache[where] if r is None else cache["blocks"][where])["kv"]
                kv = c if r is None else {k: t[r] for k, t in c.items()}

            def layer(h, pre=pre, r=r, idx=idx, spec=spec, kv=kv):
                p = self._layer(pre, r, spec, top)
                if block_param_fn is not None:
                    p = block_param_fn(p, idx)
                x = L.rms_norm(h, p["norm1"], cfg.norm_eps)
                if spec.mixer == "mla":
                    h = h + L.mla_attention(p["mixer"], x, cfg, spec,
                                            *ropes[cfg.mla.rope_dim], kv, cache_pos)
                else:
                    h = h + L.attention(p["mixer"], x, cfg, spec, *ropes[cfg.hd], kv,
                                        cache_pos)
                x = L.rms_norm(h, p["norm2"], cfg.norm_eps)
                if spec.ffn == "moe":
                    return h + L.moe(p["ffn"], x, cfg)
                return h + L.swiglu(p["ffn"], x)

            # the layer draws no random numbers: no RNG state to keep
            h = (checkpoint(layer, h, use_reentrant=False, preserve_rng_state=False)
                 if remat else layer(h))
        return L.rms_norm(h, top.get("final_norm", self.params["final_norm"]),
                          cfg.norm_eps)

    def embed(self, tokens: torch.Tensor, vision_embeds: torch.Tensor | None = None,
              table: torch.Tensor | None = None) -> torch.Tensor:
        """Token embeddings (from ``table``, default the model's), with the
        VLM stub's ``vision_embeds`` (B, Sv, D) replacing the leading Sv
        positions."""
        h = torch.nn.functional.embedding(
            tokens, self.params["embed"] if table is None else table)
        if vision_embeds is not None:
            ve = vision_embeds.to(h.dtype)
            h = torch.cat([ve, h[:, ve.shape[1]:]], 1)
        return h

    def forward(self, tokens: torch.Tensor, *, vision_embeds: torch.Tensor | None = None,
                top: dict | None = None, block_param_fn=None,
                remat: bool = False) -> torch.Tensor:
        """Hidden states before the head.  ``top``: the unstacked leaves by
        path (``embed``, ``final_norm``, ``prefix_<i>/...``) to use in place
        of the model's, as the FSDP step passes them gathered;
        ``block_param_fn`` and ``remat`` as in :meth:`run_layers`."""
        cfg = self.cfg
        top = {} if top is None else top
        h = self.embed(tokens, vision_embeds, top.get("embed"))
        return self.run_layers(h, torch.arange(tokens.shape[1], device=tokens.device),
                               top=top, block_param_fn=block_param_fn, remat=remat)


def init(cfg: ArchConfig, *, generator: torch.Generator, device="cuda") -> Transformer:
    """Random initialisation with the reference's scales (normal * 0.02 for
    embeddings and the router, normal / sqrt(shape[0]) for dense layers and
    experts, ones for norms).
    Draws come from ``generator`` in parameter order, on the generator's
    device: a CPU generator gives the same weights on every device, a CUDA
    one draws a model of billions of parameters in seconds (with one f32
    temporary of its largest leaf on the card)."""
    dev = kernels.resolve_device(device)
    dt = codec.LAYOUTS[cfg.dtype].dtype
    tensors = {}
    for path, (shape, scale) in tree_paths(_tree_shapes(cfg)):
        if path.startswith("blocks/"):
            shape = (cfg.repeats,) + tuple(shape)
        if scale is None:
            t = torch.ones(shape, dtype=dt, device=dev)
        else:
            t = torch.randn(shape, generator=generator, device=generator.device)
            t = t.mul_(scale).to(device=dev, dtype=dt)
        tensors[path] = t
    return Transformer(cfg, tensors)


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    storage), block leaves stacked over repeats."""
    dt = codec.LAYOUTS[cfg.dtype].dtype
    shapes = dict(tree_paths(_tree_shapes(cfg)))

    def leaf(path):
        shape = tuple(shapes[path][0])
        if path.startswith("blocks/"):
            shape = (cfg.repeats,) + shape
        return torch.empty(shape, dtype=dt, device="meta")

    return _map_paths(_tree_shapes(cfg), leaf)


def numpy_to_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Bit-exact numpy -> torch for codec floats (numpy's bfloat16/fp8 come
    from ml_dtypes, which torch cannot read directly)."""
    a = np.ascontiguousarray(a)
    ints = {1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize]
    return torch.from_numpy(a.view(ints).copy()).view(dtype)


def load_reference_params(tree, cfg: ArchConfig, device="cuda") -> Transformer:
    """The port's model holding the reference's weights:
    ``tree = jax.tree_util.tree_map(np.asarray, repro...transformer.init(key,
    cfg))``."""
    dev = kernels.resolve_device(device)
    dt = codec.LAYOUTS[cfg.dtype].dtype
    tensors = {path: numpy_to_torch(a, dt).to(dev) for path, a in tree_paths(tree)}
    return Transformer(cfg, tensors)


# ---------------------------------------------------------------------------
# serving: KV cache, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> dict:
    """The reference's cache pytree: ``{"pos": int32 scalar, "prefix_<i>":
    {"kv": ...} per prefix layer, "blocks": ({"kv": ...},) per pattern
    position}``, zeros in the model dtype.  An attention layer's ``kv`` is
    ``{"k", "v"}`` of ``(batch, max_len, kv_heads, hd)``, an MLA layer's the
    latents ``{"c_kv": (batch, max_len, kv_lora), "k_rope": (batch,
    max_len, rope_dim)}``; a pattern position's leaves lead with
    ``repeats``."""
    dev = kernels.resolve_device(device)
    dt = codec.LAYOUTS[cfg.dtype].dtype

    def kv(spec, *lead):
        if spec.mixer == "mla":
            widths = {"c_kv": (cfg.mla.kv_lora,), "k_rope": (cfg.mla.rope_dim,)}
        else:
            widths = dict.fromkeys(("k", "v"), (cfg.kv_heads, cfg.hd))
        return {"kv": {k: torch.zeros((*lead, batch, max_len, *w), dtype=dt, device=dev)
                       for k, w in widths.items()}}

    cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    for i, spec in enumerate(cfg.prefix):
        cache[f"prefix_{i}"] = kv(spec)
    cache["blocks"] = tuple(kv(spec, cfg.repeats) for spec in cfg.pattern)
    return cache


def logits_from_hidden(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    return h @ model.head().T


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache: dict, *,
            vision_embeds: torch.Tensor | None = None) -> tuple:
    """Prefill forward over ``tokens`` (B, S), ``vision_embeds`` (B, Sv, D)
    replacing the leading positions if given: the causal forward that also
    fills the cache at positions [0, S).  The cache's K/V tensors are written
    in place; returns (last-position logits (B, 1, V), the cache with
    ``pos = S``).  The cache is what PD disaggregation ships."""
    S = tokens.shape[1]
    h = model.embed(tokens, vision_embeds)
    h = model.run_layers(h, torch.arange(S, device=tokens.device), cache)
    pos = torch.tensor(S, dtype=torch.int32, device=tokens.device)
    return logits_from_hidden(model, h[:, -1:]), dict(cache, pos=pos)


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor, cache: dict) -> tuple:
    """One decode step of tokens (B, 1) at the cache's ``pos`` (one position
    for the whole batch, as the reference).  K/V are written in place;
    returns (logits (B, 1, V), the cache with ``pos + 1``)."""
    pos = int(cache["pos"])
    h = model.embed(tokens)
    h = model.run_layers(h, torch.full((1,), pos, device=tokens.device), cache, pos)
    return logits_from_hidden(model, h), dict(cache, pos=cache["pos"] + 1)
