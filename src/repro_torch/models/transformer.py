"""Model stack (torch port of ``repro.models.transformer``): each decoder
layer's mixer is GQA attention, MLA, Mamba, mLSTM or sLSTM and its FFN
SwiGLU, MoE or none, as its ``LayerSpec`` says; an encoder-decoder model
(whisper) runs an encoder of attention + SwiGLU layers over the batch's
stubbed ``frames`` and a cross-attention over its output in every decoder
layer.

Parameters keep the reference's layout: the prefix layers ``prefix_<i>``
are unstacked and run first; per pattern position, every layer leaf is
STACKED over repeats (``(repeats, ...)``), and the encoder's leaves
(``enc_blocks/...``) over its layers.  The parameters are registered in
the order of the reference's ``jax.tree_util.tree_leaves`` (dict keys
sorted as strings: ``blocks/...``, ``embed``, ``enc_blocks/...``,
``enc_norm``, ``enc_pos``, ``final_norm``, ``lm_head``, then ``prefix_0``,
``prefix_1``, ``prefix_10``, ``prefix_2``, ...; in a layer ``cross``,
``ffn``, ``mixer``, ``norm1``, ``norm2``, ``normx``), named by their path in
the reference's tree (``blocks/0/ffn/w1``, ..., ``prefix_0/mixer/wq``), each
in the reference's dtype (the model's, f32 for Mamba's ``a_log``,
``d_skip`` and ``dt_bias``).  So the ZeRO-1 buckets of the port hold the
same bytes as ``zero1.flatten_buckets`` of the reference for the same
weights, and :func:`load_reference_params` carries weights across.  A
batch's ``vision_embeds`` (the VLM frontend stub) replace the leading
positions' token embeddings.

Serving state: attention and MLA layers keep a KV cache written at
positions; Mamba, mLSTM and sLSTM layers keep a recurrent state that each
call replaces, copied in place into the cache's tensors (their ``[r]``
slice for a stacked layer), so every cache leaf is written in place.  At a
'model' axis above 1 a rank serves on its blocks of the weights and holds
its block of the cache as ``serve/sharding.cache_specs`` lays out the
global one (:func:`init_cache` with ``mesh``): its ``max_len / n_model``
positions of every K/V or latent leaf (context-parallel), the recurrent
states whole.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels
from repro_torch.core import codec
from repro_torch.models import layers as L
from repro_torch.models import tp
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.tree_util import tree_map_up_to

# the encoder's layers (whisper): bidirectional attention, then SwiGLU
ENC_SPEC = LayerSpec(mixer="attn", ffn="swiglu")
# a leaf's init in a (shape, init) pair: a float scales a normal draw, None
# is ones, both in the model dtype; these f32 leaves (Mamba's) are drawn as
# the reference's: uniform * 2 + 0.5 (a_log), ones (d_skip), zeros (dt_bias)
F32_INITS = ("uniform", "ones", "zeros")
_RECURRENT = {"mamba": "ssm", "mlstm": "rnn", "slstm": "rnn"}


def _dense(*shape) -> tuple:
    """A dense leaf's (shape, init scale): 1/sqrt(shape[0]), the reference's
    ``_dense_init``; for the stacked experts (E, ., .) that is
    1/sqrt(n_experts), not the fan-in."""
    return shape, 1.0 / np.sqrt(shape[0])


def _swiglu_shapes(d: int, f: int) -> dict:
    return {"w1": _dense(d, f), "w3": _dense(d, f), "w2": _dense(f, d)}


def _attention_shapes(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.hd
    return {"wq": _dense(d, cfg.n_heads * hd), "wk": _dense(d, cfg.kv_heads * hd),
            "wv": _dense(d, cfg.kv_heads * hd), "wo": _dense(cfg.n_heads * hd, d)}


def _layer_shapes(cfg: ArchConfig, spec: LayerSpec, cross: bool | None = None) -> dict:
    """(shape, init) per leaf of one layer of ``spec`` (init as
    ``F32_INITS`` says: None = ones for the norms, 0.02 for the router and
    the xLSTM gates, 0.5 for Mamba's conv, :func:`_dense` else); ``cross``
    (default: the model is an encoder-decoder) adds ``normx`` and the
    cross-attention's ``cross``; a layer without an FFN has no ``norm2``."""
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    if spec.mixer == "attn":
        mixer = _attention_shapes(cfg)
    elif spec.mixer == "mla":
        m = cfg.mla
        mixer = {"w_dkv": _dense(d, m.kv_lora), "w_krope": _dense(d, m.rope_dim),
                 "w_uk": _dense(m.kv_lora, H * hd), "w_uv": _dense(m.kv_lora, H * hd),
                 "wq": _dense(d, H * (hd + m.rope_dim)), "wo": _dense(H * hd, d)}
    elif spec.mixer == "mamba":
        mc = cfg.mamba
        di = mc.expand * d
        mixer = {"in_proj": _dense(d, 2 * di), "conv_w": ((mc.d_conv, di), 0.5),
                 "w_bc_dt": _dense(di, 2 * mc.d_state + 1),
                 "a_log": ((di, mc.d_state), "uniform"), "d_skip": ((di,), "ones"),
                 "out_proj": _dense(di, d), "dt_bias": ((di,), "zeros")}
    elif spec.mixer in ("mlstm", "slstm"):
        mixer = dict(_attention_shapes(cfg), wi=((d, H), 0.02), wf=((d, H), 0.02))
    else:
        raise ValueError(spec.mixer)
    out = {"norm1": ((d,), None), "mixer": mixer}
    if cfg.enc_dec if cross is None else cross:
        out["normx"] = ((d,), None)
        out["cross"] = _attention_shapes(cfg)
    if spec.ffn == "none":
        return out
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
        raise ValueError(spec.ffn)
    return dict(out, norm2=((d,), None), ffn=ffn)


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
    if cfg.enc_dec:
        tree["enc_blocks"] = _layer_shapes(cfg, ENC_SPEC, cross=False)
        tree["enc_norm"] = ((cfg.d_model,), None)
        tree["enc_pos"] = ((cfg.enc_seq, cfg.d_model), 0.02)
    return tree


def _stacked(cfg: ArchConfig, path: str) -> tuple:
    """The leading dims a leaf at ``path`` carries: repeats for the pattern
    positions, the encoder's layers for its leaves, none else."""
    if path.startswith("blocks/"):
        return (cfg.repeats,)
    if path.startswith("enc_blocks/"):
        return (cfg.n_enc_layers,)
    return ()


def _leaf_dtype(cfg: ArchConfig, init) -> torch.dtype:
    return torch.float32 if init in F32_INITS else codec.LAYOUTS[cfg.dtype].dtype


def leaf_dtypes(cfg: ArchConfig) -> dict:
    """The dtype of every parameter leaf, by path."""
    return {path: _leaf_dtype(cfg, init) for path, (_, init) in tree_paths(_tree_shapes(cfg))}


def _spec_layer(cfg: ArchConfig, spec: LayerSpec, cross: bool) -> dict:
    """The tensor-parallel spec of every leaf of one layer (``layers.spec_*``)."""
    mixers = {"attn": L.spec_attention, "mla": L.spec_mla, "mamba": L.spec_mamba,
              "mlstm": L.spec_xlstm_full, "slstm": L.spec_xlstm_full}
    s = {"norm1": (None,), "mixer": mixers[spec.mixer](cfg)}
    if cross:
        s.update(normx=(None,), cross=L.spec_attention(cfg))
    if spec.ffn != "none":
        s.update(norm2=(None,), ffn=L.spec_moe(cfg) if spec.ffn == "moe" else L.spec_swiglu())
    return s


def _stack_specs(tree) -> dict:
    """A layer's specs with the stacked dim (replicated) in front."""
    return {k: _stack_specs(v) if isinstance(v, dict) else (None, *v) for k, v in tree.items()}


def specs(cfg: ArchConfig) -> dict:
    """The reference's tensor-parallel layout: the parameter tree of
    :func:`abstract_params` with a spec at each leaf (``launch/mesh``: one
    entry a dim), the embeddings' vocabulary rows on 'model', the stacked
    layers' leading dim replicated."""
    s = {"embed": ("model", None), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        s["lm_head"] = ("model", None)
    for i, spec in enumerate(cfg.prefix):
        s[f"prefix_{i}"] = _spec_layer(cfg, spec, cfg.enc_dec)
    s["blocks"] = tuple(_stack_specs(_spec_layer(cfg, spec, cfg.enc_dec))
                        for spec in cfg.pattern)
    if cfg.enc_dec:
        s.update(enc_blocks=_stack_specs(_spec_layer(cfg, ENC_SPEC, False)),
                 enc_norm=(None,), enc_pos=(None, None))
    return s


def model_axis_dims(cfg: ArchConfig) -> dict:
    """The parameter tree of :func:`abstract_params` with, at each leaf, the
    tuple of dims that :func:`specs` puts on the 'model' axis.  FSDP leaves
    these dims alone as the reference does, so both shard the same dim of
    every leaf."""
    return tree_map_up_to(lambda _, s: tuple(d for d, e in enumerate(s) if e == "model"),
                          abstract_params(cfg), specs(cfg))


def block_specs(cfg: ArchConfig, n_model: int) -> dict:
    """``{path: spec}`` of every leaf as a rank of a 'model' axis of
    ``n_model`` holds it: :func:`specs` with an entry dropped where its dim
    does not split into ``n_model`` blocks (the reference's
    ``sanitize_specs``; whisper's vocabulary of 51 865 stays whole)."""
    shapes = dict(tree_paths(abstract_params(cfg)))

    def keep(path, spec):
        return tuple(None if e is None or shapes[path].shape[d] % n_model else e
                     for d, e in enumerate(spec))

    return {path: keep(path, spec) for path, spec in tree_paths(specs(cfg))}


def check_model_parallel(cfg: ArchConfig, n_model: int) -> None:
    """Refuse a model the port cannot run with ``n_model`` > 1 ranks on
    'model': a layer leaf that the layout splits but whose dim does not
    divide (a layer split in part) raises ``NotImplementedError``.  Two
    kinds of leaf may stay whole: the vocabulary's rows (whisper's 51 865;
    the embedding and head then run replicated), and the xLSTM cells'
    gates ``wi``/``wf`` where there are fewer heads than ranks
    (``layers._xlstm_inputs`` then gathers the heads' columns)."""
    if n_model == 1:
        return
    kept = block_specs(cfg, n_model)
    for path, spec in tree_paths(specs(cfg)):
        whole_ok = path in ("embed", "lm_head") or path.endswith(("mixer/wi", "mixer/wf"))
        if not whole_ok and kept[path] != spec:
            raise NotImplementedError(f"{cfg.name} at model = {n_model}: {path} of "
                                      f"{spec} does not split into {n_model} blocks")


def _block(t: torch.Tensor, spec: tuple, mg) -> torch.Tensor:
    """This rank's block of a global leaf laid out by ``spec`` (its 'model'
    entries), a copy with storage of its own; the leaf itself without a
    model group."""
    if mg is None:
        return t
    for d, e in enumerate(spec):
        if e == "model":
            n = t.shape[d] // mg.size
            t = t.narrow(d, mg.rank * n, n)
    return t.clone(memory_format=torch.contiguous_format)


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
    """The model over stacked layer parameters; ``forward`` returns the
    hidden states before the head, as the reference's ``forward``.

    ``mg``: the model group (``models/tp``) of a rank of a 'model' axis
    above 1; ``tensors`` then hold this rank's block of every leaf
    (:func:`block_specs`), and the layers run tensor-parallel (attention,
    MLA, SwiGLU, Mamba over its inner channels, mLSTM and sLSTM over their
    heads) or expert-parallel (MoE), the embedding and the head
    vocabulary-parallel where the vocabulary splits (a batch's
    ``vision_embeds`` replace the leading positions after the embedding's
    sum over the group).

    ``dp``: ``(group, {path: dim})``, the leaves a serving layout also
    splits over the DP axes (``serve/sharding.serve_param_specs``), each
    held as this rank's block on ``dim`` and gathered over ``group`` (a
    ``tp.ModelGroup`` of the DP axes) in rank order where it is read
    (:meth:`weight`).  ``mesh``: the mesh the model was laid out on, or
    None."""

    def __init__(self, cfg: ArchConfig, tensors: dict, mg=None, *, dp=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mg = mg if tp.active(mg) else None
        if self.mg is not None:
            check_model_parallel(cfg, self.mg.size)
        self.dp_group, self.dp_dims = dp if dp is not None else (None, {})
        self.mesh = mesh
        self.params = nn.ParameterDict()
        for path, _ in tree_paths(_tree_shapes(cfg)):
            self.params[path] = nn.Parameter(tensors[path])

    def weight(self, path: str, r: int | None = None, top: dict | None = None) -> torch.Tensor:
        """The leaf at ``path`` (from ``top`` where it holds it), at repeat
        ``r`` of a stacked leaf; a leaf held split over the DP axes is
        gathered over them (:class:`Transformer`'s ``dp``)."""
        if top is not None and path in top:
            t = top[path]
            return t if r is None else t[r]
        t = self.params[path] if r is None else self.params[path][r]
        d = self.dp_dims.get(path)
        return t if d is None else tp.gather(t, self.dp_group, d - (r is not None))

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
        return self.weight("embed" if self.cfg.tie_embeddings else "lm_head")

    def vocab_group(self, table: torch.Tensor):
        """The model group when ``table`` (an embedding or head of this
        model's, or its gathered twin) holds a block of the vocabulary's
        rows, else None."""
        return self.mg if table.shape[0] != self.cfg.vocab else None

    def _layer(self, pre: str, r: int | None, spec: LayerSpec, top: dict,
               cross: bool | None = None) -> dict:
        """One layer's parameters: the leaves under ``pre`` (``blocks/<pi>/``
        or ``enc_blocks/`` sliced at repeat ``r``, or ``prefix_<i>/`` whole),
        taken from ``top`` where it holds them, as the tree of ``spec``'s
        leaves (``cross`` as in :func:`_layer_shapes`)."""
        return _map_paths(_layer_shapes(self.cfg, spec, cross),
                          lambda k: self.weight(pre + k, r, top))

    def ropes(self, positions: torch.Tensor) -> dict:
        """The RoPE tables (cos, sin) at ``positions`` (S,) that the layers
        take, by width: hd for attention, ``mla.rope_dim`` for MLA."""
        cfg = self.cfg
        mixers = {s.mixer for s in (*cfg.prefix, *cfg.pattern)}
        dims = {cfg.hd} if "attn" in mixers else set()
        if "mla" in mixers:
            dims.add(cfg.mla.rope_dim)
        return {d: L.rope_table(positions, d, cfg.rope_theta) for d in dims}

    def run_encoder(self, frames: torch.Tensor, *, top: dict | None = None,
                    remat: bool = False) -> torch.Tensor:
        """The encoder (the reference's ``_run_encoder``) over stubbed frame
        embeddings (B, T, D): plus ``enc_pos``, then per layer the
        bidirectional attention of each position over all of them
        (``kv_src``: the layer's own K/V) and SwiGLU, then
        ``enc_norm``.  ``top`` and ``remat`` as in :meth:`run_layers`."""
        cfg = self.cfg
        top = {} if top is None else top
        enc_pos = self.weight("enc_pos", top=top)
        h = frames.to(enc_pos.dtype) + enc_pos[None, :frames.shape[1]]
        for r in range(cfg.n_enc_layers):
            def layer(h, r=r):
                p = self._layer("enc_blocks/", r, ENC_SPEC, top, cross=False)
                x = L.rms_norm(h, p["norm1"], cfg.norm_eps)
                h = h + L.attention(p["mixer"], x, cfg, ENC_SPEC, None, None, kv_src=x,
                                    mg=self.mg)
                return h + L.swiglu(p["ffn"], L.rms_norm(h, p["norm2"], cfg.norm_eps), self.mg)

            h = (checkpoint(layer, h, use_reentrant=False, preserve_rng_state=False)
                 if remat else layer(h))
        return L.rms_norm(h, self.weight("enc_norm", top=top), cfg.norm_eps)

    def run_layers(self, h: torch.Tensor, positions: torch.Tensor, cache: dict | None = None,
                   cache_pos: int | None = None, *, enc_out: torch.Tensor | None = None,
                   top: dict | None = None, block_param_fn=None, remat: bool = False):
        """Every decoder layer over hidden states ``h`` (B, S, D) at
        ``positions`` (S,), the prefix layers first, then the final norm.
        ``top``: unstacked leaves by path (``final_norm``, ``prefix_<i>/...``,
        the encoder's) to use in place of the model's.  ``cache``/
        ``cache_pos``: the serving state, written in place: an attention or
        MLA layer's KV (see ``layers.attention`` and
        ``layers.mla_attention``); a recurrent layer's state, which prefill
        (``cache_pos`` None) computes from zeros and decode reads, both
        copying the new state into the cache's tensors.  ``enc_out`` (B, T,
        D), the encoder's output: each layer with a ``cross`` attends over
        it after its mixer, its K/V projected inside the layer.
        ``block_param_fn(layer_params, index)`` maps each layer's parameters
        before the layer runs, as the reference's hook: ``index`` is the
        pattern position of a stacked layer (its slice of the stacked
        leaves) and ``-i - 1`` for prefix layer ``i``; the FSDP step gathers
        stacked layers there.  ``remat``: each layer, hook included, runs
        under ``torch.utils.checkpoint``, so its backward recomputes it,
        gathers and all, as the reference's ``jax.checkpoint`` of its layer
        does."""
        cfg = self.cfg
        top = {} if top is None else top
        ropes = self.ropes(positions)
        layers = [(f"prefix_{i}/", None, -i - 1, spec, f"prefix_{i}")
                  for i, spec in enumerate(cfg.prefix)]
        layers += [(f"blocks/{pi}/", r, pi, spec, pi)
                   for r in range(cfg.repeats) for pi, spec in enumerate(cfg.pattern)]
        for pre, r, idx, spec, where in layers:
            st = None
            if cache is not None:
                c = cache[where] if r is None else cache["blocks"][where]
                c = c[_RECURRENT.get(spec.mixer, "kv")]
                st = c if r is None else {k: t[r] for k, t in c.items()}

            def layer(h, pre=pre, r=r, idx=idx, spec=spec, st=st):
                p = self._layer(pre, r, spec, top)
                if block_param_fn is not None:
                    p = block_param_fn(p, idx)
                x = L.rms_norm(h, p["norm1"], cfg.norm_eps)
                if spec.mixer == "mla":
                    out = L.mla_attention(p["mixer"], x, cfg, spec, *ropes[cfg.mla.rope_dim],
                                          st, cache_pos, mg=self.mg)
                elif spec.mixer == "attn":
                    out = L.attention(p["mixer"], x, cfg, spec, *ropes[cfg.hd], st, cache_pos,
                                      mg=self.mg)
                else:
                    prev = st if cache_pos is not None else None
                    if spec.mixer == "mamba":
                        out, new = L.mamba(p["mixer"], x, cfg, state=prev,
                                           return_state=st is not None, mg=self.mg)
                    else:
                        out, new = getattr(L, spec.mixer)(p["mixer"], x, cfg, state=prev,
                                                          mg=self.mg, serve=st is not None)
                    if st is not None:  # the state replaced, in place
                        for k, t in st.items():
                            t.copy_(new[k])
                h = h + out
                if enc_out is not None and "cross" in p:
                    h = h + L.attention(p["cross"], L.rms_norm(h, p["normx"], cfg.norm_eps),
                                        cfg, spec, None, None, kv_src=enc_out, mg=self.mg)
                if spec.ffn == "none":
                    return h
                x = L.rms_norm(h, p["norm2"], cfg.norm_eps)
                if spec.ffn == "moe":
                    return h + L.moe(p["ffn"], x, cfg, mg=self.mg)
                return h + L.swiglu(p["ffn"], x, self.mg)

            # the layer draws no random numbers: no RNG state to keep
            h = (checkpoint(layer, h, use_reentrant=False, preserve_rng_state=False)
                 if remat else layer(h))
        return L.rms_norm(h, self.weight("final_norm", top=top), cfg.norm_eps)

    def embed(self, tokens: torch.Tensor, vision_embeds: torch.Tensor | None = None,
              table: torch.Tensor | None = None) -> torch.Tensor:
        """Token embeddings (from ``table``, default the model's), with the
        VLM stub's ``vision_embeds`` (B, Sv, D) replacing the leading Sv
        positions.  A table of this rank's block of the vocabulary looks up
        vocabulary-parallel (``tp.vocab_embed``)."""
        table = self.weight("embed") if table is None else table
        h = tp.vocab_embed(tokens, table, self.vocab_group(table))
        if vision_embeds is not None:
            ve = vision_embeds.to(h.dtype)
            h = torch.cat([ve, h[:, ve.shape[1]:]], 1)
        return h

    def encode(self, frames: torch.Tensor | None, **kw) -> torch.Tensor | None:
        """:meth:`run_encoder` of an encoder-decoder model (which needs
        ``frames``), None for any other."""
        if not self.cfg.enc_dec:
            return None
        if frames is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder model: its batch "
                             f"needs 'frames' (B, {self.cfg.enc_seq}, {self.cfg.d_model})")
        return self.run_encoder(frames, **kw)

    def forward(self, tokens: torch.Tensor, *, vision_embeds: torch.Tensor | None = None,
                frames: torch.Tensor | None = None, top: dict | None = None,
                block_param_fn=None, remat: bool = False) -> torch.Tensor:
        """Hidden states before the head.  ``frames``: an encoder-decoder
        model's stubbed frame embeddings (B, T, D).  ``top``: the unstacked
        leaves by path (``embed``, ``final_norm``, ``prefix_<i>/...``, the
        encoder's) to use in place of the model's, as the FSDP step passes
        them gathered; ``block_param_fn`` and ``remat`` as in
        :meth:`run_layers`."""
        top = {} if top is None else top
        enc_out = self.encode(frames, top=top, remat=remat)
        h = self.embed(tokens, vision_embeds, top.get("embed"))
        return self.run_layers(h, torch.arange(tokens.shape[1], device=tokens.device),
                               enc_out=enc_out, top=top, block_param_fn=block_param_fn,
                               remat=remat)


def _draw(shape, init, dt, generator, dev) -> torch.Tensor:
    if init is None or init == "ones":
        return torch.ones(shape, dtype=dt, device=dev)
    if init == "zeros":
        return torch.zeros(shape, dtype=dt, device=dev)
    if init == "uniform":
        t = torch.rand(shape, generator=generator, device=generator.device).mul_(2).add_(0.5)
    else:
        t = torch.randn(shape, generator=generator, device=generator.device).mul_(init)
    return t.to(device=dev, dtype=dt)


def init(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
         mesh=None, param_specs=None) -> Transformer:
    """Random initialisation with the reference's scales (normal * 0.02 for
    embeddings, the encoder's positions, the router and the xLSTM gates,
    normal * 0.5 for Mamba's conv, normal / sqrt(shape[0]) for dense layers
    and experts, ones for norms; Mamba's f32 ``a_log`` uniform * 2 + 0.5,
    ``d_skip`` ones, ``dt_bias`` zeros).
    Draws come from ``generator`` in parameter order, on the generator's
    device: a CPU generator gives the same weights on every device, a CUDA
    one draws a model of billions of parameters in seconds (with one f32
    temporary of its largest leaf on the card).

    ``mesh``: a mesh whose 'model' axis is above 1 keeps this rank's block
    of each leaf (:func:`block_specs`), drawn whole as on one rank, so the
    blocks of the ranks join to the one-rank init bit for bit.
    ``param_specs``: a serving layout of the parameters on ``mesh``
    (``serve/sharding.serve_param_specs``), whose leaves may also split
    over the DP axes: the rank keeps its block of each leaf by it."""
    dev = kernels.resolve_device(device)
    block, kw = _layout(cfg, mesh, param_specs)
    tensors = {}
    for path, (shape, init) in tree_paths(_tree_shapes(cfg)):
        t = _draw(_stacked(cfg, path) + tuple(shape), init, _leaf_dtype(cfg, init),
                  generator, dev)
        tensors[path] = block(path, t)
    return Transformer(cfg, tensors, **kw)


def _layout(cfg: ArchConfig, mesh, param_specs) -> tuple:
    """``(block, kwargs)``: ``block(path, t)`` is this rank's block of the
    global leaf ``t`` at ``path`` (a copy with storage of its own where it
    is a part), by :func:`block_specs` on the mesh's 'model' axis, or by
    ``param_specs`` (model and DP entries) where given; ``kwargs`` the
    :class:`Transformer`'s ``mg``, ``dp`` and ``mesh``."""
    from repro_torch.launch import mesh as mesh_lib

    mg = tp.model_group(mesh)
    if param_specs is None:
        kept = block_specs(cfg, mg.size) if mg else {}
        return (lambda path, t: _block(t, kept.get(path, ()), mg)), dict(mg=mg, mesh=mesh)
    specs = dict(tree_paths(param_specs))
    dims = {path: d for path, s in specs.items() for d, e in enumerate(s)
            if e is not None and e != "model" and mesh_lib.entry_size(e, mesh) > 1}
    group = None
    if dims:
        from repro_torch.train.step import dp_axes_of

        group = tp.ModelGroup(mesh_lib.axis_group(mesh, dp_axes_of(mesh)))

    def block(path, t):
        b = mesh_lib.block_of(t, specs[path], mesh)
        return b if b.shape == t.shape else b.clone(memory_format=torch.contiguous_format)

    return block, dict(mg=mg, dp=(group, dims), mesh=mesh)


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    storage), stacked leaves with their leading dim."""
    shapes = dict(tree_paths(_tree_shapes(cfg)))

    def leaf(path):
        shape, init = shapes[path]
        return torch.empty(_stacked(cfg, path) + tuple(shape), dtype=_leaf_dtype(cfg, init),
                           device="meta")

    return _map_paths(_tree_shapes(cfg), leaf)


def numpy_to_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Bit-exact numpy -> torch for codec floats (numpy's bfloat16/fp8 come
    from ml_dtypes, which torch cannot read directly).  The array's items
    must be ``dtype``'s width: its bits are reinterpreted, not converted."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize != dtype.itemsize:
        raise ValueError(f"a {a.dtype} array cannot hold the bits of {dtype}")
    ints = {1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize]
    return torch.from_numpy(a.view(ints).copy()).view(dtype)


def load_reference_params(tree, cfg: ArchConfig, device="cuda", mesh=None) -> Transformer:
    """The port's model holding the reference's weights:
    ``tree = jax.tree_util.tree_map(np.asarray, repro...transformer.init(key,
    cfg))``; each leaf in its own dtype (:func:`leaf_dtypes`).  ``mesh``
    as in :func:`init`: this rank's block of each global leaf."""
    dev = kernels.resolve_device(device)
    dts = leaf_dtypes(cfg)
    block, kw = _layout(cfg, mesh, None)
    tensors = {path: block(path, numpy_to_torch(a, dts[path])).to(dev)
               for path, a in tree_paths(tree)}
    return Transformer(cfg, tensors, **kw)


# ---------------------------------------------------------------------------
# serving: KV cache and recurrent state, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda", *,
               cp_shards: int = 1, mesh=None) -> dict:
    """The reference's cache pytree: ``{"pos": int32 scalar, "prefix_<i>":
    {...} per prefix layer, "blocks": ({...},) per pattern position}``; a
    pattern position's leaves lead with ``repeats``.  By mixer: attention's
    ``{"kv": {"k", "v"}}`` of ``(batch, s_loc, kv_heads, hd)``, MLA's
    latents ``{"kv": {"c_kv": (batch, s_loc, kv_lora), "k_rope": (batch,
    s_loc, rope_dim)}}``, zeros in the model dtype; Mamba's ``{"ssm":
    {"h": (batch, di, d_state) f32, "conv": (batch, d_conv - 1, di)}}``,
    mLSTM's ``{"rnn": {"C": (batch, H, hd, hd), "n": (batch, H, hd), "m":
    (batch, H)}}`` and sLSTM's ``{"rnn": {"c": (batch, H, hd), "n", "m":
    (batch, H)}}``, f32 but ``conv`` (the model dtype), zeros but ``m``
    (-1e30).  ``s_loc = max_len // cp_shards``: the positions one shard of
    a context-parallel cache holds (the reference's ``cp_shards``).

    ``mesh``: this rank's block of the global cache of ``batch`` rows as
    ``serve/sharding.cache_specs`` lays it out (:func:`cache_block`)."""
    dev = kernels.resolve_device(device)
    if mesh is not None:
        return _cache_tree(cfg, *cache_block(cfg, batch, max_len, mesh), dev)
    return _cache_tree(cfg, batch, max_len // cp_shards, dev)


def cache_struct(cfg: ArchConfig, batch: int, max_len: int, *, cp_shards: int = 1,
                 mesh=None) -> dict:
    """:func:`init_cache`'s tree as ``meta`` tensors (no storage)."""
    if mesh is not None:
        return _cache_tree(cfg, *cache_block(cfg, batch, max_len, mesh), torch.device("meta"))
    return _cache_tree(cfg, batch, max_len // cp_shards, torch.device("meta"))


def cache_block(cfg: ArchConfig, batch: int, max_len: int, mesh) -> tuple:
    """``(rows, s_loc)`` of this rank's block of the global cache of
    ``batch`` rows and ``max_len`` positions as ``serve/sharding.
    cache_specs`` lays it out on ``mesh``: ``batch / n_dp`` rows (the
    rank's pod-major DP index holds rows ``[i rows, (i + 1) rows)``), or
    every row where the DP size does not divide the batch (the specs
    replicate it: each DP rank holds and computes every row, as GSPMD runs
    a replicated dim), and, at model index ``r``, positions ``[r s_loc,
    (r + 1) s_loc)`` of every K/V or latent leaf, ``s_loc = max_len /
    n_model``; every KV head and the whole latent; the recurrent states
    whole on every model rank, as the specs replicate them.  Raises
    ValueError where the specs lay the cache out otherwise: a ``max_len``
    they leave whole, or a recurrent leaf they split over 'model' because
    one of its widths equals ``max_len`` (the reference would split that
    state; the port keeps states whole)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve.sharding import cache_specs

    specs, struct = cache_specs(cfg, mesh, batch, max_len)
    n_dp, n_model = mesh_lib.dp_size(mesh), mesh_lib.axis_sizes(mesh)["model"]
    leaves = dict(tree_paths(struct))
    if max_len % n_model:
        raise ValueError(f"{cfg.name}: a cache of {max_len} positions does not split into "
                         f"{n_model} model blocks of positions")
    rows, s_loc = (batch if batch % n_dp else batch // n_dp), max_len // n_model
    block = dict(tree_paths(_cache_tree(cfg, rows, s_loc, torch.device("meta"))))
    for path, spec in tree_paths(specs):
        shape = tuple(leaves[path].shape)
        if n_model > 1 and "/kv/" not in path and "model" in spec:
            d = spec.index("model")
            raise ValueError(f"{cfg.name}: cache_specs splits the recurrent state {path} "
                             f"{shape} over 'model' on dim {d}, whose width {shape[d]} "
                             f"equals max_len; the port keeps recurrent states whole on "
                             f"every model rank (pick another max_len)")
        want = mesh_lib.shard_shape(shape, spec, mesh)
        if tuple(block[path].shape) != want:
            raise ValueError(f"{cfg.name}: cache leaf {path} {shape} is laid out as "
                             f"{want} a rank by {spec}, not as the port's block "
                             f"{tuple(block[path].shape)}")
    return rows, s_loc


def _cache_tree(cfg: ArchConfig, batch: int, s_loc: int, dev: torch.device) -> dict:
    dt = codec.LAYOUTS[cfg.dtype].dtype
    f32 = torch.float32
    H, hd = cfg.n_heads, cfg.hd

    def layer(spec, *lead):
        def z(*shape, dtype=f32, fill=0.0):
            return torch.full((*lead, batch, *shape), fill, dtype=dtype, device=dev)

        if spec.mixer == "mamba":
            di = cfg.mamba.expand * cfg.d_model
            return {"ssm": {"h": z(di, cfg.mamba.d_state),
                            "conv": z(cfg.mamba.d_conv - 1, di, dtype=dt)}}
        if spec.mixer == "mlstm":
            return {"rnn": {"C": z(H, hd, hd), "n": z(H, hd), "m": z(H, fill=-1e30)}}
        if spec.mixer == "slstm":
            return {"rnn": {"c": z(H, hd), "n": z(H), "m": z(H, fill=-1e30)}}
        if spec.mixer == "mla":
            widths = {"c_kv": (cfg.mla.kv_lora,), "k_rope": (cfg.mla.rope_dim,)}
        else:
            widths = dict.fromkeys(("k", "v"), (cfg.kv_heads, cfg.hd))
        return {"kv": {k: z(s_loc, *w, dtype=dt) for k, w in widths.items()}}

    cache = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    for i, spec in enumerate(cfg.prefix):
        cache[f"prefix_{i}"] = layer(spec)
    cache["blocks"] = tuple(layer(spec, cfg.repeats) for spec in cfg.pattern)
    return cache


def logits_from_hidden(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    """Logits of hidden states ``h``: over this rank's block of the
    vocabulary where the head holds one (its input entering through
    ``tp.copy``, so its gradient sums over the model group)."""
    head = model.head()
    return tp.copy(h, model.vocab_group(head)) @ head.T


def _whole_logits(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    """Logits over the whole vocabulary: a vocabulary-parallel head's
    blocks gathered over the model group in rank order, the same bits on
    every rank."""
    head = model.head()
    return tp.gather(h @ head.T, model.vocab_group(head), -1)


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache: dict, *,
            vision_embeds: torch.Tensor | None = None,
            frames: torch.Tensor | None = None) -> tuple:
    """Prefill forward over ``tokens`` (B, S), ``vision_embeds`` (B, Sv, D)
    replacing the leading positions if given, an encoder-decoder model's
    ``frames`` (B, T, D) through the encoder: the causal forward that also
    fills the cache (K/V at positions [0, S), each recurrent layer's state
    after the last position), in place; returns (last-position logits (B,
    1, V), the cache with ``pos = S``).  The cache is what PD
    disaggregation ships; an encoder-decoder model's decode steps take the
    encoder's output again (:meth:`Transformer.encode`).

    At a model group the rank runs on its blocks and ``cache`` is its
    block (:func:`init_cache` with ``mesh``): each layer writes the
    positions of [0, S) its block holds (a prompt may be longer than a
    block), and the logits are gathered whole on every rank."""
    S = tokens.shape[1]
    enc_out = model.encode(frames)
    h = model.embed(tokens, vision_embeds)
    h = model.run_layers(h, torch.arange(S, device=tokens.device), cache, enc_out=enc_out)
    pos = torch.tensor(S, dtype=torch.int32, device=tokens.device)
    return _whole_logits(model, h[:, -1:]), dict(cache, pos=pos)


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor, cache: dict, *,
                enc_out: torch.Tensor | None = None) -> tuple:
    """One decode step of tokens (B, 1) at the cache's ``pos`` (one position
    for the whole batch, as the reference).  K/V and recurrent states are
    written in place; ``enc_out`` (B, T, D), the encoder's output, feeds
    the cross-attention, whose K/V are projected anew every step (as the
    reference's); without it a decoder layer skips its cross-attention,
    as the reference's does.  Returns (logits (B, 1, V), the cache with
    ``pos + 1``).  At a model group as :func:`prefill`: the rank whose
    block holds ``pos`` writes its K/V, and attention combines the ranks'
    partial softmaxes (``layers._decode_attend``)."""
    pos = kernels.host_int(cache["pos"])
    h = model.embed(tokens)
    h = model.run_layers(h, torch.full((1,), pos, device=tokens.device), cache, pos,
                         enc_out=enc_out)
    return _whole_logits(model, h), dict(cache, pos=cache["pos"] + 1)
