"""Serving at model > 1 (``prefill``/``decode_step`` on a rank's blocks of
the weights and of the KV cache) held against the port at model = 1 and
against the JAX reference: the reference on 4 forced host devices in one
subprocess a mesh (:func:`run_mesh_serve_reference`), the port on 4 gloo
ranks (:func:`mesh_serve_rank`); the test files ``test_torch_mesh_serve*``
compare what both save.

Every arch runs its SMOKE config as the TP tests take it
(``torch_port_util.tp_configs``: deepseek-v2-lite and jamba in f32, jamba
cut to (Mamba, MoE) then (attention, SwiGLU)), with weights drawn by the
port from seed 0 (carried into the reference as its numpy tree), a batch
of ``registry.make_batch`` (seed 0) of SERVE_BATCH rows and SERVE_PROMPT
positions, then SERVE_STEPS decode steps fed the same seeded tokens in
both packages.  The cache holds SERVE_MAX_LEN positions, so a rank's
block holds 8 at (2, 2) and 4 at (1, 4): the prompt is shorter than a
block at (2, 2) and longer at (1, 4), and the decode steps cross a block
boundary at both.  The port against itself takes prompts of
SERVE_PROMPTS_F32 positions too, in f32.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from torch_port_util import tp_configs

SERVE_ARCHS = ("tinyllama_1_1b", "gemma3_27b", "deepseek_v2_lite_16b", "jamba_v0_1_52b",
               "xlstm_350m", "whisper_small")
# kind -> (mesh shape, whether the reference also runs its GSPMD form there)
SERVE_MESHES = {"serve": ((2, 2), True), "serve_heads": ((1, 4), False)}
AXES = ("data", "model")
SERVE_BATCH, SERVE_MAX_LEN, SERVE_PROMPT, SERVE_STEPS = 4, 16, 6, 4
SERVE_PROMPTS_F32 = (3, 10)  # 3: shorter than a block at both meshes; 10: longer
# serve_param_specs' threshold in both packages at (2, 2): a leaf of 8 KiB
# or more a model shard is also split over 'data' (the embeddings, the
# head, the experts, the FFN's stacked leaves), gathered at its use
SERVE_DP_BYTES = 8 << 10
MLA_MAX_LEN, MLA_STEPS = 8, 8  # the cp_axis MLA case: 2 shards of 4 positions


def serve_tokens(cfg, seed: int = 7) -> np.ndarray:
    """The decode steps' input tokens, (SERVE_STEPS, SERVE_BATCH, 1)."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (SERVE_STEPS, SERVE_BATCH, 1)).astype(np.int32)


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def port_weights(cfg, **kw):
    """The port's model of ``cfg`` from seed 0 (``kw``: ``mesh``,
    ``param_specs``)."""
    import torch

    from repro_torch.models import transformer

    return transformer.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu", **kw)


def cache_paths(tree) -> dict:
    from repro_torch.models import transformer

    return dict(transformer.tree_paths(tree))


def _mla_layer(cfg):
    """deepseek-v2-lite SMOKE's first MLA layer's weights (f32), from the
    port's seed-0 draw, by leaf name."""
    model = port_weights(cfg)
    return {k: model.params[f"prefix_0/mixer/{k}"].detach() for k in
            ("w_dkv", "w_krope", "w_uk", "w_uv", "wq", "wo")}


def _mla_x(cfg) -> np.ndarray:
    return np.random.default_rng(11).normal(0, 1, (2, MLA_STEPS, cfg.d_model)).astype(np.float32)


def serve_one_rank(arch: str) -> dict:
    """The port at model = 1 in f32 over the whole batch, for each prompt
    of SERVE_PROMPTS_F32: ``{arch}_f32_{S}_one_logits``, ``_one_tokens``
    and ``_one_cache/<path>``, the held values of
    ``test_serve_blocks_match_the_port_at_model_1``."""
    import torch

    from repro_torch.models import registry, transformer

    cfg = f32(tp_configs(arch)[0])
    toks = torch.from_numpy(serve_tokens(cfg))
    res = {}
    for S in SERVE_PROMPTS_F32:
        batch = registry.make_batch(cfg, SERVE_BATCH, S, rng=np.random.default_rng(0),
                                    device="cpu")
        batch.pop("labels")
        lg, cache, tokens = _serve(port_weights(cfg), cfg, batch, toks,
                                   transformer.init_cache(cfg, SERVE_BATCH, SERVE_MAX_LEN, "cpu"))
        pre = f"{arch}_f32_{S}_one"
        res[f"{pre}_logits"], res[f"{pre}_tokens"] = lg, tokens
        res.update({f"{pre}_cache/{p}": a for p, a in _flat(cache).items()})
    return res


def mesh_serve_reference(kind: str, out_dir: str) -> None:
    """The reference's side of ``SERVE_MESHES[kind]`` in a process with 4
    forced host devices, and the port at model = 1 (:func:`serve_one_rank`).
    Per arch: the reference's one-device ``prefill`` and
    ``decode_step`` (jitted) over the batch and the tokens, every step's
    logits and the final global cache; where the kind says so, the same
    jitted over the mesh (GSPMD), its parameters laid out by
    ``serve_param_specs(shard_over_dp_bytes=SERVE_DP_BYTES)``, its cache
    and the decode steps' cache by ``cache_specs``, its batch rows over
    'data': the logits and each device's shard of the final cache.  On the
    (2, 2) kind also deepseek-v2-lite's MLA layer decoded one token at a
    time into an MLA_MAX_LEN-position cache on one device and under
    ``shard_map`` with ``cp_axis`` over 2 devices.  Arrays in
    ``out_dir/ref.npz``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.launch.mesh import make_mesh
    from repro.models import layers as jL
    from repro.models import registry as jregistry
    from repro.models import transformer as jt
    from repro.models.config import LayerSpec as JLayerSpec
    from repro.serve import sharding as jsharding
    from repro_torch.tree_util import tree_map
    from torch_port_util import ref_array

    shape, gspmd = SERVE_MESHES[kind]
    mesh = make_mesh(shape, AXES)
    devs = list(mesh.devices.flat)
    prefill = jax.jit(jt.prefill, static_argnums=2)
    decode = jax.jit(jt.decode_step, static_argnums=3)
    encode = jax.jit(lambda p, f, cfg: jt._run_encoder(p, f, cfg), static_argnums=2)
    res = {}
    for arch in SERVE_ARCHS:
        res.update(serve_one_rank(arch))
        cfg, jcfg = tp_configs(arch)
        params = jax.tree_util.tree_map(jnp.asarray,
                                        tree_map(ref_array, port_weights(cfg).tree()))
        batch = {k: jnp.asarray(v) for k, v in jregistry.make_batch(
            jcfg, SERVE_BATCH, SERVE_PROMPT, rng=np.random.default_rng(0)).items()
            if k != "labels"}
        toks = serve_tokens(jcfg)
        forms = [("one", lambda t: t, lambda t, s: t)]
        if gspmd:
            pspecs = jsharding.serve_param_specs(jcfg, mesh, shard_over_dp_bytes=SERVE_DP_BYTES)
            cspecs, _ = jsharding.cache_specs(jcfg, mesh, SERVE_BATCH, SERVE_MAX_LEN)

            def put(tree, specs):
                return jax.tree_util.tree_map(
                    lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)

            def rows(x):
                return jax.device_put(x, NamedSharding(mesh, P("data", *(None,) * (x.ndim - 1))))

            forms.append(("gspmd", rows, put))
            params_g = put(params, pspecs)
        for form, rows_of, put_of in forms:
            p = params if form == "one" else params_g
            lay = (lambda c: c) if form == "one" else (lambda c: put_of(c, cspecs))
            cache = lay(jt.init_cache(jcfg, SERVE_BATCH, SERVE_MAX_LEN))
            logits, cache = prefill(p, {k: rows_of(v) for k, v in batch.items()}, jcfg, cache)
            enc = encode(p, rows_of(batch["frames"]), jcfg) if jcfg.enc_dec else None
            out = [logits]
            for t in toks:
                logits, cache = decode(p, rows_of(jnp.asarray(t)), lay(cache), jcfg,
                                       enc_out=enc)
                out.append(logits)
            res[f"{arch}_{form}_logits"] = np.concatenate(
                [np.asarray(o.astype(jnp.float32)) for o in out], 1)
            flat = jax.tree_util.tree_flatten_with_path(lay(cache))[0]
            for k, leaf in flat:
                path = jax.tree_util.keystr(k, simple=True, separator="/")
                if form == "one":
                    res[f"{arch}_one_cache/{path}"] = np.asarray(leaf.astype(jnp.float32))
                    continue
                for sh in leaf.addressable_shards:
                    res[f"{arch}_gspmd_cache/{path}/{devs.index(sh.device)}"] = np.asarray(
                        sh.data.astype(jnp.float32))
    if kind == "serve":  # the reference's cp_axis MLA decode against its own on one device
        pcfg, cfg = (f32(c) for c in tp_configs("deepseek_v2_lite_16b"))
        lp = {k: jnp.asarray(v.numpy()) for k, v in _mla_layer(pcfg).items()}
        x = jnp.asarray(_mla_x(cfg))
        spec = JLayerSpec(mixer="mla", ffn="moe")
        cpm = jax.make_mesh((2,), ("cp",), devices=devs[:2],
                            axis_types=(jax.sharding.AxisType.Auto,))

        def step(cache, xt, pos, cp_axis=None):
            return jL.mla_attention(lp, xt, cfg, spec=spec, positions=jnp.full((2, 1), pos),
                                    cache=cache, cache_pos=pos, cp_axis=cp_axis)

        sharded = jax.jit(jax.shard_map(
            lambda c, xt, pos: step(c, xt, pos, "cp"), mesh=cpm,
            in_specs=(P(None, "cp"), P(), P()), out_specs=(P(), P(None, "cp")),
            axis_names={"cp"}, check_vma=False))
        one = jax.jit(step)
        zeros = {"c_kv": jnp.zeros((2, MLA_MAX_LEN, cfg.mla.kv_lora)),
                 "k_rope": jnp.zeros((2, MLA_MAX_LEN, cfg.mla.rope_dim))}
        c1, cs, gaps = zeros, zeros, []
        for pos in range(MLA_STEPS):
            xt = x[:, pos:pos + 1]
            o1, c1 = one(c1, xt, pos)
            o2, cs = sharded(cs, xt, jnp.int32(pos))
            gaps.append(float(jnp.max(jnp.abs(o1 - o2))))
        res["mla_cp_gaps"] = np.array(gaps)
    np.savez(os.path.join(out_dir, "ref.npz"), **res)


def run_mesh_serve_reference(kind: str, out_dir) -> dict:
    """:func:`mesh_serve_reference` in a subprocess with 4 forced host
    devices; returns its ``ref.npz``."""
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([src, here, os.environ.get("PYTHONPATH", "")]))
    code = (f"import torch_mesh_serve_util as u; "
            f"u.mesh_serve_reference({kind!r}, {str(out_dir)!r})")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(os.path.join(str(out_dir), "ref.npz")))


def _serve(model, cfg, batch: dict, toks, cache) -> tuple:
    """prefill over ``batch`` then a decode step a row of ``toks``: (every
    step's logits (B, 1 + steps, V) f32, the final cache, the greedy
    tokens of every step (B, 1 + steps))."""
    import torch

    from repro_torch.models import transformer

    logits, cache = transformer.prefill(model, batch["tokens"], cache,
                                        frames=batch.get("frames"))
    enc = model.encode(batch["frames"]) if cfg.enc_dec else None
    out = [logits]
    for t in toks:
        logits, cache = transformer.decode_step(model, t, cache, enc_out=enc)
        out.append(logits)
    lg = torch.cat(out, 1).float()
    return lg.numpy(), cache, torch.argmax(lg, -1).numpy()


def _flat(tree) -> dict:
    """Every leaf but ``pos`` as f32 numpy, by path."""
    return {p: t.float().numpy() for p, t in cache_paths(tree).items() if t.dim()}


def mesh_serve_rank(rank: int, world: int, out: str, kind: str) -> None:
    """The port's side of ``SERVE_MESHES[kind]`` on this gloo rank: its DP
    index and model rank; per arch, (1) in f32 for each prompt of
    SERVE_PROMPTS_F32 the port on the mesh over this rank's rows
    (``init(mesh=)``, ``init_cache(mesh=)``): its logits, greedy tokens
    and final cache block (the port at model = 1 is :func:`serve_one_rank`,
    run once beside the reference); (2) the reference's run (the arch's own dtype, the same
    weights; on (2, 2) laid out by ``serve_param_specs(shard_over_dp_bytes=
    SERVE_DP_BYTES)``): this rank's logits and cache block.  On the (2, 2)
    kind also the MLA layer's decode at the model group against the same
    layer on one rank."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import layers as L
    from repro_torch.models import registry, tp, transformer
    from repro_torch.serve import sharding
    from repro_torch.train import step as step_lib

    shape, gspmd = SERVE_MESHES[kind]
    mesh = mesh_lib.make_mesh(shape, AXES, device="cpu")
    mg = tp.model_group(mesh)
    dpg = mesh_lib.axis_group(mesh, step_lib.dp_axes_of(mesh))
    idx, n_dp = dist.get_rank(dpg), dist.get_world_size(dpg)
    per = SERVE_BATCH // n_dp
    rows = slice(idx * per, (idx + 1) * per)
    res = {"idx": idx, "mrank": mg.rank}
    torch.set_grad_enabled(False)
    torch.set_num_threads(1)  # 4 ranks beside the other test workers
    for arch in SERVE_ARCHS:
        cfg = tp_configs(arch)[0]
        toks = torch.from_numpy(serve_tokens(cfg))
        for S in SERVE_PROMPTS_F32:
            c32 = f32(cfg)
            batch = registry.make_batch(c32, SERVE_BATCH, S, rng=np.random.default_rng(0),
                                        device="cpu")
            batch.pop("labels")
            got = _serve(port_weights(c32, mesh=mesh), c32, {k: v[rows] for k, v in batch.items()},
                         toks[:, rows], transformer.init_cache(c32, SERVE_BATCH, SERVE_MAX_LEN,
                                                               "cpu", mesh=mesh))
            pre = f"{arch}_f32_{S}"
            res[f"{pre}_logits"], res[f"{pre}_tokens"] = got[0], got[2]
            for path, a in _flat(got[1]).items():
                res[f"{pre}_cache/{path}"] = a
        specs = (sharding.serve_param_specs(cfg, mesh, shard_over_dp_bytes=SERVE_DP_BYTES)
                 if gspmd else None)
        model = port_weights(cfg, mesh=mesh, param_specs=specs)
        res[f"{arch}_dp_split"] = len(model.dp_dims)
        batch = registry.make_batch(cfg, SERVE_BATCH, SERVE_PROMPT,
                                    rng=np.random.default_rng(0), device="cpu")
        batch.pop("labels")
        lg, cache, _ = _serve(model, cfg, {k: v[rows] for k, v in batch.items()}, toks[:, rows],
                              transformer.init_cache(cfg, SERVE_BATCH, SERVE_MAX_LEN, "cpu",
                                                     mesh=mesh))
        res[f"{arch}_logits"] = lg
        for path, a in _flat(cache).items():
            res[f"{arch}_cache/{path}"] = a
    if kind == "serve":  # MLA decode at the model group (2 ranks) against one rank
        cfg = f32(tp_configs("deepseek_v2_lite_16b")[0])
        spec = cfg.prefix[0]
        whole = _mla_layer(cfg)
        block = {k: transformer._block(t, L.spec_mla(cfg)[k], mg) for k, t in whole.items()}
        x = torch.from_numpy(_mla_x(cfg))
        s_loc = MLA_MAX_LEN // mg.size

        def zeros(n):
            return {"c_kv": torch.zeros(2, n, cfg.mla.kv_lora),
                    "k_rope": torch.zeros(2, n, cfg.mla.rope_dim)}

        c1, cm, gaps = zeros(MLA_MAX_LEN), zeros(s_loc), []
        for pos in range(MLA_STEPS):
            cos, sin = L.rope_table(torch.tensor([pos]), cfg.mla.rope_dim, cfg.rope_theta)
            xt = x[:, pos:pos + 1]
            o1 = L.mla_attention(whole, xt, cfg, spec, cos, sin, c1, pos)
            o2 = L.mla_attention(block, xt, cfg, spec, cos, sin, cm, pos, mg=mg)
            gaps.append(float(torch.max(torch.abs(o1 - o2))))
        res["mla_cp_gaps"] = np.array(gaps)
    np.savez(out, **res)


def block_of_global(a: np.ndarray, path: str, idx: int, n_dp: int, r: int,
                    n_model: int) -> np.ndarray:
    """Rank (``idx``, ``r``)'s block of a global cache leaf as
    ``cache_specs`` lays it out: its rows of the batch dim (after a stacked
    leaf's repeats) and, for a K/V or latent leaf, its positions."""
    stacked = path.startswith("blocks/")
    bd = 1 if stacked else 0
    per = a.shape[bd] // n_dp
    a = np.take(a, np.arange(idx * per, (idx + 1) * per), axis=bd)
    if "/kv/" in path:
        s_loc = a.shape[bd + 1] // n_model
        a = np.take(a, np.arange(r * s_loc, (r + 1) * s_loc), axis=bd + 1)
    return a


def upto(a: np.ndarray, path: str, start: int, pos: int) -> np.ndarray:
    """A K/V or latent block (from global position ``start``) cut to its
    positions below ``pos``; any other leaf as it is."""
    if "/kv/" not in path:
        return a
    d = 2 if path.startswith("blocks/") else 1
    n = int(np.clip(pos - start, 0, a.shape[d]))
    return np.take(a, np.arange(n), axis=d)


# the engine at (data, model) = (1, 2): 3 requests on 2 slots (a slot
# refilled), prompts padded to 8 and 12 positions of a 16-position cache
# (a block holds 8), so prefills fill one block or both and decode steps
# cross into the second
ENGINE_ARCHS = ("tinyllama_1_1b", "deepseek_v2_lite_16b", "jamba_v0_1_52b", "xlstm_350m")
ENGINE_PROMPTS, ENGINE_NEW, ENGINE_SLOTS, ENGINE_CHUNK = (5, 9, 7), 4, 2, 4


def engine_prompts(cfg) -> list:
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in ENGINE_PROMPTS]


def engine_tokens(cfg, model, *, pd: bool = False, temperature: float = 0.0) -> np.ndarray:
    """The tokens ``ServeEngine`` gives each request of ``engine_prompts``,
    (requests, ENGINE_NEW) in request order."""
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.sched.cache import PlanCache
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    scfg = ServeConfig(batch_slots=ENGINE_SLOTS, max_len=SERVE_MAX_LEN,
                       prefill_chunk=ENGINE_CHUNK, pd_disaggregated=pd,
                       temperature=temperature)
    eng = ServeEngine(cfg, model, scfg, kv_plan_cache=PlanCache() if pd else None,
                      kv_policy=CompressionPolicy(min_bytes=0) if pd else None)
    for i, p in enumerate(engine_prompts(cfg)):
        eng.submit(Request(rid=i, prompt=p, max_new=ENGINE_NEW))
    done = sorted((r.rid, r.out) for r in eng.run())
    assert [rid for rid, _ in done] == list(range(len(ENGINE_PROMPTS)))
    return np.array([out for _, out in done])


def engine_rank(rank: int, world: int, out: str) -> None:
    """This rank of a (1, 2) mesh: per arch (its SMOKE config in f32, the
    port's seed-0 weights) the engine's tokens colocated, PD-disaggregated
    and at temperature 0.8, the model = 1 engine's colocated tokens (each
    rank runs it), and the refusal of a corrupted weight update by
    ``ingest_weights`` at model > 1 (its message)."""
    from repro_torch.core.integrity import WireIntegrityError
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime.faults import corrupt_payload
    from repro_torch.sched.cache import PlanCache
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.sync.engine import WeightSyncEngine

    mesh = mesh_lib.make_mesh((1, 2), AXES, device="cpu")
    res = {}
    for arch in ENGINE_ARCHS:
        cfg = f32(tp_configs(arch)[0])
        model = port_weights(cfg, mesh=mesh)
        for tag, kw in (("col", {}), ("pd", {"pd": True}), ("hot", {"temperature": 0.8})):
            res[f"{arch}_{tag}"] = engine_tokens(cfg, model, **kw)
        res[f"{arch}_one"] = engine_tokens(cfg, port_weights(cfg))
        eng = ServeEngine(cfg, model, ServeConfig(batch_slots=1, max_len=SERVE_MAX_LEN))
        sync = WeightSyncEngine(policy=CompressionPolicy(min_bytes=0), plan_cache=PlanCache())
        sync.publish(port_weights(cfg).tree())
        try:
            eng.ingest_weights(corrupt_payload(sync.update_for("r"), np.random.default_rng(0)))
        except WireIntegrityError as e:
            res[f"{arch}_ingest"] = str(e)
    np.savez(out, **res)
