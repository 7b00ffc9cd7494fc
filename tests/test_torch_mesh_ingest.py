"""Two pieces of serving on a model split over 'model', at SMOKE size on
gloo ranks of the CPU:

* ``ServeEngine.ingest_weights`` at (data, model) = (1, 2): a full update
  and then a delta (after a seeded change) of the trainer's whole weights
  (``WeightSyncEngine.update_for``, the port at model = 1) give each rank
  the ``block_of`` of the model = 1 engine's ingested leaves, bit for bit,
  and of the published weights; greedy tokens after the delta equal the
  engine's at model = 1 on the published weights; a corrupted update and
  a fenced delta are refused on both ranks with every weight and the
  version untouched; both ranks hold the same version and epoch.  Archs:
  tinyllama (bf16), deepseek-v2-lite (MLA, MoE over 'model') and jamba
  (Mamba) as the TP tests take them (``torch_port_util.tp_configs``).
  ``apply_update_blocks`` decodes a bucket a piece at a time: pieces of
  one block to the whole bucket give ``apply_update``'s bits.
* a cache whose batch the DP ranks do not split (a ``long_500k`` cell's
  batch of 1) at (2, 2) on 4 ranks: ``cache_specs`` replicates the rows,
  so every DP rank holds and computes the whole batch; prefill and 4
  decode steps of jamba and xlstm (f32) give every rank the same logits,
  those of the port at model = 1 and those of the reference's one-device
  run (one subprocess).

Tolerances: bits and tokens exactly; logits across ranks exactly; against
model = 1 and the reference within 1e-5 absolute (f32; the serving tests'
bound)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_mesh_serve_util import (AXES, ENGINE_NEW, ENGINE_PROMPTS, SERVE_MAX_LEN, SERVE_STEPS,
                                   _serve, engine_tokens, f32, port_weights, serve_tokens)
from torch_port_util import run_gloo_ranks, tp_configs

INGEST_ARCHS = ("tinyllama_1_1b", "deepseek_v2_lite_16b", "jamba_v0_1_52b")
REPLICATED_ARCHS = ("jamba_v0_1_52b", "xlstm_350m")
PROMPT = 6  # positions of the replicated batch's prompt
ATOL = 1e-5


def _bits(t) -> np.ndarray:
    import torch

    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().copy()


def _changed(model, seed: int):
    """A seeded change of ``model``'s weights, in place: the low 3 mantissa
    bits of about 30% of every leaf's entries XORed with a random mask (the
    shape of consecutive optimizer steps, which a delta ships)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    ints = {2: torch.int16, 4: torch.int32}
    with torch.no_grad():
        for p in model.leaves():
            bits = p.view(ints[p.element_size()])
            mask = torch.randint(0, 8, p.shape, generator=gen).to(bits.dtype)
            bits.bitwise_xor_(mask * (torch.rand(p.shape, generator=gen) < 0.3))
    return model


def ingest_rank(rank: int, world: int, out: str) -> None:
    """This rank of a (1, 2) mesh, per arch: a model = 1 engine and this
    rank's engine at model = 2 (both from other weights, seed 1) ingest a
    full update of the seed-0 weights, then a delta to their seeded change;
    after each, whether the rank's every leaf has the bits of the block of
    the model = 1 engine's leaf and of the published one; the greedy tokens
    of both engines after the delta; a corrupted update's and a fenced
    delta's refusals, and whether they left the bits and the version."""
    import torch

    from repro_torch.core import integrity
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer
    from repro_torch.runtime.faults import corrupt_payload
    from repro_torch.sched.cache import PlanCache
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.sync.engine import WeightSyncEngine

    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh((1, 2), AXES, device="cpu")
    res = {}
    for arch in INGEST_ARCHS:
        cfg = tp_configs(arch)[0]
        specs = transformer.block_specs(cfg, 2)
        paths = [p for p, _ in transformer.tree_paths(transformer.abstract_params(cfg))]
        scfg = ServeConfig(batch_slots=1, max_len=SERVE_MAX_LEN)
        other = dict(generator=torch.Generator().manual_seed(1), device="cpu")
        rank_eng = ServeEngine(cfg, transformer.init(cfg, mesh=mesh, **other), scfg)
        one_eng = ServeEngine(cfg, transformer.init(cfg, **other), scfg)
        trainer = port_weights(cfg)
        sync = WeightSyncEngine(policy=CompressionPolicy(min_bytes=0), plan_cache=PlanCache())

        def same_blocks(tag):
            for path, mine, one, pub in zip(paths, rank_eng.model.leaves(),
                                            one_eng.model.leaves(), trainer.leaves()):
                res[f"{arch}_{tag}_vs_one/{path}"] = np.array(np.array_equal(
                    _bits(mine), _bits(mesh_lib.block_of(one.detach(), specs[path], mesh))))
                res[f"{arch}_{tag}_vs_pub/{path}"] = np.array(np.array_equal(
                    _bits(mine), _bits(mesh_lib.block_of(pub.detach(), specs[path], mesh))))

        v1 = sync.publish(trainer.tree())
        full = sync.update_for("r")
        res[f"{arch}_full_mode"] = np.array(full.mode)
        res[f"{arch}_full_version"] = np.array(
            [rank_eng.ingest_weights(full), one_eng.ingest_weights(full)])
        same_blocks("full")
        sync.ack("r", v1)
        _changed(trainer, seed=5)
        v2 = sync.publish(trainer.tree())
        delta = sync.update_for("r")
        res[f"{arch}_delta_mode"] = np.array(delta.mode)
        res[f"{arch}_delta_version"] = np.array(
            [rank_eng.ingest_weights(delta), one_eng.ingest_weights(delta), v2])
        res[f"{arch}_epoch"] = np.array([rank_eng.weight_epoch, delta.epoch])
        same_blocks("delta")
        res[f"{arch}_tokens"] = engine_tokens(cfg, rank_eng.model)
        res[f"{arch}_tokens_one"] = engine_tokens(cfg, one_eng.model)
        before = [_bits(p) for p in rank_eng.model.leaves()]
        refused = []
        for upd, err in ((corrupt_payload(delta, np.random.default_rng(3)),
                          integrity.WireIntegrityError),
                         (dataclasses.replace(delta, base_version=v1 - 1), ValueError)):
            try:
                rank_eng.ingest_weights(upd)
                refused.append("")
            except err as e:
                refused.append(str(e))
        res[f"{arch}_refused"] = np.array(refused)
        res[f"{arch}_untouched"] = np.array(
            all(np.array_equal(b, _bits(p)) for b, p in zip(before, rank_eng.model.leaves()))
            and rank_eng.weight_version == v2)
    np.savez(out, **res)


def replicated_rank(rank: int, world: int, out: str) -> None:
    """This rank of a (2, 2) mesh, per arch in f32: prefill of a batch of
    one row (the rows replicated over 'data') and SERVE_STEPS decode steps
    on the rank's blocks, into a SERVE_MAX_LEN-position cache; the logits
    (1, 1 + steps, V) and the cache block's batch dim.  Rank 0 also runs
    the port at model = 1."""
    import torch

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import registry, transformer

    torch.set_num_threads(1)
    torch.set_grad_enabled(False)
    mesh = mesh_lib.make_mesh((2, 2), AXES, device="cpu")
    res = {}
    for arch in REPLICATED_ARCHS:
        cfg = f32(tp_configs(arch)[0])
        batch = registry.make_batch(cfg, 1, PROMPT, rng=np.random.default_rng(0), device="cpu")
        toks = torch.from_numpy(serve_tokens(cfg)[:, :1])
        cache = transformer.init_cache(cfg, 1, SERVE_MAX_LEN, "cpu", mesh=mesh)
        res[f"{arch}_rows"] = np.array(
            [t.shape[1 if p.startswith("blocks/") else 0]
             for p, t in transformer.tree_paths(cache) if t.dim()])
        res[f"{arch}_logits"] = _serve(port_weights(cfg, mesh=mesh), cfg, batch, toks, cache)[0]
        if rank == 0:
            res[f"{arch}_one"] = _serve(port_weights(cfg), cfg, batch, toks,
                                        transformer.init_cache(cfg, 1, SERVE_MAX_LEN, "cpu"))[0]
    np.savez(out, **res)


def replicated_reference(out_dir: str) -> None:
    """The reference's one-device ``prefill`` and ``decode_step`` (jitted)
    of the same batch of one row, weights and tokens, per arch in f32."""
    import jax
    import jax.numpy as jnp

    from repro.models import registry as jregistry
    from repro.models import transformer as jt
    from repro_torch.tree_util import tree_map
    from torch_port_util import ref_array

    res = {}
    for arch in REPLICATED_ARCHS:
        cfg, jcfg = (f32(c) for c in tp_configs(arch))
        params = jax.tree_util.tree_map(jnp.asarray, tree_map(ref_array, port_weights(cfg).tree()))
        batch = {k: jnp.asarray(v) for k, v in jregistry.make_batch(
            jcfg, 1, PROMPT, rng=np.random.default_rng(0)).items() if k != "labels"}
        logits, cache = jax.jit(jt.prefill, static_argnums=2)(
            params, batch, jcfg, jt.init_cache(jcfg, 1, SERVE_MAX_LEN))
        out = [logits]
        decode = jax.jit(jt.decode_step, static_argnums=3)
        for t in serve_tokens(jcfg)[:, :1]:
            logits, cache = decode(params, jnp.asarray(t), cache, jcfg)
            out.append(logits)
        res[arch] = np.concatenate([np.asarray(o, np.float32) for o in out], 1)
    np.savez(os.path.join(out_dir, "ref.npz"), **res)


@pytest.fixture(scope="module")
def ingest_run(tmp_path_factory):
    return run_gloo_ranks(ingest_rank, 2, tmp_path_factory.mktemp("ingest"), timeout=300)


@pytest.fixture(scope="module")
def replicated_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("replicated_ref")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(here), "src"), here, os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, "-c", f"import test_torch_mesh_ingest as t; "
                            f"t.replicated_reference({str(out)!r})"], env=env,
                           stderr=subprocess.PIPE, text=True)
    ranks = run_gloo_ranks(replicated_rank, 4, tmp_path_factory.mktemp("replicated"),
                           timeout=300)
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    return dict(np.load(os.path.join(str(out), "ref.npz"))), ranks


@pytest.mark.parametrize("arch", INGEST_ARCHS)
def test_full_and_delta_ingest_give_each_rank_its_block(ingest_run, arch):
    for res in ingest_run:
        assert str(res[f"{arch}_full_mode"]) == "full" and str(res[f"{arch}_delta_mode"]) == "delta"
        for tag in ("full", "delta"):
            for kind in ("one", "pub"):
                keys = [k for k in res if k.startswith(f"{arch}_{tag}_vs_{kind}/")]
                assert keys and all(bool(res[k]) for k in keys), \
                    [k for k in keys if not bool(res[k])]


@pytest.mark.parametrize("arch", INGEST_ARCHS)
def test_every_rank_holds_the_same_version_and_epoch(ingest_run, arch):
    versions = [tuple(res[f"{arch}_delta_version"]) for res in ingest_run]
    assert all(v == versions[0] for v in versions) and len(set(versions[0])) == 1
    for res in ingest_run:
        full = res[f"{arch}_full_version"]
        assert full[0] == full[1] == versions[0][0] - 1
        assert res[f"{arch}_epoch"][0] == res[f"{arch}_epoch"][1]


@pytest.mark.parametrize("arch", INGEST_ARCHS)
def test_tokens_after_ingest_are_the_engine_s_at_model_1(ingest_run, arch):
    for res in ingest_run:
        assert res[f"{arch}_tokens"].shape == (len(ENGINE_PROMPTS), ENGINE_NEW)
        np.testing.assert_array_equal(res[f"{arch}_tokens"], res[f"{arch}_tokens_one"])
        np.testing.assert_array_equal(res[f"{arch}_tokens"], ingest_run[0][f"{arch}_tokens"])


@pytest.mark.parametrize("arch", INGEST_ARCHS)
def test_corrupt_and_fenced_updates_are_refused_on_every_rank(ingest_run, arch):
    for res in ingest_run:
        corrupt, fenced = (str(s) for s in res[f"{arch}_refused"])
        assert "checksum" in corrupt and "full send" in fenced
        assert bool(res[f"{arch}_untouched"])


@pytest.mark.parametrize("arch", REPLICATED_ARCHS)
def test_a_batch_the_dp_ranks_do_not_split_is_replicated(replicated_run, arch):
    _, ranks = replicated_run
    for res in ranks:
        assert (res[f"{arch}_rows"] == 1).all()
        np.testing.assert_array_equal(res[f"{arch}_logits"], ranks[0][f"{arch}_logits"])
    assert ranks[0][f"{arch}_logits"].shape[:2] == (1, 1 + SERVE_STEPS)


@pytest.mark.parametrize("arch", REPLICATED_ARCHS)
def test_replicated_batch_matches_model_1_and_the_reference(replicated_run, arch):
    ref, ranks = replicated_run
    got = ranks[0][f"{arch}_logits"]
    np.testing.assert_allclose(got, ranks[0][f"{arch}_one"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ref[arch], rtol=0, atol=ATOL)


@pytest.mark.parametrize("chunk", [512, 4096, 1 << 24])
def test_apply_update_blocks_decodes_a_bucket_in_pieces(monkeypatch, chunk):
    """``apply_update_blocks`` decodes a bucket ``DECODE_CHUNK`` values at a
    time, each piece from the message's blocks that hold it: pieces of one
    block, of several leaves and of one, a full and a delta update of bf16
    and f32 buckets, give the bits of ``apply_update``'s leaves."""
    import torch

    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.sched.cache import PlanCache
    from repro_torch.sync import engine as sync_engine
    from repro_torch.tree_util import tree_leaves

    monkeypatch.setattr(sync_engine, "DECODE_CHUNK", chunk)
    rng = np.random.default_rng(0)

    def draw(shape, dt):
        return torch.from_numpy(rng.normal(0, 0.02, shape).astype(np.float32)).to(dt)

    tree = {"a": draw((300, 70), torch.bfloat16), "b": draw((5000,), torch.bfloat16),
            "c": draw((33, 17), torch.float32), "d": draw((7,), torch.bfloat16)}
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    moved = {k: (t.view(ints[t.dtype]) ^ torch.from_numpy(rng.integers(0, 8, t.shape)).to(
        ints[t.dtype])).view(t.dtype) for k, t in tree.items()}
    sync = sync_engine.WeightSyncEngine(policy=CompressionPolicy(min_bytes=0),
                                        plan_cache=PlanCache())
    v1 = sync.publish(tree)
    full = sync.update_for("r")
    sync.ack("r", v1)
    sync.publish(moved)
    delta = sync.update_for("r")
    assert {m for _, _, m, _ in full.buckets} == {"full"}
    assert {m for _, _, m, _ in delta.buckets} == {"delta"}
    whole_full = tree_leaves(sync_engine.apply_update(full, device="cpu"))
    whole_delta = tree_leaves(sync_engine.apply_update(delta, base_params=whole_full,
                                                       device="cpu"))
    keep = lambda i, leaf: leaf.clone()  # noqa: E731
    got_full = sync_engine.apply_update_blocks(full, keep, device="cpu")
    got_delta = sync_engine.apply_update_blocks(delta, keep, got_full, device="cpu")
    for got, want in zip(got_full + got_delta, whole_full + whole_delta):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(_bits(got), _bits(want))
    n = sum(size for _, _, size in full.buckets[0][1])
    assert len(sync_engine.decode_chunks(full.buckets[0][1])) == -(-n // chunk)
