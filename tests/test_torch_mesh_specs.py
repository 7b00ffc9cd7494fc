"""The port's mesh layer (``launch/mesh``, the spec trees of ``models/``,
``train/step``'s layout names, ``serve/sharding``, ``optim/zero1``'s
global state layout) held against the JAX reference, entry by entry.

For all 11 archs at their full configs, on the meshes ``(1, 1)``, ``(2,
2, 1)``, ``(2, 2)``, ``(16, 16)`` and ``(2, 16, 16)``: ``transformer.
specs``, ``model_specs``, ``train_param_specs`` (``dp_only`` both ways),
``local_param_struct``'s shapes and dtypes, ``zero1_meta``,
``make_train_state_specs`` (ZeRO-1 both ways, FSDP) with the global state's
shapes and dtypes, ``serve_param_specs`` and ``cache_specs`` (batch 8 x
4096 positions, and 2 x 64) with the cache's shapes.  The reference runs
on a ``jax.sharding.AbstractMesh`` of the same shape; the port on a
``DeviceMesh`` under the ``fake`` process group of that many ranks; neither
allocates.  ``make_smoke_mesh`` and ``dp_size`` at 1, 2, 4 and 8 devices
and 1 or 2 pods equal the reference's, recorded in a subprocess with 8
forced host devices.  The refusals: ``make_mesh`` defaults to the card and
refuses the CPU unless asked, a shape that is not the world raises, and
the launcher refuses a batch that does not split over the mesh's data
ranks.  A 'model' axis above 1 builds a tensor-parallel ZeRO-1 and FSDP
state, Mamba, xLSTM and the vision stub included, and the CLI's mesh is
the reference's smoke mesh for either partition.  A one-rank checkpoint of the
per-rank ZeRO-1 layout restores into the global one.  Tolerance: none (all
exact).
"""
import contextlib
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.optim import optimizers as jopt
from repro.optim import zero1 as jzero1
from repro.serve import sharding as jsharding
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.optim import zero1
from repro_torch.serve import sharding
from repro_torch.runtime.fault_tolerance import RunnerConfig
from repro_torch.train import step as step_lib
from repro_torch.tree_util import bits_equal, tree_flatten, tree_flatten_up_to

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHES = ((8, 4096), (2, 64))


@pytest.fixture(autouse=True, scope="module")
def _reference_params_once():
    """The reference's ``abstract_params`` traces the whole init (0.2 s a
    call for deepseek-v3) and its layout functions call it again and again:
    one trace an arch, shared (its ShapeDtypeStructs are immutable)."""
    traced = functools.lru_cache(maxsize=None)(jtransformer.abstract_params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtransformer, "abstract_params", traced)
        yield


@contextlib.contextmanager
def fake_world(n: int):
    """A ``fake`` process group of ``n`` ranks (this process rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _ref_specs(tree) -> list:
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _specs(like, specs) -> list:
    """The port's spec tree, one spec a leaf of ``like``."""
    return list(tree_flatten_up_to(tree_flatten(like)[1], specs))


def _ref_shapes(tree) -> list:
    return [(tuple(s.shape), jnp.dtype(s.dtype).name) for s in jax.tree_util.tree_leaves(tree)]


def _shapes(tree) -> list:
    return [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in tree_flatten(tree)[0]]


def _meta_fields(meta) -> tuple:
    return (meta.dtype_names, meta.members, meta.lengths, meta.padded, meta.n_dp, meta.block)


def _ref_layouts(arch: str, shape, axes) -> dict:
    cfg = jconfigs.get(arch)
    mesh = AbstractMesh(shape, axes)
    params = jtransformer.abstract_params(cfg)
    out = {"specs": _ref_specs(jtransformer.specs(cfg)),
           "model_specs": _ref_specs(jstep.model_specs(cfg, mesh)),
           "local": _ref_shapes(jstep.local_param_struct(cfg, mesh)),
           "serve": _ref_specs(jsharding.serve_param_specs(cfg, mesh)),
           "params": _ref_shapes(params)}
    for dp_only in (False, True):
        tcfg = jstep.TrainConfig(dp_only=dp_only)
        axes_t = jstep.train_axes_of(mesh, tcfg)
        n_sync = int(np.prod([mesh.shape[a] for a in axes_t]))
        meta = jstep.zero1_meta(cfg, n_sync, tcfg, mesh)
        n_inner = 1 if dp_only else mesh.shape["model"]
        out[f"train_param_specs/{dp_only}"] = _ref_specs(jstep.train_param_specs(cfg, tcfg, mesh))
        out[f"zero1_meta/{dp_only}"] = _meta_fields(meta)
        out[f"zero1/{dp_only}"] = _ref_specs(jstep.make_train_state_specs(cfg, tcfg, mesh))
        out[f"zero1_state/{dp_only}"] = _ref_shapes(
            jzero1.state_struct(tcfg.optim, meta, n_inner))
    tcfg = jstep.TrainConfig(partition="fsdp")
    out["fsdp"] = _ref_specs(jstep.make_train_state_specs(cfg, tcfg, mesh))
    out["fsdp_plan"] = jax.tree_util.tree_leaves(jstep.plan_fsdp_tree(cfg, tcfg, mesh))
    for batch, max_len in CACHES:
        specs, struct = jsharding.cache_specs(cfg, mesh, batch, max_len)
        out[f"cache/{batch}x{max_len}"] = (_ref_specs(specs), _ref_shapes(struct))
    return out


def _port_layouts(arch: str, shape, axes) -> dict:
    cfg = configs.get(arch)
    with fake_world(int(np.prod(shape))):
        mesh = mesh_lib.make_mesh(shape, axes, device="cpu")
        params = transformer.abstract_params(cfg)
        out = {"specs": _specs(params, transformer.specs(cfg)),
               "model_specs": _specs(params, step_lib.model_specs(cfg, mesh)),
               "local": _shapes(step_lib.local_param_struct(cfg, mesh)),
               "serve": _specs(params, sharding.serve_param_specs(cfg, mesh)),
               "params": _shapes(params)}
        for dp_only in (False, True):
            tcfg = step_lib.TrainConfig(dp_only=dp_only)
            axes_t = step_lib.train_axes_of(mesh, tcfg)
            n_sync = int(np.prod([mesh_lib.axis_sizes(mesh)[a] for a in axes_t]))
            meta = step_lib.zero1_meta(cfg, n_sync, tcfg, mesh)
            state, specs = step_lib.abstract_train_state(cfg, tcfg, mesh)
            out[f"train_param_specs/{dp_only}"] = _specs(
                params, step_lib.train_param_specs(cfg, tcfg, mesh))
            out[f"zero1_meta/{dp_only}"] = _meta_fields(meta)
            out[f"zero1/{dp_only}"] = _specs(state, specs)
            assert specs == step_lib.make_train_state_specs(cfg, tcfg, mesh)
            out[f"zero1_state/{dp_only}"] = _shapes(state["opt"])
            n_inner = 1 if dp_only else mesh_lib.axis_sizes(mesh)["model"]
            assert _shapes(zero1.state_struct(tcfg.optim, meta, n_inner)) == \
                out[f"zero1_state/{dp_only}"]
        tcfg = step_lib.TrainConfig(partition="fsdp")
        state, specs = step_lib.abstract_train_state(cfg, tcfg, mesh)
        out["fsdp"] = _specs(state, specs)
        out["fsdp_plan"] = tree_flatten(step_lib.plan_fsdp_tree(cfg, tcfg, mesh))[0]
        out["fsdp_state"] = (_shapes(state["params"]), _shapes(state["opt"]))
        for batch, max_len in CACHES:
            struct, specs = sharding.abstract_cache(cfg, mesh, batch, max_len)
            out[f"cache/{batch}x{max_len}"] = (_specs(struct, specs), _shapes(struct))
    return out


def _ref_fsdp_state(arch: str, shape, axes) -> tuple:
    """The reference's global FSDP state shapes (``abstract_train_state``'s
    arithmetic: parameters global, each optimizer leaf ``(n_dp,) + local
    shard``)."""
    cfg = jconfigs.get(arch)
    mesh = AbstractMesh(shape, axes)
    tcfg = jstep.TrainConfig(partition="fsdp")
    n_dp = int(np.prod([mesh.shape[a] for a in jstep.dp_axes_of(mesh)]))
    params = jtransformer.abstract_params(cfg)
    local = jstep.fsdp_local_shapes(params, jstep.plan_fsdp_tree(cfg, tcfg, mesh), n_dp)
    ost = jax.eval_shape(lambda p: jopt.init(tcfg.optim, p), local)
    ost = jax.tree.map(lambda l: jax.ShapeDtypeStruct(
        ((n_dp,) + l.shape) if l.ndim > 0 else l.shape, l.dtype), ost)
    return _ref_shapes(params), _ref_shapes(ost)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_layouts_equal_the_reference(arch, mesh):
    shape, axes = MESHES[mesh]
    want, got = _ref_layouts(arch, shape, axes), _port_layouts(arch, shape, axes)
    assert got.pop("fsdp_state") == _ref_fsdp_state(arch, shape, axes)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


def test_model_axis_dims_come_from_the_specs():
    """``model_axis_dims`` is the 'model' entries of ``specs``: one source."""
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        params = transformer.abstract_params(cfg)
        dims = _specs(params, transformer.model_axis_dims(cfg))
        assert dims == [tuple(d for d, e in enumerate(s) if e == "model")
                        for s in _specs(params, transformer.specs(cfg))]


SMOKE = [(n, pods) for n in (1, 2, 4, 8) for pods in (1, 2)]
_SMOKE_SCRIPT = """
import json, sys
from repro.launch.mesh import make_smoke_mesh, dp_size
out = {}
for n, pods in json.loads(sys.argv[1]):
    try:
        m = make_smoke_mesh(n, pods=pods)
        out[f"{n}/{pods}"] = [list(m.axis_names), [int(m.shape[a]) for a in m.axis_names],
                              int(dp_size(m))]
    except AssertionError:
        out[f"{n}/{pods}"] = "raises"
print("SMOKE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_smoke_meshes():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(p for p in ("src", os.environ.get("PYTHONPATH"))
                                          if p))
    res = subprocess.run([sys.executable, "-c", _SMOKE_SCRIPT, json.dumps(SMOKE)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    line = next(l for l in res.stdout.splitlines() if l.startswith("SMOKE "))
    return json.loads(line[len("SMOKE "):])


@pytest.mark.parametrize("n,pods", SMOKE)
def test_smoke_meshes_equal_the_reference(reference_smoke_meshes, n, pods):
    want = reference_smoke_meshes[f"{n}/{pods}"]
    with fake_world(n):
        if want == "raises":
            with pytest.raises(ValueError, match="pods"):
                mesh_lib.make_smoke_mesh(pods=pods, device="cpu")
            return
        mesh = mesh_lib.make_smoke_mesh(pods=pods, device="cpu")
        got = [list(mesh.mesh_dim_names), list(mesh.shape), mesh_lib.dp_size(mesh)]
    assert got == want


def test_production_meshes():
    for multi_pod, want in ((False, {"data": 16, "model": 16}),
                            (True, {"pod": 2, "data": 16, "model": 16})):
        with fake_world(int(np.prod(list(want.values())))):
            mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cpu")
            assert mesh_lib.axis_sizes(mesh) == want
            assert mesh_lib.dp_size(mesh) == 16 * (2 if multi_pod else 1)


def test_make_mesh_refusals():
    with fake_world(4):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                mesh_lib.make_mesh((2, 2), ("data", "model"))
        with pytest.raises(ValueError, match="world 4"):
            mesh_lib.make_mesh((2, 4), ("data", "model"), device="cpu")
        with pytest.raises(ValueError, match="name its axes"):
            mesh_lib.make_mesh((2, 2), ("data",), device="cpu")


@pytest.mark.parametrize("partition,dp_only", [("zero1", False), ("fsdp", False),
                                               ("fsdp", True)])
def test_tensor_parallel_mesh_builds_the_state_of_either_partition(partition, dp_only):
    """A 'model' axis of 2 that carries tensor parallelism: ZeRO-1 and FSDP
    run over it (the state builds on this rank's blocks, and
    ``sync_group`` gives the data group and the model group); FSDP shards
    a block on a dim 'model' leaves alone.  FSDP under ``dp_only`` keeps
    the model group None and the leaves whole over 'model'."""
    tcfg = step_lib.TrainConfig(partition=partition, dp_only=dp_only, fsdp_min_bytes=0)
    cfg = configs.get_smoke("smollm_135m")
    with fake_world(4):
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
        state = step_lib.build_train_state(cfg, tcfg, generator=torch.Generator(),
                                           mesh=mesh, device="cpu")
        groups = step_lib.sync_group(mesh, tcfg)
        assert state.group is groups.group
        heads = cfg.n_heads * cfg.hd
        wq = tuple(state.model.params["blocks/0/mixer/wq"].shape)
        if dp_only:
            assert groups.model is None and state.model.mg is None
            assert groups.axes == ("data",) and dist.get_world_size(groups.group) == 2
            # whole over 'model'; the FSDP plan shards dim 1 ('model' takes dim 2)
            assert wq == (cfg.repeats, cfg.d_model // 2, heads)
            return
        assert groups.axes == ("data",) and dist.get_world_size(groups.group) == 2
        assert (groups.model.size, groups.model.rank) == (2, 0)
        assert state.model.mg is groups.model
        if partition == "zero1":
            assert wq == (cfg.repeats, cfg.d_model, heads // 2)
            assert state.meta == step_lib.zero1_meta(cfg, 2, tcfg, mesh)
            return
        # FSDP: this rank's DP shard (dim 1) of its model block (dim 2)
        assert wq == (cfg.repeats, cfg.d_model // 2, heads // 2)
        assert tuple(state.model.params["embed"].shape) == (cfg.vocab // 2, cfg.d_model // 2)
        assert state.fsdp_dims == step_lib.plan_fsdp_tree(cfg, tcfg, mesh)
        assert [tuple(t.shape) for t in tree_flatten(state.global_like()["params"])[0]] == \
            [tuple(t.shape) for t in tree_flatten(transformer.abstract_params(cfg))[0]]


@pytest.mark.parametrize("partition", ["zero1", "fsdp"])
@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "xlstm_350m", "qwen2_vl_72b"])
def test_recurrent_mixers_and_the_vision_stub_at_model_2_build(arch, partition):
    """Mamba, mLSTM/sLSTM and the vision stub over a 'model' axis of 2: the
    state builds on this rank's blocks, ``in_proj``'s contiguous half of
    its columns, ``wq``/``wi`` a half of the heads, the embedding half the
    vocabulary's rows."""
    cfg = configs.get_smoke(arch)
    tcfg = step_lib.TrainConfig(partition=partition)  # nothing FSDP-sharded at SMOKE size
    with fake_world(4):
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
        state = step_lib.build_train_state(cfg, tcfg, generator=torch.Generator(),
                                           mesh=mesh, device="cpu")
    params = {k: tuple(v.shape) for k, v in state.model.params.items()}
    d, r = cfg.d_model, cfg.repeats
    assert params["embed"] == (cfg.vocab // 2, d)
    pi = next((i for i, s in enumerate(cfg.pattern) if s.mixer != "attn"), 0)
    mixer = f"blocks/{pi}/mixer"
    if arch == "jamba_v0_1_52b":
        di = cfg.mamba.expand * d
        assert params[f"{mixer}/in_proj"] == (r, d, di)  # of (r, d, 2 di)
        assert params[f"{mixer}/conv_w"] == (r, cfg.mamba.d_conv, di // 2)
        assert params[f"{mixer}/out_proj"] == (r, di // 2, d)
    elif arch == "xlstm_350m":
        assert params[f"{mixer}/wq"] == (r, d, cfg.n_heads * cfg.hd // 2)
        assert params[f"{mixer}/wi"] == (r, d, cfg.n_heads // 2)
    else:
        assert params["blocks/0/mixer/wq"] == (r, d, cfg.n_heads * cfg.hd // 2)


def test_dp_only_syncs_over_every_axis():
    tcfg = step_lib.TrainConfig(dp_only=True)
    with fake_world(4):
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
        group, axes, mg = step_lib.sync_group(mesh, tcfg)
        assert axes == ("data", "model") and dist.get_world_size(group) == 4 and mg is None
        assert step_lib.sync_group(
            mesh_lib.make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu"),
            step_lib.TrainConfig())[1] == ("pod", "data")


def test_block_of_is_pod_major():
    """A rank's block of a ``(("pod", "data"), None)`` leaf is row ``p *
    n_data + d``; 'model' splits the columns."""
    t = torch.arange(8 * 6).reshape(8, 6)
    with fake_world(8):
        mesh = mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        grid = mesh.mesh
        for rank in range(8):
            p, d, m = (int(i) for i in (grid == rank).nonzero()[0])
            mesh.get_coordinate = lambda p=p, d=d, m=m: [p, d, m]
            blk = mesh_lib.block_of(t, (("pod", "data"), "model"), mesh)
            row = 2 * (2 * p + d)
            assert torch.equal(blk, t[row:row + 2, 3 * m:3 * m + 3])
        assert mesh_lib.shard_shape((8, 6), (("pod", "data"), "model"), mesh) == (2, 3)
        with pytest.raises(ValueError, match="does not split"):
            mesh_lib.block_of(torch.zeros(3, 6), (("pod", "data"), None), mesh)


def test_abstract_mesh_lays_out_as_the_device_mesh():
    """The per-device bytes of the train state (ZeRO-1 and FSDP) and of a
    cache on an ``AbstractMesh`` equal those on the ``DeviceMesh``."""
    shape, axes = MESHES["2x16x16"]
    cfg = configs.get("deepseek_v2_lite_16b")
    abstract = mesh_lib.AbstractMesh(shape, axes)

    def nbytes(mesh):
        out = [mesh_lib.shard_bytes(step_lib.abstract_train_state(
            cfg, step_lib.TrainConfig(partition=p), mesh), mesh) for p in ("zero1", "fsdp")]
        return out + [mesh_lib.shard_bytes(sharding.abstract_cache(cfg, mesh, 8, 4096), mesh)]

    with fake_world(512):
        want = nbytes(mesh_lib.make_mesh(shape, axes, device="cpu"))
    assert nbytes(abstract) == want and min(want) > 0


def test_axis_group_of_a_slice_of_the_mesh():
    """Axes that span part of the world: one group a slice of the rank
    grid, this rank's, its ranks pod-major, made once a mesh."""
    with fake_world(8):
        mesh = mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        g = mesh_lib.axis_group(mesh, ("pod", "data"))
        assert dist.get_process_group_ranks(g) == [0, 2, 4, 6]
        assert mesh_lib.axis_group(mesh, ("pod", "data")) is g
        assert dist.get_process_group_ranks(mesh_lib.axis_group(mesh, ("model",))) == [0, 1]
        assert mesh_lib.axis_group(mesh, ("pod", "data", "model")) is dist.group.WORLD


def test_zero1_local_and_global_layouts_equal_the_reference():
    """``local_to_global`` puts a rank's ``(shard_len,)`` leaves in its
    ``(1, shard_len)`` block, ``global_to_local`` takes them back, as the
    reference's do."""
    rng = np.random.default_rng(3)
    local = {"count": np.int32(4), "buckets": tuple(
        {k: rng.normal(size=n).astype(np.float32) for k in ("m", "master", "v")}
        for n in (1024, 512))}
    as_torch = lambda t: {"count": torch.tensor(t["count"]), "buckets": tuple(  # noqa: E731
        {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()} for b in t["buckets"])}
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    got = zero1.local_to_global(as_torch(local))
    want = jzero1.local_to_global(as_jax(local))
    assert [tuple(t.shape) for t in tree_flatten(got)[0]] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(want)]
    back = zero1.global_to_local(got)
    jback = jzero1.global_to_local(want)
    for a, b in zip(tree_flatten(back)[0], jax.tree_util.tree_leaves(jback), strict=True):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_launcher_refuses_a_batch_that_does_not_split_over_the_dp_ranks():
    """6 rows over 4 data ranks would drop 2 of them; the reference's
    ``device_put`` of such a batch raises too."""
    with fake_world(4):
        mesh = mesh_lib.make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
        with pytest.raises(ValueError, match="batch of 6 rows .* 4 data-parallel ranks"):
            launch_train.build("smollm_135m", smoke=True, batch=6, seq=16, rcfg=RunnerConfig(),
                               device="cpu", mesh=mesh)


@pytest.mark.parametrize("partition", ["zero1", "fsdp"])
@pytest.mark.parametrize("arch", ["xlstm_350m", "smollm_135m", "tinyllama_1_1b",
                                  "jamba_v0_1_52b", "qwen2_vl_72b"])
def test_launcher_cli_state_at_4_ranks(arch, partition):
    """The CLI's layout at 4 ranks (``cli_mesh``), either partition: the
    reference's smoke mesh (data, model) = (2, 2), tensor parallel over
    'model' for every arch (the CLI sets no ``dp_only``, as the
    reference's CLI sets none): the launcher builds each state on this
    rank's blocks, its sync group the 2 data ranks.  At one rank the mesh
    is (1, 1)."""
    with fake_world(4):
        mesh = launch_train.cli_mesh(4, device="cpu")
        assert mesh_lib.axis_sizes(mesh) == {"data": 2, "model": 2}
        state = launch_train.build(arch, smoke=True, batch=4, seq=16, rcfg=RunnerConfig(),
                                   device="cpu", mesh=mesh, partition=partition)[0]
        assert dist.get_world_size(state.group) == 2
        assert state.model.mg is not None and state.model.mg.size == 2
        assert (state.fsdp_dims is not None) == (partition == "fsdp")
    with fake_world(1):
        mesh = launch_train.cli_mesh(1, device="cpu")
        assert mesh_lib.axis_sizes(mesh) == {"data": 1, "model": 1}


def test_one_rank_checkpoint_of_the_per_rank_layout_restores(tmp_path):
    """A one-rank ZeRO-1 checkpoint whose bucket leaves are stored
    ``(shard_len,)`` (the per-rank layout, before the global one) restores
    into the global ``(1, shard_len)`` layout and gives the state back bit
    for bit; the state's own checkpoint holds the global shapes."""
    with launch_train.single_process_group("cpu"):
        state = step_lib.build_train_state(
            configs.get_smoke("smollm_135m"), step_lib.TrainConfig(),
            generator=torch.Generator().manual_seed(0), device="cpu")
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(0, state.tree())  # a plain tree: saved as it is
        back, step = mgr.restore(state, device="cpu")
        assert step == 0 and bits_equal(back.tree(), state.tree())
        mgr.save(1, state)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        files = json.load(f)["files"]
    n = state.meta.shard_lens[0]
    assert files["opt/buckets/0/m"]["shape"] == [1, n]
