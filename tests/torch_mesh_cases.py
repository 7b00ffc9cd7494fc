"""The cases every mesh step file runs (``test_torch_mesh_zero1``,
``test_torch_mesh_fsdp``, ``test_torch_mesh_dp_only``), each on the
``mesh_run`` fixture of its file (and, below, the tensor-parallel
files' cases on their ``tp_run`` and ``tp_arch`` fixtures): ``(kind,
reference npz, the 4 ranks' npz, the reference's directory)`` of
``torch_port_util.MESH_RUNS[kind]``.

Tolerances: exact everywhere, except one whole step against the
reference's from the same state: loss relative 1e-4, grad norm relative
1e-2, each weight within ``2 lr_1 + 2**-7 |w|`` and at most 1% of them
different (the bf16 backward rounds in other places in the two
frameworks; ``test_torch_train``'s bounds for its one-device step)."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.optim import optimizers as opt
from torch_port_util import (MESH_LR, MESH_RS_POLICIES, MESH_RUNS, MESH_WARMUP, TP_F32, TP_RUNS,
                             tp_configs, tp_fsdp)


def test_ranks_take_the_pod_major_dp_index(mesh_run):
    """Sync-group rank = mesh place, first axis major = the reference's
    ``_dp_index`` over the sync axes (the row of a batch and of a ZeRO-1
    state leaf)."""
    kind, _, ranks, _ = mesh_run
    axes = MESH_RUNS[kind][1]
    sync = axes if kind == "dp_only" else ("pod", "data")
    for r, res in enumerate(ranks):
        assert (int(res["idx"]), int(res["place"])) == (r, r)
        assert tuple(res["sync"]) == sync


def _floats(bits: np.ndarray) -> np.ndarray:
    """f32 values of f32 (uint32) or bf16 (uint16) bits."""
    return (bits.astype(np.uint32) << 16).view(np.float32) if bits.dtype == np.uint16 \
        else bits.view(np.float32)


def assert_bits_nan_as_nan(got: np.ndarray, want: np.ndarray, ctx):
    """Bit for bit, but a NaN equals any NaN: XLA:CPU's reduce carries
    other NaN payloads than IEEE arithmetic (ROADMAP Queue C)."""
    assert got.shape == want.shape and got.dtype == want.dtype, ctx
    nan = np.isnan(_floats(got)) & np.isnan(_floats(want))
    bad = np.flatnonzero((got != want) & ~nan)
    assert bad.size == 0, (ctx, bad[:8])


@pytest.mark.parametrize("policy", sorted(MESH_RS_POLICIES))
def test_reduce_scatter_shards_equal_the_reference(mesh_run, policy):
    """Each rank's f32 reduce-scattered gradient shard over the sync axes
    (FSDP: the backward of its gather, and the gather) bit for bit, on
    inputs with zero and exception blocks, infinities and NaNs."""
    kind, ref, ranks, _ = mesh_run
    for res in ranks:
        i = int(res["idx"])
        for key in [k for k in (f"rs_{policy}", f"ag_{policy}") if k in ref]:
            assert_bits_nan_as_nan(res[key], ref[key][i], (key, i))
        if f"rs_{policy}_flag" in ref:
            assert int(res[f"rs_{policy}_flag"]) == int(ref[f"rs_{policy}_flag"][i]) == 0


def test_step_from_the_reference_state_matches_it(mesh_run):
    """One compressed step on each rank from the reference's step-0
    checkpoint restored onto the mesh, against the reference's step 1."""
    kind, ref, ranks, _ = mesh_run
    lr1 = float(opt.lr_at(opt.OptimConfig(lr=MESH_LR, warmup_steps=MESH_WARMUP),
                          torch.tensor(1)))
    losses = {float(r["loss"]) for r in ranks}
    assert len(losses) == 1, losses  # the mean over the ranks
    assert losses.pop() == pytest.approx(float(ref["comp_loss0"]), rel=1e-4)
    for res in ranks:
        assert int(res["overflow"]) == int(ref["comp_overflow0"]) == 0
        assert int(res["step"]) == 1
        assert float(res["gnorm"]) == pytest.approx(float(ref["comp_gnorm0"]), rel=1e-2)
        g, w = res["params"], res["ref_params"]
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=2 * lr1)
        assert (g != w).sum() <= 0.01 * g.size, ((g != w).sum(), g.size)


def test_compressed_and_raw_twins_are_identical(mesh_run):
    """2 steps compressed and raw from one init give the same losses and
    parameter bytes, on every rank and in the reference."""
    kind, ref, ranks, _ = mesh_run
    for res in ranks:
        assert np.array_equal(res["comp_losses"], res["raw_losses"])
        assert np.array_equal(res["comp_params"], res["raw_params"])
        if kind != "fsdp":  # replicated parameters; FSDP's ranks hold shards
            assert np.array_equal(res["comp_params"], ranks[0]["comp_params"])
    for i in range(2):
        assert float(ref[f"comp_loss{i}"]) == float(ref[f"raw_loss{i}"])
    assert np.array_equal(ref["comp_params"], ref["raw_params"])


def _manifest(d) -> dict:
    with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
        return json.load(f)["files"]


def test_reference_checkpoint_restores_its_rows_on_every_rank(mesh_run):
    """The reference's step-1 checkpoint, restored onto the mesh with
    ``restore(shardings=)`` (``ElasticController.rescale``), gives each
    rank its optimizer rows and (replicated) parameters bit for bit."""
    kind, ref, ranks, ref_dir = mesh_run
    files = _manifest(ref_dir / "ckpt")
    params = np.concatenate([
        np.load(ref_dir / "ckpt" / "step_00000001" / e["file"]).view(np.uint8).reshape(-1)
        for name, e in files.items() if name.startswith("params/")])
    for res in ranks:
        assert np.array_equal(res["opt1"], ref["opt1"][int(res["idx"])])
        assert int(res["opt1_count"]) == 1
        if kind != "fsdp":
            assert np.array_equal(res["step1_bits"], params)


def test_port_checkpoint_is_the_reference_s(mesh_run):
    """That state saved by the port's 4 ranks (gathered, rank 0 writes):
    the reference's names, shapes and dtype names; its f32 and int32
    files the reference's sha256s; its bf16 files the reference's bytes
    (the packages write bf16 under other ``.npy`` descriptors).  Restored
    without shardings, each rank takes its part back bit for bit."""
    _, _, ranks, ref_dir = mesh_run
    want, got = _manifest(ref_dir / "ckpt"), _manifest(ref_dir / "port_ckpt")
    assert [(k, e["file"], e["shape"], e["dtype"]) for k, e in got.items()] == \
        [(k, e["file"], e["shape"], e["dtype"]) for k, e in want.items()]
    assert any(e["shape"][:1] == [4] for k, e in got.items() if k.startswith("opt/"))
    for k, e in got.items():
        if e["dtype"] == "bfloat16":
            a = np.load(ref_dir / "port_ckpt" / "step_00000001" / e["file"])
            b = np.load(ref_dir / "ckpt" / "step_00000001" / want[k]["file"])
            assert a.tobytes() == b.tobytes(), k
        else:
            assert e["sha256"] == want[k]["sha256"], k
    assert all(int(res["resume_exact"]) for res in ranks)


def test_restored_leaves_hold_only_this_rank_s_part(mesh_run):
    """Restored with ``shardings=`` or without, each leaf of a rank's state
    (its optimizer rows, its FSDP shards) has storage of its own size: no
    rank keeps the others' rows alive behind a view."""
    _, _, ranks, _ = mesh_run
    for res in ranks:
        assert res["own_storage"].size and res["own_storage"].all()


# ---------------------------------------------------------------------------
# ZeRO-1 with tensor and expert parallelism over 'model' (``TP_RUNS``): the
# cases every ``test_torch_mesh_tp*`` file runs on its ``tp_run`` fixture,
# ``(kind, reference npz, the 4 ranks' npz, the reference's directory)``,
# and its ``tp_arch`` fixture, one of the kind's archs.  Tolerances as
# above.
# ---------------------------------------------------------------------------

def test_tp_ranks_take_their_dp_index_and_model_rank(tp_run):
    """Rank ``r`` of a mesh whose last axis is 'model': DP index ``r //
    n_model`` (pod-major) and model rank ``r % n_model``."""
    kind, _, ranks, _ = tp_run
    shape, axes, _ = TP_RUNS[kind]
    for r, res in enumerate(ranks):
        assert (int(res["idx"]), int(res["mrank"])) == divmod(r, shape[-1])
        assert tuple(res["sync"]) == tuple(a for a in axes if a != "model")


@pytest.mark.parametrize("policy", sorted(MESH_RS_POLICIES))
def test_tp_reduce_scatter_shards_equal_the_reference(tp_run, policy):
    """Each rank's f32 shard of the reduce-scatter over (pod, data) within
    its model index, bit for bit (NaN as NaN); an FSDP kind's: the gather
    of its model-local shard over that group and the reduce-scatter of its
    backward."""
    _, ref, ranks, _ = tp_run
    for r, res in enumerate(ranks):
        for key in [k for k in (f"rs_{policy}", f"ag_{policy}") if k in ref]:
            assert_bits_nan_as_nan(res[key], ref[key][r], (key, r))
        if f"rs_{policy}_flag" in ref:
            assert int(res[f"rs_{policy}_flag"]) == int(ref[f"rs_{policy}_flag"][r]) == 0


def test_tp_blocks_equal_the_reference_shards(tp_run, tp_arch):
    """``load_reference_params(mesh=)`` (FSDP: ``load_reference_fsdp_state(
    mesh=)`` of the reference's global step-0 state) and
    ``restore(shardings=)`` of the reference's step-0 checkpoint give each
    rank the reference's addressable shard of every parameter, bit for
    bit (FSDP: the DP shard of its model block; both ways its optimizer
    leaves the same)."""
    _, ref, ranks, _ = tp_run
    for r, res in enumerate(ranks):
        want = ref[f"{tp_arch}_init"][r]
        assert np.array_equal(res[f"{tp_arch}_load"], want), r
        assert np.array_equal(res[f"{tp_arch}_restored"], want), r
        assert int(res.get(f"{tp_arch}_load_opt_exact", 1)), r


def test_tp_init_blocks_join_to_the_one_rank_init(tp_run, tp_arch):
    """``transformer.init(mesh=)`` keeps this rank's block of each leaf of
    the one-rank init from the same generator, bit for bit."""
    from repro_torch.models import transformer

    kind, _, ranks, _ = tp_run
    n_model = TP_RUNS[kind][0][-1]
    cfg = tp_configs(tp_arch)[0]
    whole = transformer.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    kept = transformer.block_specs(cfg, n_model)
    for res in ranks:
        m = int(res["mrank"])
        parts = []
        for path, t in whole.params.items():
            for d, e in enumerate(kept[path]):
                if e == "model":
                    t = t.chunk(n_model, d)[m]
            parts.append(t.detach().contiguous().view(torch.uint8).reshape(-1).numpy())
        assert np.array_equal(res[f"{tp_arch}_own_init"], np.concatenate(parts))


def test_tp_bucket_meta_equals_the_reference(tp_run, tp_arch):
    """Each model rank's buckets (dtype lengths, padding, members) equal the
    reference's ``zero1_meta`` on ``local_param_struct``."""
    _, ref, ranks, _ = tp_run
    for res in ranks:
        assert np.array_equal(res[f"{tp_arch}_meta"], ref[f"{tp_arch}_meta"])
        assert np.array_equal(res[f"{tp_arch}_members"], ref[f"{tp_arch}_members"])


def test_tp_step_from_the_reference_state_matches_it(tp_run, tp_arch):
    """One compressed step on each rank from the reference's step-0 state
    against its step 1: the loss (the same on every rank), the grad norm
    (whatever the reference's psum over (dp, model) counts), each rank's
    blocks of the new weights, each within ``2 lr_1`` plus one bf16
    rounding of the larger of the two values (``test_torch_zoo_train``'s
    form: where a near-zero gradient's sign parts, AdamW's first step
    moves a near-zero weight by ``lr_1`` either way, and 2**-7 of the
    reference's value alone does not cover the rounding of the port's;
    measured on one whisper weight at (2, 2): the reference's -1.5736e-4,
    the port's -1.1597e-3, parted by 1.00231e-3 against 1.0012e-3, the
    same bits in every run of both packages, side by side or alone), at
    most 1% of them different.  The
    MoE arch steps in f32 (``TP_F32``),
    where sums in another order part the last bits of most weights: there
    a weight counts as different where it parts by more than 2**-16 of
    its magnitude (measured: 0.02% of them, up to 8e-5 where AdamW's
    first step divides a near-zero gradient by itself)."""
    _, ref, ranks, _ = tp_run
    a = tp_arch
    lr1 = float(opt.lr_at(opt.OptimConfig(lr=MESH_LR, warmup_steps=MESH_WARMUP),
                          torch.tensor(1)))
    losses = {float(r[f"{a}_loss"]) for r in ranks}
    assert len(losses) == 1, losses
    assert losses.pop() == pytest.approx(float(ref[f"{a}_loss"]), rel=1e-4)
    for res in ranks:
        assert int(res[f"{a}_overflow"]) == int(ref[f"{a}_overflow"]) == 0
        assert int(res[f"{a}_step"]) == 1
        assert float(res[f"{a}_gnorm"]) == pytest.approx(float(ref[f"{a}_gnorm"]), rel=1e-2)
        g, w = res[f"{a}_params"], res[f"{a}_ref_params"]
        bound = 2 * lr1 + 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w))
        assert (np.abs(g - w) <= bound).all(), np.abs(g - w).max()
        differ = (np.abs(g - w) > 2.0 ** -16 * np.abs(w)) if a in TP_F32 else (g != w)
        assert differ.sum() <= 0.01 * g.size, (differ.sum(), g.size)


def test_tp_compressed_and_raw_twins_are_identical(tp_run, tp_arch):
    """2 steps compressed and raw from one init (the launcher on the mesh,
    or ``train_step`` for the encoder-decoder model): the same losses and
    parameter bytes on every rank; the model ranks of a DP row report the
    same losses."""
    _, _, ranks, _ = tp_run
    a = tp_arch
    for res in ranks:
        assert np.array_equal(res[f"{a}_comp_losses"], res[f"{a}_raw_losses"])
        assert np.array_equal(res[f"{a}_comp_params"], res[f"{a}_raw_params"])
        assert np.array_equal(res[f"{a}_comp_losses"], ranks[0][f"{a}_comp_losses"])


def test_tp_replicated_leaves_are_identical_across_ranks(tp_run, tp_arch):
    """The leaves 'model' replicates (the norms, the router, MLA's
    down-projections, the final norm) hold the same bytes on every rank
    after 2 steps.  Under FSDP (those it leaves unsharded): on every model
    rank of a DP index.  Across DP indices they may part, in both
    packages: the FSDP step takes the replicated leaves' squares as the
    difference of two f32 sums that hold each DP rank's own shards
    (``sq_rep = sq - sq_shard``, ``src/repro/train/step.py:688``), so the
    clip's scale can part in its last bit between DP ranks (ROADMAP Queue
    C item 10; measured on deepseek-v3 SMOKE's second step: 1.50937104
    against 1.50937116)."""
    kind, _, ranks, _ = tp_run
    n_model = TP_RUNS[kind][0][-1]
    key = f"{tp_arch}_rep"
    for r, res in enumerate(ranks):
        first = ranks[r - r % n_model] if tp_fsdp(kind) else ranks[0]
        assert np.array_equal(res[key], first[key]), r


# ---------------------------------------------------------------------------
# FSDP at model > 1 (the ``fsdp_`` kinds of ``TP_RUNS``): the plans, the
# checkpoint
# ---------------------------------------------------------------------------

def test_fsdp_tp_gather_plans_are_keyed_by_model_local_shards(tp_run, tp_arch):
    """The step from the reference's state compiles one ``fsdp_gather``
    plan a signature, each keyed by the rank's DP shard of its model
    block (the sharded dim last), as the reference keys its plans by the
    model-local shape; no plan of a model-global shape."""
    _, _, ranks, _ = tp_run
    for r, res in enumerate(ranks):
        assert int(res[f"{tp_arch}_plan_keys"]), r


def test_fsdp_tp_checkpoint_is_the_reference_s(tp_run, tp_arch):
    """The restored step-1 state saved by the port's 4 ranks (every leaf's
    pieces gathered to rank 0, which writes) is the reference's
    checkpoint: names, shapes and dtype names; f32 and int32 files its
    sha256s, bf16 files its bytes; parameters whole (model blocks and DP
    shards joined), optimizer leaves ``(n_dp, *DP-local model-global
    shape)``.  Restored without shardings, each rank takes its part back
    bit for bit, its leaves holding only that part."""
    kind, _, ranks, ref_dir = tp_run
    a = tp_arch
    want_dir, got_dir = ref_dir / a / "ckpt", ref_dir / "port_ckpt" / a
    want, got = _manifest(want_dir), _manifest(got_dir)
    assert [(k, e["file"], e["shape"], e["dtype"]) for k, e in got.items()] == \
        [(k, e["file"], e["shape"], e["dtype"]) for k, e in want.items()]
    n_dp = int(np.prod(TP_RUNS[kind][0][:-1]))
    assert all(e["shape"][0] == n_dp for k, e in got.items()
               if k.startswith("opt/") and k != "opt/count")
    for k, e in got.items():
        if e["dtype"] == "bfloat16":
            x = np.load(got_dir / "step_00000001" / e["file"])
            y = np.load(want_dir / "step_00000001" / want[k]["file"])
            assert x.tobytes() == y.tobytes(), k
        else:
            assert e["sha256"] == want[k]["sha256"], k
    for res in ranks:
        assert int(res[f"{a}_resume_exact"]) and res[f"{a}_own_storage"].all()
