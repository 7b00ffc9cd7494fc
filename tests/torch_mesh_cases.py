"""The cases every mesh step file runs (``test_torch_mesh_zero1``,
``test_torch_mesh_fsdp``, ``test_torch_mesh_dp_only``), each on the
``mesh_run`` fixture of its file: ``(kind, reference npz, the 4 ranks'
npz, the reference's directory)`` of ``torch_port_util.MESH_RUNS[kind]``.

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
from torch_port_util import MESH_LR, MESH_RS_POLICIES, MESH_RUNS, MESH_WARMUP


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
