"""ZeRO-1 with tensor and expert parallelism over 'model' at (data, model)
= (2, 2): the reference on 4 forced host devices (one subprocess), the
port on 4 gloo ranks, for tinyllama, gemma3 (a prefix layer, a sliding
window, the tied vocabulary-parallel head), deepseek-v2-lite (MLA; 8
experts over 2 ranks) and whisper (the encoder and cross-attention,
through ``train_step``) at SMOKE size.

* the shared cases (``torch_mesh_cases``, the ``tp_`` ones): DP index and
  model rank, the reduce-scattered shards over 'data' within each model
  index bit for bit, each rank's blocks of the reference's init (loaded
  and restored) bit for bit, the blocks of ``init(mesh=)`` joining to the
  one-rank init, each model rank's bucket meta, one step from the
  reference's state, the compressed and raw twins, the replicated leaves
  the same on every rank;
* the checkpoint of tinyllama's step-1 state, saved by the port's 4 ranks
  (gathered, rank 0 writes), is the reference's: parameters whole and the
  ZeRO-1 rows ``(n_dp, n_model * shard_len)``; restored without
  shardings each rank takes its part back;
* an overflow forced on one rank alone (model rank 1 of DP index 1)
  makes every rank retry the step raw (the flag is the max over the DP
  group and the model group; the reference keeps each device's own flag
  and one model rank's), and the run ends where the compressed twin does;
* the grad norm (deepseek-v2-lite in f32) is the reference's: the sum of
  the squares over (data, model), which counts each leaf that 'model'
  replicates once a model rank, not the norm of the whole gradient.

Tolerances: as ``torch_mesh_cases`` states."""
import json
import os

import numpy as np
import pytest

from torch_mesh_cases import (test_tp_blocks_equal_the_reference_shards,  # noqa: F401
                              test_tp_bucket_meta_equals_the_reference,
                              test_tp_compressed_and_raw_twins_are_identical,
                              test_tp_init_blocks_join_to_the_one_rank_init,
                              test_tp_ranks_take_their_dp_index_and_model_rank,
                              test_tp_reduce_scatter_shards_equal_the_reference,
                              test_tp_replicated_leaves_are_identical_across_ranks,
                              test_tp_step_from_the_reference_state_matches_it)
from torch_port_util import (TP_CKPT_ARCH, TP_RUNS, mesh_tp_rank, run_gloo_ranks,
                             run_mesh_tp_reference)

KIND = "tp"


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    ref_dir = tmp_path_factory.mktemp(f"{KIND}_ref")
    ref = run_mesh_tp_reference(KIND, ref_dir)
    ranks = run_gloo_ranks(mesh_tp_rank, 4, tmp_path_factory.mktemp(f"{KIND}_ranks"), KIND,
                           str(ref_dir), timeout=500)
    return KIND, ref, ranks, ref_dir


@pytest.fixture(params=TP_RUNS[KIND][2])
def tp_arch(request):
    return request.param


def _manifest(d) -> dict:
    with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
        return json.load(f)["files"]


def test_port_checkpoint_is_the_reference_s(tp_run):
    """Names, shapes and dtype names; f32 and int32 files the reference's
    sha256s, bf16 files its bytes; the ZeRO-1 leaves ``(2, 2 * shard_len)``;
    each rank's restore of it bit-identical, its leaves holding only its
    own part."""
    _, _, ranks, ref_dir = tp_run
    want_dir, got_dir = ref_dir / TP_CKPT_ARCH / "ckpt", ref_dir / "port_ckpt"
    want, got = _manifest(want_dir), _manifest(got_dir)
    assert [(k, e["file"], e["shape"], e["dtype"]) for k, e in got.items()] == \
        [(k, e["file"], e["shape"], e["dtype"]) for k, e in want.items()]
    assert all(e["shape"][0] == 2 for k, e in got.items()
               if k.startswith("opt/") and k != "opt/count")
    for k, e in got.items():
        if e["dtype"] == "bfloat16":
            a = np.load(got_dir / "step_00000001" / e["file"])
            b = np.load(want_dir / "step_00000001" / want[k]["file"])
            assert a.tobytes() == b.tobytes(), k
        else:
            assert e["sha256"] == want[k]["sha256"], k
    for res in ranks:
        assert int(res["resume_exact"]) and res["own_storage"].all()


def test_overflow_on_one_rank_retries_every_rank(tp_run):
    _, _, ranks, _ = tp_run
    a = TP_CKPT_ARCH
    for res in ranks:
        assert int(res["forced_retries"]) == 1
        assert np.array_equal(res["forced_losses"], res[f"{a}_comp_losses"])
        assert np.array_equal(res["forced_params"], res[f"{a}_comp_params"])


def test_grad_norm_counts_replicated_leaves_once_a_model_rank(tp_run):
    """The reference sums the squared norm over (dp, model) with the note
    "shards are disjoint over dp AND model"
    (``src/repro/optim/zero1.py:205-208``), but a leaf 'model' replicates
    (the norms, the router, MLA's down-projections, the final norm) sits
    in every model rank's bucket.  Against the whole gradient of the step
    on one rank (f32, the reference's step-0 weights, the global batch):
    the port's grad norm, equal to the reference's, is that sum with the
    replicated leaves counted n_model = 2 times, and not the gradient's
    norm."""
    import torch
    import ml_dtypes

    from repro_torch.models import registry, transformer
    from repro_torch.train import step as step_lib
    from torch_port_util import TP_RUNS, tp_batch_shape, tp_configs

    _, ref, ranks, _ = tp_run
    a = "deepseek_v2_lite_16b"
    cfg = tp_configs(a)[0]
    n_model = TP_RUNS[KIND][0][-1]
    dts = transformer.leaf_dtypes(cfg)
    tree = {p: ref[f"{a}_param/{p}"].view(
        ml_dtypes.bfloat16 if dts[p] == torch.bfloat16 else np.float32) for p in dts}
    model = transformer.load_reference_params(tree, cfg, "cpu")
    b = registry.make_batch(cfg, *tp_batch_shape(a), rng=np.random.default_rng(0), device="cpu")
    n_dp = TP_RUNS[KIND][0][0]
    rows = b["tokens"].shape[0] // n_dp
    tcfg = step_lib.TrainConfig(loss_chunk=16, remat=False)
    for i in range(n_dp):  # the mean over the DP ranks' rows, as the RS takes it
        (step_lib.loss_fn(model, {k: v[i * rows:(i + 1) * rows] for k, v in b.items()},
                          tcfg) / n_dp).backward()
    kept = transformer.block_specs(cfg, n_model)
    sq = {True: 0.0, False: 0.0}
    for path, p in model.params.items():
        sq["model" in kept[path]] += float(torch.sum(p.grad.double() ** 2))
    whole = np.sqrt(sq[True] + sq[False])
    counted = np.sqrt(sq[True] + n_model * sq[False])
    got = float(ranks[0][f"{a}_gnorm"])
    assert got == pytest.approx(float(ref[f"{a}_gnorm"]), rel=1e-5)
    assert got == pytest.approx(counted, rel=1e-4)
    assert abs(got - whole) > 1e-3 * whole, (got, whole, counted)
