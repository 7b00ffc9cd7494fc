"""FSDP with tensor and expert parallelism over 'model' at (data, model) =
(2, 2): the reference on 4 forced host devices (one subprocess), the port
on 4 gloo ranks, ``fsdp_min_bytes = 0``, for tinyllama and jamba (cut to
(Mamba, MoE) then (attention, SwiGLU), in f32) at SMOKE size
(``test_torch_mesh_fsdp_tp_zoo`` runs qwen2-vl and deepseek-v3 on the
same mesh).

* the shared cases (``torch_mesh_cases``, the ``tp_`` ones and the
  ``fsdp_tp`` checkpoint): DP index and model rank; the gather of each
  rank's model-local shard over 'data' within its model index and the
  reduce-scatter of its backward, bit for bit; each rank's DP shard of
  its model block of every parameter from the reference's state (loaded
  and restored) bit for bit, its optimizer leaves both ways the same; the
  blocks of ``init(mesh=)`` joining to the one-rank init; one step from
  the reference's state (the grad norm counting each leaf once, as the
  reference's GSPMD-global sum over 'model'); the compressed and raw
  twins; the leaves no axis splits the same on every rank; each arch's
  checkpoint, saved by the port's 4 ranks, is the reference's;
* the grad norm (jamba in f32) is the norm of the whole gradient, each
  leaf counted once, not the ZeRO-1 step's count.

Tolerances: as ``torch_mesh_cases`` states."""
import numpy as np
import pytest

from torch_mesh_cases import (test_fsdp_tp_checkpoint_is_the_reference_s,  # noqa: F401
                              test_fsdp_tp_gather_plans_are_keyed_by_model_local_shards,
                              test_tp_blocks_equal_the_reference_shards,
                              test_tp_compressed_and_raw_twins_are_identical,
                              test_tp_init_blocks_join_to_the_one_rank_init,
                              test_tp_ranks_take_their_dp_index_and_model_rank,
                              test_tp_reduce_scatter_shards_equal_the_reference,
                              test_tp_replicated_leaves_are_identical_across_ranks,
                              test_tp_step_from_the_reference_state_matches_it)
from torch_port_util import TP_RUNS, mesh_tp_rank, run_gloo_ranks, run_mesh_tp_reference

KIND = "fsdp_tp"


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    ref_dir = tmp_path_factory.mktemp(f"{KIND}_ref")
    ref = run_mesh_tp_reference(KIND, ref_dir)
    ranks = run_gloo_ranks(mesh_tp_rank, 4, tmp_path_factory.mktemp(f"{KIND}_ranks"), KIND,
                           str(ref_dir), timeout=600)
    return KIND, ref, ranks, ref_dir


@pytest.fixture(params=TP_RUNS[KIND][2])
def tp_arch(request):
    return request.param


def test_fsdp_grad_norm_counts_each_leaf_once(tp_run):
    """The reference's FSDP step takes the norm of the whole gradient: its
    squares summed over 'model' by GSPMD, each leaf once, and over the DP
    shards (``src/repro/train/step.py:681-690``).  Against the gradient of
    the same step on one rank (f32, the reference's step-0 weights, the
    global batch): the port's grad norm equals the reference's and that
    norm (measured within 3e-8), and parts from the ZeRO-1 step's count
    (the leaves 'model' replicates counted once a model rank)."""
    import ml_dtypes
    import torch

    from repro_torch.models import registry, transformer
    from repro_torch.train import step as step_lib
    from torch_port_util import tp_batch_shape, tp_configs

    _, ref, ranks, _ = tp_run
    a = "jamba_v0_1_52b"
    cfg = tp_configs(a)[0]
    (n_dp, n_model), _, _ = TP_RUNS[KIND]
    dts = transformer.leaf_dtypes(cfg)
    tree = {p: ref[f"{a}_param/{p}"].view(
        ml_dtypes.bfloat16 if dts[p] == torch.bfloat16 else np.float32) for p in dts}
    model = transformer.load_reference_params(tree, cfg, "cpu")
    b = registry.make_batch(cfg, *tp_batch_shape(a), rng=np.random.default_rng(0), device="cpu")
    rows = b["tokens"].shape[0] // n_dp
    tcfg = step_lib.TrainConfig(loss_chunk=16, remat=False)
    for i in range(n_dp):  # the mean over the DP ranks' rows
        (step_lib.loss_fn(model, {k: v[i * rows:(i + 1) * rows] for k, v in b.items()},
                          tcfg) / n_dp).backward()
    kept = transformer.block_specs(cfg, n_model)
    sq = {True: 0.0, False: 0.0}
    for path, p in model.params.items():
        sq["model" in kept[path]] += float(torch.sum(p.grad.double() ** 2))
    whole = np.sqrt(sq[True] + sq[False])
    zero1_count = np.sqrt(sq[True] + n_model * sq[False])
    for res in ranks:
        got = float(res[f"{a}_gnorm"])
        assert got == pytest.approx(float(ref[f"{a}_gnorm"]), rel=1e-5)
        assert got == pytest.approx(whole, rel=1e-6)
        # jamba's replicated leaves (norms, router) are a small part of it:
        # the ZeRO-1 count parts by 4.2e-4, 100 times the bound above
        assert abs(got - zero1_count) > 1e-4 * zero1_count, (got, whole, zero1_count)
