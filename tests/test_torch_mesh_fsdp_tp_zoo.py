"""FSDP with tensor and expert parallelism over 'model' at (data, model) =
(2, 2), as ``test_torch_mesh_fsdp_tp``, for qwen2-vl (its batch's
``vision_embeds`` replace the leading positions after the
vocabulary-parallel embedding's sum) and deepseek-v3 (its dense prefix
layer and one MoE layer, MLA, in f32, on Adafactor factored from 8 wide,
so its row and column means and its RMS clip run over the model group)
at SMOKE size.  The shared cases, as in ``test_torch_mesh_fsdp_tp``.

Tolerances: as ``torch_mesh_cases`` states."""
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

KIND = "fsdp_tp_zoo"


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
