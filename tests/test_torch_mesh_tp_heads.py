"""ZeRO-1 with tensor and expert parallelism over 'model' at (data,
model) = (1, 4): the reference on 4 forced host devices (one subprocess),
the port on 4 gloo ranks, for tinyllama SMOKE, whose 2 KV heads of 16
columns split 8 columns a rank, inside a head (each rank gathers the
projected K/V over 'model' before attention, as GSPMD reshards them),
and deepseek-v2-lite SMOKE (8 experts over 4 ranks, 2 a rank).  The
shared ``tp_`` cases of ``torch_mesh_cases``, as in
``test_torch_mesh_tp``.

Tolerances: as ``torch_mesh_cases`` states."""
import pytest

from torch_mesh_cases import (test_tp_blocks_equal_the_reference_shards,  # noqa: F401
                              test_tp_bucket_meta_equals_the_reference,
                              test_tp_compressed_and_raw_twins_are_identical,
                              test_tp_init_blocks_join_to_the_one_rank_init,
                              test_tp_ranks_take_their_dp_index_and_model_rank,
                              test_tp_reduce_scatter_shards_equal_the_reference,
                              test_tp_replicated_leaves_are_identical_across_ranks,
                              test_tp_step_from_the_reference_state_matches_it)
from torch_port_util import TP_RUNS, mesh_tp_rank, run_gloo_ranks, run_mesh_tp_reference

KIND = "tp_heads"


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
