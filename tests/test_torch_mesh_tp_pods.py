"""ZeRO-1 with tensor and expert parallelism over 'model' at (pod, data,
model) = (2, 1, 2), the reference's ``make_smoke_mesh(4, pods=2)``: the
reference on 4 forced host devices (one subprocess), the port on 4 gloo
ranks, for tinyllama and deepseek-v2-lite (MLA; 8 experts over 2 ranks)
at SMOKE size.  The shared ``tp_`` cases of ``torch_mesh_cases``: the
pod-major DP index over (pod, data) and the model rank, the
reduce-scattered shards bit for bit, the blocks of the reference's init
(loaded and restored) and of ``init(mesh=)``, each model rank's bucket
meta, one step from the reference's state, the twins, the replicated
leaves.

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

KIND = "tp_pods"


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
