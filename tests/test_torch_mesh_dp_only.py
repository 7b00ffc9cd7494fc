"""ZeRO-1 under ``dp_only`` over a (data 2, model 2) mesh: the parameters
replicated over 'model', which carries batch rows, and the sync one
exchange over (data, model) (the reference gates it by those axes, and
'model' is not a compressed axis, so both packages run it raw).  The
reference on 4 forced host devices (one subprocess), the port on 4 gloo
ranks.

The shared cases (``torch_mesh_cases``): the ranks' data-major index over
(data, model); the reduce-scattered f32 gradient shards bit for bit; one
step from the reference's step-0 checkpoint restored onto the mesh,
against its step 1 at the one-device test's tolerances, the grad norm
summed over both axes; compressed and raw twins identical; the
reference's step-1 ZeRO-1 rows restored on every rank bit for bit, and
the port's 4-rank save of that state is the reference's checkpoint;
restored either way, each rank's leaves hold only its own part.
Tolerances: as ``torch_mesh_cases`` states."""
import pytest

from torch_mesh_cases import (test_compressed_and_raw_twins_are_identical,  # noqa: F401
                              test_port_checkpoint_is_the_reference_s,
                              test_ranks_take_the_pod_major_dp_index,
                              test_reduce_scatter_shards_equal_the_reference,
                              test_reference_checkpoint_restores_its_rows_on_every_rank,
                              test_restored_leaves_hold_only_this_rank_s_part,
                              test_step_from_the_reference_state_matches_it)
from torch_port_util import mesh_rank, run_gloo_ranks, run_mesh_reference

KIND = "dp_only"


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    ref_dir = tmp_path_factory.mktemp(f"{KIND}_ref")
    ref = run_mesh_reference(KIND, ref_dir)
    ranks = run_gloo_ranks(mesh_rank, 4, tmp_path_factory.mktemp(f"{KIND}_ranks"), KIND,
                           str(ref_dir), timeout=400)
    return KIND, ref, ranks, ref_dir

