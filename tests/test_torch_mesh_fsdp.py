"""FSDP over a (pod 2, data 2, model 1) mesh: the reference on 4 forced
host devices (one subprocess), the port on 4 gloo ranks, ``fsdp_min_bytes
= 0`` so every leaf that the DP size divides is sharded.

The shared cases (``torch_mesh_cases``): the ranks' pod-major DP index;
the gather of a seeded shard over (pod, data) and the reduce-scatter of a
seeded cotangent in its backward, bit for bit (fused, unfused, raw); one
step from the reference's step-0 checkpoint, restored onto the mesh with
``restore(shardings=)`` (each rank its shards), against its step
1 at the one-device test's tolerances; compressed and raw twins
identical; the reference's step-1 checkpoint restored onto the mesh
gives each rank its optimizer rows bit for bit, and the port's 4-rank
save of it (shards joined, rank 0 writes) is the reference's checkpoint;
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

KIND = "fsdp"


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    ref_dir = tmp_path_factory.mktemp(f"{KIND}_ref")
    ref = run_mesh_reference(KIND, ref_dir)
    ranks = run_gloo_ranks(mesh_rank, 4, tmp_path_factory.mktemp(f"{KIND}_ranks"), KIND,
                           str(ref_dir), timeout=400)
    return KIND, ref, ranks, ref_dir
