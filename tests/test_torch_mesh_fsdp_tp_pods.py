"""FSDP with tensor parallelism over a (pod 2, data 1, model 2) mesh: the
reference on 4 forced host devices (one subprocess), the port on 4 gloo
ranks, for tinyllama SMOKE (the cheapest arch to compile: the mesh, not
the arch, is what this file adds; jamba's Mamba and MoE run FSDP at (2,
2) in ``test_torch_mesh_fsdp_tp``): the DP group is (pod, data),
pod-major, each model index its own.  The shared cases, as in
``test_torch_mesh_fsdp_tp``.

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

KIND = "fsdp_tp_pods"


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
