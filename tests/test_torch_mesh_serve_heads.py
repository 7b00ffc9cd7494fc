"""Serving at (data, model) = (1, 4): ``prefill`` and ``decode_step`` on
each rank's blocks, a quarter of the cache's positions a rank (a prompt
longer than a block, decode steps across a block boundary), for the
archs of ``test_torch_mesh_serve`` at SMOKE size: tinyllama's 2 KV heads
of 16 columns split 8 columns a rank, inside a head (each rank gathers
every KV head's K/V), xlstm's 2 heads split inside a head (every rank
computes every head), deepseek-v2-lite's 8 experts 2 a rank.  The
reference on 4 forced host devices (one subprocess; its one-device run),
the port on 4 gloo ranks; the shared cases of ``torch_mesh_serve_cases``.

Tolerances: as ``torch_mesh_serve_cases`` states."""
import pytest

from torch_mesh_serve_cases import (test_cache_blocks_have_the_cache_specs_shapes,  # noqa: F401
                                    test_serve_blocks_match_the_port_at_model_1,
                                    test_serve_matches_the_reference_one_device,
                                    test_serve_ranks_take_their_dp_index_and_model_rank,
                                    test_serve_states_and_tokens_are_identical_across_model_ranks)
from torch_mesh_serve_util import SERVE_ARCHS, mesh_serve_rank, run_mesh_serve_reference
from torch_port_util import run_gloo_ranks

KIND = "serve_heads"


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    ref = run_mesh_serve_reference(KIND, tmp_path_factory.mktemp(f"{KIND}_ref"))
    ranks = run_gloo_ranks(mesh_serve_rank, 4, tmp_path_factory.mktemp(f"{KIND}_ranks"), KIND,
                           timeout=500)
    return KIND, ref, ranks


@pytest.fixture(params=SERVE_ARCHS)
def serve_arch(request):
    return request.param
