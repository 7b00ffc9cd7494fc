"""Serving at (data, model) = (2, 2): ``prefill`` and ``decode_step`` on
each rank's blocks of the weights and of the KV cache, for tinyllama (GQA),
gemma3 (a sliding window, a prefix layer), deepseek-v2-lite (MLA, MoE
over 'model', a prefix layer), jamba (Mamba), xlstm (mLSTM, sLSTM) and
whisper (the encoder, cross-attention) at SMOKE size: the reference on 4
forced host devices (one subprocess), the port on 4 gloo ranks
(``torch_mesh_serve_util``).

* the shared cases (``torch_mesh_serve_cases``): each rank's logits and
  cache block against the port at model = 1 in f32, states and tokens
  identical across model ranks, logits and cache blocks against the
  reference's one-device run and its GSPMD run over ``serve_param_specs``
  (some leaves split over 'data' too) and ``cache_specs``, the blocks'
  shapes;
* the reference's context-parallel MLA decode (``mla_attention(cp_axis=)``
  under ``shard_map``, 2 shards of 4 positions) writes each new latent at
  its global position on every shard, so it parts from its own one-device
  decode from position 4 = ``s_loc`` on; the port's, on the 2 ranks of a
  model group, writes at the owner and does not part.

Tolerances: as ``torch_mesh_serve_cases`` states; the MLA gaps: below
1e-5 (f32) where the decodes agree, above 0.1 where the reference's
parts."""
import numpy as np
import pytest

from torch_mesh_serve_cases import (test_cache_blocks_have_the_cache_specs_shapes,  # noqa: F401
                                    test_serve_blocks_match_the_port_at_model_1,
                                    test_serve_matches_the_reference_gspmd,
                                    test_serve_matches_the_reference_one_device,
                                    test_serve_ranks_take_their_dp_index_and_model_rank,
                                    test_serve_states_and_tokens_are_identical_across_model_ranks)
from torch_mesh_serve_util import (MLA_MAX_LEN, SERVE_ARCHS, mesh_serve_rank,
                                   run_mesh_serve_reference)
from torch_port_util import run_gloo_ranks

KIND = "serve"


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    ref = run_mesh_serve_reference(KIND, tmp_path_factory.mktemp(f"{KIND}_ref"))
    ranks = run_gloo_ranks(mesh_serve_rank, 4, tmp_path_factory.mktemp(f"{KIND}_ranks"), KIND,
                           timeout=500)
    return KIND, ref, ranks


@pytest.fixture(params=SERVE_ARCHS)
def serve_arch(request):
    return request.param


def test_reference_cp_axis_mla_decode_parts_and_the_port_s_does_not(serve_run):
    _, ref, ranks = serve_run
    s_loc = MLA_MAX_LEN // 2
    gaps = ref["mla_cp_gaps"]
    assert (gaps[:s_loc] < 1e-5).all() and (gaps[s_loc:] > 0.1).all(), gaps
    for res in ranks:
        assert (res["mla_cp_gaps"] < 1e-5).all(), res["mla_cp_gaps"]
