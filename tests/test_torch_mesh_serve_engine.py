"""``ServeEngine`` on a model split over 'model' at (data, model) = (1, 2)
(2 gloo ranks), and the cache layouts the port refuses.

* colocated and PD-disaggregated twins (each rank ships its own block of
  every admitted cache over the compressed host wire) give the same
  tokens on both ranks, and those of the engine at model = 1 (SMOKE
  configs in f32: tinyllama, deepseek-v2-lite's MLA and MoE, jamba's
  Mamba, xlstm's cells; 3 requests on 2 slots, a slot refilled, prefills
  of one block or both and decode steps across a block boundary);
* at temperature 0.8 every rank draws the same tokens (each rank's
  generator is seeded 0 and reads the same whole logits);
* ``ingest_weights`` at model > 1 refuses a corrupted update (its
  checksum; ``test_torch_mesh_ingest`` holds full and delta ingestion);
* a cache that ``cache_specs`` would lay out otherwise than the port's
  blocks raises ``ValueError``: a recurrent state with a width equal to
  ``max_len`` (which the specs split over 'model'), and a ``max_len``
  that the mesh does not split; a batch that the DP ranks do not split
  is replicated, as the specs leave it whole.

Tolerances: none; tokens are compared exactly."""
import numpy as np
import pytest

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from torch_mesh_serve_util import ENGINE_ARCHS, ENGINE_NEW, ENGINE_PROMPTS, engine_rank
from torch_port_util import run_gloo_ranks


@pytest.fixture(scope="module")
def engine_run(tmp_path_factory):
    return run_gloo_ranks(engine_rank, 2, tmp_path_factory.mktemp("serve_engine"), timeout=300)


@pytest.fixture(params=ENGINE_ARCHS)
def engine_arch(request):
    return request.param


def test_pd_and_colocated_tokens_are_identical_on_every_rank(engine_run, engine_arch):
    col = engine_run[0][f"{engine_arch}_col"]
    assert col.shape == (len(ENGINE_PROMPTS), ENGINE_NEW)
    for res in engine_run:
        np.testing.assert_array_equal(res[f"{engine_arch}_col"], col)
        np.testing.assert_array_equal(res[f"{engine_arch}_pd"], col)


def test_tokens_are_the_engine_s_at_model_1(engine_run, engine_arch):
    for res in engine_run:
        np.testing.assert_array_equal(res[f"{engine_arch}_col"], res[f"{engine_arch}_one"])


def test_sampled_tokens_are_identical_across_ranks(engine_run, engine_arch):
    a, b = (res[f"{engine_arch}_hot"] for res in engine_run)
    np.testing.assert_array_equal(a, b)


def test_ingest_weights_at_model_2_is_refused(engine_run, engine_arch):
    """A corrupted update is refused on both ranks by its checksum."""
    for res in engine_run:
        assert "checksum" in str(res[f"{engine_arch}_ingest"])


@pytest.mark.parametrize("arch,max_len,leaf", [
    ("xlstm_350m", 32, "blocks/0/rnn/C"),  # hd = 32: C (repeats, B, H, hd, hd)
    ("jamba_v0_1_52b", 8, "blocks/0/ssm/h"),  # d_state = 8: h (repeats, B, di, d_state)
])
def test_a_recurrent_state_split_by_cache_specs_is_refused(arch, max_len, leaf):
    cfg = configs.get_smoke(arch)
    mesh = mesh_lib.AbstractMesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match=f"recurrent state {leaf}"):
        transformer.cache_struct(cfg, 2, max_len, mesh=mesh)
    assert transformer.cache_struct(cfg, 2, max_len, mesh=mesh_lib.AbstractMesh(
        (2, 1), ("data", "model")))["pos"].dim() == 0  # at model = 1 nothing splits


@pytest.mark.parametrize("batch,max_len", [(2, 15), (3, 16)])
def test_a_cache_the_mesh_does_not_split_is_refused(batch, max_len):
    """A ``max_len`` that 'model' does not split is refused; a batch that
    the DP ranks do not split (3 rows over 2) is not: ``cache_specs``
    leaves it whole, and so does the rank's block (every row)."""
    cfg = configs.get_smoke("tinyllama_1_1b")
    mesh = mesh_lib.AbstractMesh((2, 2), ("data", "model"))
    if max_len % 2:
        with pytest.raises(ValueError, match="does not split"):
            transformer.cache_struct(cfg, batch, max_len, mesh=mesh)
        return
    k = transformer.cache_struct(cfg, batch, max_len, mesh=mesh)["blocks"][0]["kv"]["k"]
    assert k.shape[1:3] == (batch, max_len // 2)


def test_the_mesh_block_is_the_cp_shards_cache():
    """``cache_struct(mesh=)`` at (1, 4) is the reference's ``init_cache(...,
    cp_shards=4)`` form: every K/V leaf a quarter of ``max_len`` long."""
    cfg = configs.get_smoke("gemma3_27b")
    a = transformer.cache_struct(cfg, 2, 16, mesh=mesh_lib.AbstractMesh((1, 4),
                                                                        ("data", "model")))
    b = transformer.cache_struct(cfg, 2, 16, cp_shards=4)
    assert [(p, t.shape) for p, t in transformer.tree_paths(a)] == \
        [(p, t.shape) for p, t in transformer.tree_paths(b)]
    assert b["blocks"][0]["kv"]["k"].shape[2] == 4
