"""The cases of the serving files at model > 1 (``test_torch_mesh_serve``
at (2, 2), ``test_torch_mesh_serve_heads`` at (1, 4)), each on the
``serve_run`` fixture of its file, ``(kind, reference npz, the 4 ranks'
npz)`` of ``torch_mesh_serve_util.SERVE_MESHES[kind]``, and on
``serve_arch``.

Tolerances, a fraction of the largest magnitude of what is compared:
* the port on the mesh against the port at model = 1, in f32: 1e-5 (the
  same f32 operations, the partial softmaxes' and the row-parallel
  products' sums in another order; measured at most 5.9e-6);
* against the reference (its one-device run, and its GSPMD run over the
  serving layouts at (2, 2)), the one-device serve tests' bounds:
  tinyllama 1/64 (``test_torch_serve``'s, a dense llama), gemma3, xlstm
  and whisper 1/32 (``test_torch_models``'s zoo bound: XLA:CPU's bf16
  logistic rounds inside), deepseek-v2-lite and jamba, which run in f32
  (``torch_port_util.TP_F32``: their MoE routers' bf16 near ties), 1e-4
  (``test_torch_models``' bound of an f32 model);
* recurrent states, greedy tokens and logits across the model ranks of a
  DP index: bit for bit."""
import numpy as np

from torch_mesh_serve_util import (SERVE_BATCH, SERVE_MAX_LEN, SERVE_MESHES, SERVE_PROMPT,
                                   SERVE_PROMPTS_F32, SERVE_STEPS, block_of_global, upto)
from torch_port_util import TP_F32, tp_configs

REF_TOL = {"tinyllama_1_1b": 1 / 64}  # else 1/32, or 1e-4 in f32 (TP_F32)


def ref_tol(arch: str) -> float:
    return 1e-4 if arch in TP_F32 else REF_TOL.get(arch, 1 / 32)


def _mesh(kind: str) -> tuple:
    (n_dp, n_model), _ = SERVE_MESHES[kind]
    return n_dp, n_model


def _close(got, want, tol, ctx):
    assert got.shape == want.shape, (ctx, got.shape, want.shape)
    if want.size == 0:
        return
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (ctx, err, np.abs(want).max())


def _leaves(res: dict, pre: str) -> dict:
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _block_start(path: str, r: int, block: np.ndarray) -> int:
    """The global position a rank's K/V block starts at."""
    return r * block.shape[2 if path.startswith("blocks/") else 1] if "/kv/" in path else 0


def test_serve_ranks_take_their_dp_index_and_model_rank(serve_run):
    kind, _, ranks = serve_run
    _, n_model = _mesh(kind)
    assert [(int(r["idx"]), int(r["mrank"])) for r in ranks] == \
        [(i // n_model, i % n_model) for i in range(4)]


def test_serve_blocks_match_the_port_at_model_1(serve_run, serve_arch):
    """In f32, for a prompt shorter than a block and one longer, then
    decode steps across block boundaries: each rank's logits (its rows)
    and its cache block (K/V at its positions, the recurrent states whole)
    within 1e-5 of the port's at model = 1, its greedy tokens the same."""
    kind, ref, ranks = serve_run
    n_dp, n_model = _mesh(kind)
    per = SERVE_BATCH // n_dp
    for res in ranks:
        idx, r = int(res["idx"]), int(res["mrank"])
        rows = slice(idx * per, (idx + 1) * per)
        for S in SERVE_PROMPTS_F32:
            pre = f"{serve_arch}_f32_{S}"
            ctx = (kind, serve_arch, S, idx, r)
            _close(res[f"{pre}_logits"], ref[f"{pre}_one_logits"][rows], 1e-5, ctx)
            np.testing.assert_array_equal(res[f"{pre}_tokens"], ref[f"{pre}_one_tokens"][rows])
            whole, got = _leaves(ref, f"{pre}_one_cache/"), _leaves(res, f"{pre}_cache/")
            assert sorted(whole) == sorted(got)
            for path, a in whole.items():
                want = block_of_global(a, path, idx, n_dp, r, n_model)
                _close(got[path], want, 1e-5, ctx + (path,))


def test_serve_states_and_tokens_are_identical_across_model_ranks(serve_run, serve_arch):
    """Within a DP index every model rank holds the same recurrent states
    and the same whole logits, and so samples the same tokens."""
    kind, _, ranks = serve_run
    _, n_model = _mesh(kind)
    for i in range(0, 4, n_model):
        first = ranks[i]
        for res in ranks[i + 1:i + n_model]:
            for key, a in first.items():
                if not key.startswith(serve_arch) or "/kv/" in key:
                    continue
                if "_cache/" in key or key.endswith(("_logits", "_tokens")):
                    np.testing.assert_array_equal(res[key], a, err_msg=key)


def test_serve_matches_the_reference_one_device(serve_run, serve_arch):
    """The reference's weights, batch and decode tokens: each rank's
    logits against the reference's one-device ``prefill``/``decode_step``
    on its rows, and its cache block against the block of the reference's
    global cache ``cache_specs`` gives it, at positions below ``pos``."""
    kind, ref, ranks = serve_run
    n_dp, n_model = _mesh(kind)
    tol = ref_tol(serve_arch)
    per = SERVE_BATCH // n_dp
    pos = SERVE_PROMPT + SERVE_STEPS
    for res in ranks:
        idx, r = int(res["idx"]), int(res["mrank"])
        ctx = (kind, serve_arch, idx, r)
        _close(res[f"{serve_arch}_logits"],
               ref[f"{serve_arch}_one_logits"][idx * per:(idx + 1) * per], tol, ctx)
        got = _leaves(res, f"{serve_arch}_cache/")
        want = {p: a for p, a in _leaves(ref, f"{serve_arch}_one_cache/").items() if a.ndim}
        assert sorted(got) == sorted(want)
        for path, a in want.items():
            blk = block_of_global(a, path, idx, n_dp, r, n_model)
            start = _block_start(path, r, blk)
            _close(upto(got[path], path, start, pos), upto(blk, path, start, pos), tol,
                   ctx + (path,))


def test_serve_matches_the_reference_gspmd(serve_run, serve_arch):
    """At (2, 2): each rank's logits against the reference's GSPMD run
    (parameters by ``serve_param_specs`` with some leaves split over
    'data' too, cache by ``cache_specs``), and its cache block, of the
    shape ``cache_specs`` gives that device's shard, against the shard at
    positions below ``pos``; the port's model holds leaves split over
    'data', gathered at their use."""
    kind, ref, ranks = serve_run
    n_dp, n_model = _mesh(kind)
    tol = ref_tol(serve_arch)
    per = SERVE_BATCH // n_dp
    pos = SERVE_PROMPT + SERVE_STEPS
    for d, res in enumerate(ranks):
        idx, r = int(res["idx"]), int(res["mrank"])
        ctx = (kind, serve_arch, idx, r)
        assert int(res[f"{serve_arch}_dp_split"]) > 0
        _close(res[f"{serve_arch}_logits"],
               ref[f"{serve_arch}_gspmd_logits"][idx * per:(idx + 1) * per], tol, ctx)
        got = _leaves(res, f"{serve_arch}_cache/")
        shards = {k[:-len(f"/{d}")]: v for k, v in _leaves(ref, f"{serve_arch}_gspmd_cache/")
                  .items() if k.endswith(f"/{d}") and v.ndim}
        assert sorted(got) == sorted(shards)
        for path, want in shards.items():
            assert got[path].shape == want.shape, (ctx, path)
            start = _block_start(path, r, want)
            _close(upto(got[path], path, start, pos), upto(want, path, start, pos), tol,
                   ctx + (path,))


def test_cache_blocks_have_the_cache_specs_shapes(serve_run, serve_arch):
    """Every rank's block has the per-device shape ``cache_specs`` gives
    the reference's global cache of SERVE_BATCH rows and SERVE_MAX_LEN
    positions (the port's specs on an abstract mesh of the kind's shape)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer
    from repro_torch.serve import sharding

    kind, _, ranks = serve_run
    mesh = mesh_lib.AbstractMesh(SERVE_MESHES[kind][0], ("data", "model"))
    cfg = tp_configs(serve_arch)[0]
    specs, struct = sharding.cache_specs(cfg, mesh, SERVE_BATCH, SERVE_MAX_LEN)
    shapes = {p: mesh_lib.shard_shape(t.shape, s, mesh) for (p, t), (_, s) in
              zip(transformer.tree_paths(struct), transformer.tree_paths(specs)) if t.dim()}
    for res in ranks:
        got = {p: a.shape for p, a in _leaves(res, f"{serve_arch}_cache/").items()}
        assert got == shapes
