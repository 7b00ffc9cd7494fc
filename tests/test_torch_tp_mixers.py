"""The recurrent mixers over 'model' (``layers.mamba``, ``layers.mlstm``,
``layers.slstm`` at a model group) at 1, 2 and 4 gloo ranks
(``torch_port_util.tp_mixers_rank``), each rank's output, input gradient
and gradient blocks held against the port's one-rank layer (its block of
each gradient) and against the JAX reference's layer and its
``jax.vjp`` on one device, on the same numpy inputs
(``TP_MIXER_CASES``):

* Mamba (jamba SMOKE: d_model 64, inner width 128, d_state 8) in f32: a
  rank holds the reference's ``P(None, "model")`` block of ``in_proj``,
  contiguous columns of ``[xs | z]`` (at 2 ranks rank 0 holds all of
  ``xs``), and its block of the inner channels of the other leaves; the
  gathered ``x @ in_proj`` gives it its channels of both halves;
* mLSTM and sLSTM (xlstm SMOKE: 2 heads of 32) in bf16: at 2 ranks a head
  a rank; at 4 the projections' columns split inside a head and the gates
  (2 columns) stay whole, so every rank computes both heads; the "_gqa"
  variants (4 query heads over 2 KV heads of 16) at 4 ranks gather the KV
  columns a rank's query head reads;
* sLSTM's unread ``wk`` has a zero gradient in every block (the
  reference's fault, ROADMAP Queue C item 5).

Tolerances: at one rank the layer is the plain one, bit for bit.  Mamba
in f32: within 1e-5 of each array's largest magnitude, against the
one-rank layer (measured 6.4e-7: the row-parallel sums over the ranks
add in another order) and the reference (the one-rank layer's gap to
it measured 7.0e-7).  The bf16 cells, against
the one-rank layer, ``test_torch_tp_ops``' SwiGLU bound: within 2**-7 of
the largest magnitude (one bf16 ulp at it; each rank rounds its partial
``wo`` product before the f32 sum over the ranks, where one rank rounds
the whole product once; measured 0.0068) plus 1% of each value; against
the reference, 1/64 of the largest magnitude, ``test_torch_moe_mla``'s
bound for a bf16 layer and its gradients (XLA:CPU rounds other bf16
products and sums in other places: the one-rank layer's gap to it
measured up to 0.0064, in ``wv``'s gradient).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro_torch.models import layers, transformer
from torch_port_util import (TP_MIXER_CASES, run_gloo_ranks, tp_mixer_arrays, tp_mixer_config,
                             tp_mixer_run, tp_mixer_serve_rank, tp_mixer_serve_run,
                             tp_mixers_rank)

WORLDS = (1, 2, 4)
CASES = sorted(TP_MIXER_CASES)
_RUNS = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def get(world):
        if world not in _RUNS:
            _RUNS[world] = run_gloo_ranks(tp_mixers_rank, world,
                                          tmp_path_factory.mktemp(f"mix{world}"), timeout=300)
        return _RUNS[world]
    return get


@pytest.fixture(scope="module")
def one_rank():
    return {case: tp_mixer_run(case) for case in CASES}


@pytest.fixture(scope="module")
def reference():
    """Per case the reference layer's output and ``jax.vjp`` on one device:
    ``{"y", "dx", "d/<path>"}`` as f32."""
    out = {}
    for case in CASES:
        jcfg, spec = tp_mixer_config(case, "jax")
        w, x, ct = tp_mixer_arrays(case)
        dt = jnp.float32 if jcfg.dtype == "float32" else jnp.bfloat16
        f32_leaves = ("a_log", "d_skip", "dt_bias")
        p = {k: jnp.asarray(a, jnp.float32 if k in f32_leaves else dt) for k, a in w.items()}
        fn = getattr(jL, spec.mixer)
        y, vjp = jax.vjp(lambda p, x: fn(p, x, jcfg)[0], p, jnp.asarray(x, dt))
        dp, dx = vjp(jnp.asarray(ct, dt))
        f = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
        out[case] = {"y": f(y), "dx": f(dx), **{f"d/{k}": f(v) for k, v in dp.items()}}
    return out


def _block(want: np.ndarray, got: np.ndarray, rank: int) -> np.ndarray:
    """This rank's block of a whole array ``want`` of the shape of ``got``
    (the dim where they differ, split into equal blocks)."""
    for d, (a, b) in enumerate(zip(got.shape, want.shape, strict=True)):
        if a != b:
            return np.take(want, range(rank * a, (rank + 1) * a), axis=d)
    return want


def _close(got, want, frac, rel=0.0, ctx=""):
    assert got.shape == want.shape, ctx
    np.testing.assert_allclose(got, want, rtol=rel, atol=np.abs(want).max() * frac, err_msg=ctx)


def _bounds(case) -> tuple:
    """((fraction of the largest magnitude, relative) against the one-rank
    layer, fraction against the reference)."""
    if tp_mixer_config(case)[0].dtype == "float32":
        return (1e-5, 0.0), 1e-5
    return (2.0 ** -7, 1e-2), 1 / 64


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_split_mixer_matches_the_one_rank_layer(ranks, one_rank, world, case):
    (frac, rel), _ = _bounds(case)
    want = one_rank[case]
    for r, res in enumerate(ranks(world)):
        for k, w in want.items():
            got = res[f"{case}/{k}"]
            if world == 1:
                np.testing.assert_array_equal(got, w, err_msg=k)
            else:
                _close(got, _block(w, got, r), frac, rel, f"{case} rank {r} {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_split_mixer_matches_the_reference(ranks, reference, world, case):
    _, frac = _bounds(case)
    want = reference[case]
    for r, res in enumerate(ranks(world)):
        for k, w in want.items():
            got = res[f"{case}/{k}"]
            _close(got, _block(w, got, r), frac, ctx=f"{case} rank {r} {k}")


def test_mamba_in_proj_block_is_the_reference_s_contiguous_block(ranks, one_rank):
    """At 2 ranks: the reference lays ``in_proj`` (d, 2 di) out
    ``P(None, "model")``, so rank 0 holds columns [0, di), all of ``xs``,
    and rank 1 all of ``z``; the port's block is that one (its gradient is
    the one-rank gradient's columns there), and the layer still matches."""
    jcfg, _ = tp_mixer_config("mamba", "jax")
    assert tuple(jL.spec_mamba(jcfg)["in_proj"]) == (None, "model")
    cfg, spec = tp_mixer_config("mamba")
    kept = transformer.block_specs(cfg, 2)
    assert kept["blocks/0/mixer/in_proj"] == (None, None, "model")
    di = cfg.mamba.expand * cfg.d_model
    w = tp_mixer_arrays("mamba")[0]["in_proj"]
    whole = one_rank["mamba"]["d/in_proj"]
    for r, res in enumerate(ranks(2)):
        block = transformer._block(torch.from_numpy(w), kept["blocks/0/mixer/in_proj"][1:],
                                   SimpleNamespace(rank=r, size=2))
        np.testing.assert_array_equal(block.numpy(), w[:, r * di:(r + 1) * di])
        got = res["mamba/d/in_proj"]
        assert got.shape == (cfg.d_model, di)
        _close(got, whole[:, r * di:(r + 1) * di], 1e-5, ctx=f"rank {r}")
        _close(res["mamba/y"], one_rank["mamba"]["y"], 1e-5, ctx=f"rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_slstm_wk_gradient_is_zero_in_every_block(ranks, world):
    for case in ("slstm", "slstm_gqa"):
        for res in ranks(world):
            g = res[f"{case}/d/wk"]
            assert g.size and not g.any()


def test_xlstm_gates_stay_whole_where_heads_are_fewer_than_ranks(ranks):
    """xlstm SMOKE's 2 heads at 4 ranks: ``wi``/``wf`` (d, 2) whole on every
    rank, ``wq`` split 16 columns a rank, inside a head;
    ``check_model_parallel`` accepts it."""
    cfg, _ = tp_mixer_config("mlstm")
    kept = transformer.block_specs(cfg, 4)
    assert kept["blocks/0/mixer/wi"] == (None, None, None)
    assert kept["blocks/0/mixer/wq"] == (None, None, "model")
    assert cfg.n_heads * cfg.hd // 4 % cfg.hd
    transformer.check_model_parallel(cfg, 4)
    for r, res in enumerate(ranks(4)):
        assert res["mlstm/d/wi"].shape == (cfg.d_model, cfg.n_heads), r


def test_serving_forms_refuse_a_model_group(tmp_path):
    """The serving forms no longer refuse a model group: at 2 gloo ranks
    each case's prefill (its state returned) and a decode step from that
    state, on the rank's blocks, give every rank the one-rank layer's
    output and the whole state (the rank reads its channels or heads of
    the whole state, and the new state is gathered over the group), the
    same bits on both ranks.  Tolerances: the file's bounds against the
    one-rank layer (Mamba in f32 1e-5; the bf16 cells 2**-7 of the largest
    magnitude plus 1%)."""
    runs = run_gloo_ranks(tp_mixer_serve_rank, 2, tmp_path, timeout=300)
    for case in CASES:
        cfg, _ = tp_mixer_config(case)
        want = tp_mixer_serve_run(case)
        for key, w in want.items():
            got = runs[0][f"{case}/{key}"]
            np.testing.assert_array_equal(runs[1][f"{case}/{key}"], got, err_msg=key)
            assert got.shape == w.shape, (case, key)
            tol = np.abs(w).max() * (1e-5 if cfg.dtype == "float32" else 2 ** -7)
            rel = 0.0 if cfg.dtype == "float32" else 0.01
            np.testing.assert_allclose(got, w, rtol=rel, atol=tol, err_msg=f"{case} {key}")
