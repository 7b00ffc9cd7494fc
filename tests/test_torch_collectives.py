"""The port's compressed collectives held against the JAX reference
(``repro.core.compressed_collectives``).

Tolerances:
* the wire (every field of ``_encode_chunks``) and every decode: none, bit
  for bit, for all five formats;
* the f32 decode+reduce: bit for bit, NaN matched as NaN (fp8 NaNs widen to
  f32 with another payload in JAX than in torch), on inputs without
  subnormal values, because XLA:CPU flushes f32 subnormals to zero and the
  port keeps them (``test_torch_kernels`` holds that against numpy);
* the WireReport accounting: equal field by field.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import compressed_collectives as jcc
from repro.core import policy as jpolicy
from repro.launch.mesh import make_smoke_mesh
from repro_torch.core import codec
from repro_torch.core import compressed_collectives as cc
from repro_torch.core import policy
from repro_torch.launch.train import single_process_group
from torch_port_util import (FORMATS, assert_bits_equal, collectives_rank,
                             grad_like_bits, np_of, run_gloo_ranks, to_jax,
                             to_torch)

CHUNKS, CHUNK = 3, 512 * 6


def assert_f32_equal_nan_as_nan(got, want, ctx=""):
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape, (ctx, g.shape, w.shape)
    nan = np.isnan(g.view(np.float32)) & np.isnan(w.view(np.float32))
    bad = np.flatnonzero((g != w) & ~nan)
    assert bad.size == 0, (ctx, f"{bad.size} differ; first at {bad[0]}")


def _wires(fmt, width, *, subnormals=True, exc_frac=0.02):
    bits = grad_like_bits(fmt, CHUNKS * CHUNK, seed=21, subnormals=subnormals)
    x = to_torch(bits, fmt).reshape(CHUNKS, CHUNK)
    jx = to_jax(bits, fmt).reshape(CHUNKS, CHUNK)
    kw = dict(width=width, block=512, exc_frac=exc_frac)
    return cc._encode_chunks(x, **kw), jcc._encode_chunks(jx, **kw)


@pytest.mark.parametrize("fmt", FORMATS)
def test_encode_and_decode_chunks_match_reference(fmt):
    wire, jwire = _wires(fmt, 5)
    assert set(wire) == set(jwire)
    for k in jwire:
        assert_bits_equal(wire[k], jwire[k], f"{fmt} {k}")
    assert cc.wire_nbytes(wire) == jcc.wire_nbytes(jwire)
    vals, flag = cc._decode_chunks(wire, dtype=getattr(torch, fmt), n=CHUNK,
                                   width=5, block=512)
    jvals, jflag = jcc._decode_chunks(jwire, dtype=jnp.dtype(fmt), n=CHUNK,
                                      width=5, block=512)
    assert_bits_equal(vals, jvals, f"{fmt} decode")
    assert int(flag) == int(jflag) == 0


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_chunks_in_slices_matches_reference(fmt, monkeypatch):
    """A chunk of more than MERGE_SLICE values merges a slice of columns at
    a time (1000 here: the last slice ragged) with the reference's bits."""
    wire, jwire = _wires(fmt, 5)
    monkeypatch.setattr(codec, "MERGE_SLICE", 1000)
    vals, flag = cc._decode_chunks(wire, dtype=getattr(torch, fmt), n=CHUNK,
                                   width=5, block=512)
    jvals, jflag = jcc._decode_chunks(jwire, dtype=jnp.dtype(fmt), n=CHUNK,
                                      width=5, block=512)
    assert_bits_equal(vals, jvals, f"{fmt} sliced decode")
    assert int(flag) == int(jflag) == 0


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("with_acc", [False, True])
def test_decode_reduce_chunks_matches_reference(fmt, with_acc):
    """Rank-order streaming reduce with the exact exception patch-up."""
    wire, jwire = _wires(fmt, 5, subnormals=False)
    acc = (np.random.default_rng(22).normal(0, 1, CHUNK).astype(np.float32)
           if with_acc else None)
    got, flag = cc._decode_reduce_chunks(
        wire, dtype=getattr(torch, fmt), n=CHUNK, width=5, block=512,
        acc=None if acc is None else torch.from_numpy(acc))
    want, jflag = jcc._decode_reduce_chunks(
        jwire, dtype=jnp.dtype(fmt), n=CHUNK, width=5, block=512,
        acc=None if acc is None else jnp.asarray(acc))
    assert int(flag) == int(jflag) == 0
    assert_f32_equal_nan_as_nan(got, want, fmt)
    # the same as decoding first and summing in rank order
    vals, _ = cc._decode_chunks(wire, dtype=getattr(torch, fmt), n=CHUNK,
                                width=5, block=512)
    seq = cc._seq_sum(vals) if acc is None else cc._seq_sum(
        torch.cat([torch.from_numpy(acc)[None], vals.to(torch.float32)]))
    assert_f32_equal_nan_as_nan(got, seq, f"{fmt} vs seq_sum")


def test_overflow_flag_matches_reference():
    wire, jwire = _wires("bfloat16", 1, exc_frac=1e-9)
    for k in jwire:
        assert_bits_equal(wire[k], jwire[k], k)
    _, flag = cc._decode_reduce_chunks(wire, dtype=torch.bfloat16, n=CHUNK,
                                       width=1, block=512)
    assert int(flag) == 1


def _reference_two_shot(x: np.ndarray, fmt: str, width: int):
    """The reference's reduce-scatter and all-gather inside ``shard_map`` on a
    one-device mesh, with the WireReports its trace records."""
    mesh = make_smoke_mesh(1)

    def body(v):
        red, f1 = jcc.reduce_scatter_compressed(v, "data", width=width)
        gat, f2 = jcc.all_gather_compressed(v, "data", width=width)
        return red, gat, f1, f2

    with jpolicy.capture_wire_reports() as reports:
        out = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=P(), out_specs=P(),
            axis_names={"data", "model"}, check_vma=False))(to_jax(x, fmt))
    return out, list(reports)


@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "float8_e4m3fn"])
def test_single_rank_two_shot_matches_reference(fmt):
    """reduce_scatter_compressed and all_gather_compressed on a world of one,
    ragged n: values, flags and WireReports equal the reference's.  The
    reference pads ragged input with a float concatenate, so only NaNs that
    survive a float copy on XLA:CPU are used."""
    n = 512 * 5 + 77
    bits = grad_like_bits(fmt, n, seed=23, subnormals=False, xla_copy_nans=True)
    (jred, jgat, jf1, jf2), jreports = _reference_two_shot(bits, fmt, 5)
    x = to_torch(bits, fmt)
    with single_process_group("cpu") as group, \
            policy.capture_wire_reports() as reports:
        red, f1 = cc.reduce_scatter_compressed(x, group, width=5)
        gat, f2 = cc.all_gather_compressed(x, group, width=5)
    # under jit XLA folds the reduce's `zeros + x` into `x`, so a -0.0 input
    # stays -0.0 there; IEEE's 0 + (-0.0) is +0.0, as in the port
    jred = np.where(np.asarray(jred) == 0, np.float32(0), jred)
    assert_f32_equal_nan_as_nan(red, jred, "reduce_scatter")
    assert_bits_equal(gat, jgat, "all_gather")
    assert int(f1) == int(jf1) == 0 and int(f2) == int(jf2) == 0
    fields = ("name", "raw_bytes", "wire_bytes", "fused", "decode_hbm_bytes",
              "encode_fused", "encode_hbm_bytes")
    assert [tuple(getattr(r, f) for f in fields) for r in reports] == \
        [tuple(getattr(r, f) for f in fields) for r in jreports]


def test_two_rank_gloo_matches_rank_order_sum_and_reference(tmp_path):
    """Two gloo ranks: each rank's reduced shard is the rank-order f32 sum of
    its chunk over the ranks, the raw twin's, and the reference's fused
    decode+reduce of the stacked wire; the all-gather is lossless."""
    fmt, n, width, world = "bfloat16", 512 * 8 + 300, 5, 2
    res = run_gloo_ranks(collectives_rank, world, tmp_path, fmt, n, width)
    xs = [grad_like_bits(fmt, n, seed=r, subnormals=False) for r in range(world)]
    pad = (-n) % (world * 512)
    rows = [np.concatenate([b, np.zeros(pad, b.dtype)]).reshape(world, -1) for b in xs]
    jwires = [jcc._encode_chunks(to_jax(r, fmt), width=width, block=512,
                                 exc_frac=0.02) for r in rows]
    chunk = rows[0].shape[1]
    for r in range(world):
        f32 = [torch.from_numpy(row[r].view(np.int16)).view(torch.bfloat16).float()
               for row in rows]
        seq = torch.zeros(chunk)
        for v in f32:
            seq = seq + v
        assert res[r]["flag"] == 0 and res[r]["gflag"] == 0
        assert_f32_equal_nan_as_nan(res[r]["red"], seq, f"rank {r} vs seq sum")
        assert_f32_equal_nan_as_nan(res[r]["red"], res[r]["raw"], f"rank {r} vs raw")
        recv = {k: jnp.stack([w[k][r] for w in jwires]) for k in jwires[0]}
        want, _ = jcc._decode_reduce_chunks(recv, dtype=jnp.bfloat16, n=chunk,
                                            width=width, block=512)
        assert_f32_equal_nan_as_nan(res[r]["red"], want, f"rank {r} vs reference")
        shards = [b[q * (n // world): (q + 1) * (n // world)] for q, b in enumerate(xs)]
        spad = (-(n // world)) % 512
        gathered = np.stack([np.concatenate([s, np.zeros(spad, s.dtype)]) for s in shards])
        assert np.array_equal(res[r]["gat"], gathered)
        assert np.array_equal(res[r]["raw_gat"], gathered.reshape(-1))


def test_wire_reports_go_to_the_innermost_capture_of_their_thread():
    import threading

    rep = policy.WireReport(name="x", axis="gloo:1", raw_bytes=8, wire_bytes=4)
    policy.clear_wire_reports()
    policy.record_wire_report(rep)  # no capture open: the module ledger
    with policy.capture_wire_reports() as outer:
        policy.record_wire_report(rep)
        with policy.capture_wire_reports() as inner:
            policy.record_wire_report(rep)
            t = threading.Thread(target=policy.record_wire_report, args=(rep,))
            t.start()
            t.join(10)
            assert not t.is_alive()
    assert outer == [rep] and inner == [rep] and rep.ratio == 0.5
    # the ledger holds the uncaptured report and the other thread's
    assert policy.wire_reports() == (rep, rep)
    policy.clear_wire_reports()
