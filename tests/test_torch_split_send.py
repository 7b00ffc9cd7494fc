"""The port's P2P wire (``repro_torch.core.split_send``: ``split_send``,
``encode_send``, ``chunked_pipeline_send``, ``p2p_dispatch``/``p2p_send``,
``delta_send``, ``wsync_dispatch``) and the in-mesh KV and weight-sync wires
over it (``serve/kv_transfer.transfer_cache``, ``sync/wire.sync_weights``),
held against the JAX reference (``repro.core.split_send``).

At one rank each port function runs on a one-rank gloo group with perm
``[(0, 0)]`` and the reference's function inside ``jax.shard_map`` on a
one-device mesh.  At 2 gloo ranks (``torch_port_util.split_send_rank``,
perms ``[(0, 1), (1, 0)]`` and ``[(0, 1)]``, where rank 0 is targeted by no
pair) each result is held against a composition of the reference's own
encode and decode (``compressed_collectives._encode_chunks``,
``_decode_chunks``, ``_decode_reduce_chunks``, ``packing.encode_delta``,
``decode_delta``) on the sending rank's input, or on the all-zero wire an
untargeted rank receives.

Tolerances: none.  Values, flags and WireReport fields bit for bit; NaN
matched as NaN only after an f32 add (a reducing receiver).  Inputs carry
NaNs that survive the reference's float-copy pad, and no subnormals where an
f32 add follows (XLA:CPU flushes them).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.core import compressed_collectives as jcc
from repro.core import packing as jpacking
from repro.core import policy as jpolicy
from repro.core import split_send as jss
from repro.core.policy import CompressionPolicy as JPolicy
from repro.launch.mesh import make_mesh
from repro_torch.core import codec, packing, policy
from repro_torch.core import split_send as ss
from repro_torch.core.compressed_collectives import PendingPermute
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.train import single_process_group
from torch_port_util import (DELTA_N, DELTA_WIDTHS, FORMATS, REDUCE_N, SPLIT_PERMS,
                             SPLIT_SIZES, SPLIT_STRATEGIES, SPLIT_WIDTH, assert_bits_equal,
                             delta_pair, np_of, p2p_tree, reduce_acc, report_rows,
                             run_gloo_ranks, split_bits, split_send_rank, to_jax, to_torch,
                             weight_trees)

BLOCK = 512
IDPERM = [(0, 0)]
JFNS = {"split_send": jss.split_send, "encode_send": jss.encode_send,
        "chunked": jss.chunked_pipeline_send}
FNS = {"split_send": ss.split_send, "encode_send": ss.encode_send,
       "chunked": ss.chunked_pipeline_send}


def _pad_up(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def assert_equal_nan_as_nan(got, want, ctx=""):
    """f32 bits equal, or NaN on both sides."""
    g, w = np_of(got).reshape(-1), np_of(want).reshape(-1)
    assert g.shape == w.shape, (ctx, g.shape, w.shape)
    nan = np.isnan(g.view(np.float32)) & np.isnan(w.view(np.float32))
    bad = np.flatnonzero((g != w) & ~nan)
    assert bad.size == 0, (ctx, f"{bad.size} differ; first at {bad[0]}")


# ---------------------------------------------------------------------------
# one rank: the reference's functions inside shard_map, one program a format
# ---------------------------------------------------------------------------

_REFERENCE: dict = {}


def _reference(fmt: str) -> dict:
    """``{key: (value, flag, WireReports)}`` of the reference at one rank on
    rank 0's inputs: each strategy at every size, the reducing receiver
    fused and unfused (split_send) and through p2p_send (the other two),
    the raw dispatch, delta_send and wsync_dispatch; traced once in one
    program."""
    if fmt in _REFERENCE:
        return _REFERENCE[fmt]
    xs = [to_jax(split_bits(fmt, n, 0), fmt) for n in SPLIT_SIZES]
    xr = to_jax(split_bits(fmt, REDUCE_N, 0, subnormals=False), fmt)
    acc = jnp.asarray(reduce_acc(REDUCE_N, 0))
    bits, base = delta_pair(fmt, DELTA_N, 0)
    xd, bd = to_jax(bits, fmt), to_jax(base, fmt)
    jpol = JPolicy(min_bytes=0)
    reports = {}

    def body(xs, xr, acc, xd, bd):
        calls = {}
        for n, x in zip(SPLIT_SIZES, xs):
            for strat, fn in JFNS.items():
                calls[f"{strat}_{n}"] = lambda fn=fn, x=x: fn(x, "data", IDPERM,
                                                              width=SPLIT_WIDTH)
        for fused in (True, False):
            calls[f"reduce_{fused}"] = lambda fused=fused: jss.split_send(
                xr, "data", IDPERM, width=SPLIT_WIDTH, reduce_into=acc, use_fused=fused)
        for strat in SPLIT_STRATEGIES:
            calls[f"p2p_reduce_{strat}"] = lambda strat=strat: jss.p2p_send(
                xr, "data", IDPERM, policy=jpol, strategy=strat, reduce_into=acc)
        calls["raw"] = lambda: jss.p2p_dispatch(xr, "data", IDPERM, compressed=False,
                                                width=SPLIT_WIDTH)
        calls["raw_reduce"] = lambda: jss.p2p_dispatch(
            xr, "data", IDPERM, compressed=False, width=SPLIT_WIDTH, reduce_into=acc)
        for dtag, (w, wl) in DELTA_WIDTHS.items():
            calls[f"delta_{dtag}"] = lambda w=w, wl=wl: jss.delta_send(
                xd, bd, "data", IDPERM, width=w, lo_width=wl)
            calls[f"wsync_{dtag}"] = lambda w=w, wl=wl: jss.wsync_dispatch(
                xd, bd, "data", IDPERM, compressed=True, width=SPLIT_WIDTH,
                delta_width=w, delta_lo_width=wl)
        calls["wsync_full"] = lambda: jss.wsync_dispatch(
            xd, None, "data", IDPERM, compressed=True, width=SPLIT_WIDTH, delta_width=2,
            delta_lo_width=4)
        outs = {}
        for key, fn in calls.items():
            with jpolicy.capture_wire_reports() as reports[key]:
                outs[key] = fn()
        return outs

    mesh = make_mesh((1,), ("data",))
    outs = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(),) * 5, out_specs=P(),
                                 axis_names={"data"}, check_vma=False))(xs, xr, acc, xd, bd)
    _REFERENCE[fmt] = {k: (outs[k][0], int(outs[k][1]), report_rows(reports[k]))
                       for k in outs}
    return _REFERENCE[fmt]


@pytest.mark.parametrize("n", SPLIT_SIZES)
@pytest.mark.parametrize("strategy", SPLIT_STRATEGIES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_single_rank_strategy_matches_reference(fmt, strategy, n):
    """Values (the input's bits), flag and WireReports: the lo plane at 4
    bytes a word, ``n_elems`` the padded length, split_send's
    ``encode_fused=False``, one report a chunk of the chunked pipeline."""
    want, jflag, jreports = _reference(fmt)[f"{strategy}_{n}"]
    x = to_torch(split_bits(fmt, n, 0), fmt)
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        got, flag = FNS[strategy](x, g, IDPERM, width=SPLIT_WIDTH)
    assert_bits_equal(got, want, (fmt, strategy, n))
    assert_bits_equal(got, x)
    assert int(flag) == jflag == 0
    assert report_rows(reports) == jreports
    assert [r.raw_bytes for r in reports] == [x.element_size() * (
        ss.chunk_grid(n, 4, BLOCK)[0] if strategy == "chunked" else _pad_up(n))] * len(reports)
    assert all(r.encode_fused == (strategy != "split_send") for r in reports)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("fmt", FORMATS)
def test_single_rank_reducing_receiver_matches_reference(fmt, fused):
    """split_send(reduce_into=) fused (decode+reduce with the exact
    exception patch) and unfused (decode, then add): the same f32 bits as
    each other, as ``acc + x`` in plain PyTorch and as the reference; the
    report carries the decoded-float round-trip, ``fused`` as asked."""
    want, jflag, jreports = _reference(fmt)[f"reduce_{fused}"]
    x = to_torch(split_bits(fmt, REDUCE_N, 0, subnormals=False), fmt)
    acc = torch.from_numpy(reduce_acc(REDUCE_N, 0))
    if codec.layout_of(x.dtype).exp_bits > SPLIT_WIDTH:  # else every range fits
        assert packing.pack_exponents(codec.split_planes(x)[0], width=SPLIT_WIDTH).exc_idx.lt(
            _pad_up(REDUCE_N) // BLOCK).any(), "the input must hold exception blocks"
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        got, flag = ss.split_send(x, g, IDPERM, width=SPLIT_WIDTH, reduce_into=acc,
                                  use_fused=fused)
        other, _ = ss.split_send(x, g, IDPERM, width=SPLIT_WIDTH, reduce_into=acc,
                                 use_fused=not fused)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert_bits_equal(got, other)
    assert_equal_nan_as_nan(got, acc + x.float(), fmt)
    assert_equal_nan_as_nan(got, want, fmt)
    assert int(flag) == jflag == 0
    assert report_rows(reports[:1]) == jreports
    assert (reports[0].fused, reports[0].decode_hbm_bytes) == (fused, 8 * _pad_up(REDUCE_N))


@pytest.mark.parametrize("strategy", SPLIT_STRATEGIES)
def test_p2p_send_reducing_receiver_matches_reference(strategy):
    """p2p_send(reduce_into=) on every strategy: split_send fuses, the
    others decode and add, their reports re-recorded with ``fused=False``
    and the decoded floats' round-trip, ``8 * raw_bytes / itemsize``."""
    fmt = "bfloat16"
    want, jflag, jreports = _reference(fmt)[f"p2p_reduce_{strategy}"]
    x = to_torch(split_bits(fmt, REDUCE_N, 0, subnormals=False), fmt)
    acc = torch.from_numpy(reduce_acc(REDUCE_N, 0))
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        got, flag = ss.p2p_send(x, g, IDPERM, policy=CompressionPolicy(min_bytes=0),
                                strategy=strategy, reduce_into=acc)
    assert_equal_nan_as_nan(got, want, strategy)
    assert_equal_nan_as_nan(got, acc + x.float(), strategy)
    assert int(flag) == jflag == 0
    assert report_rows(reports) == jreports
    assert all(r.decode_hbm_bytes == 8 * (r.raw_bytes // 2) for r in reports)
    assert all(r.fused == (strategy == "split_send") for r in reports)


def test_p2p_dispatch_raw_path_matches_reference():
    """A gated-off send is the raw ppermute, a reducing one adds in f32; no
    report, flag 0."""
    ref = _reference("bfloat16")
    x = to_torch(split_bits("bfloat16", REDUCE_N, 0, subnormals=False), "bfloat16")
    acc = torch.from_numpy(reduce_acc(REDUCE_N, 0))
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        got, flag = ss.p2p_dispatch(x, g, IDPERM, compressed=False, width=SPLIT_WIDTH)
        red, rflag = ss.p2p_dispatch(x, g, IDPERM, compressed=False, width=SPLIT_WIDTH,
                                     reduce_into=acc)
        sent, _ = ss.p2p_send(x, g, IDPERM, policy=CompressionPolicy.disabled())
    assert_bits_equal(got, ref["raw"][0])
    assert_bits_equal(got, x)
    assert_bits_equal(sent, x)
    assert_equal_nan_as_nan(red, ref["raw_reduce"][0])
    assert int(flag) == int(rflag) == ref["raw"][1] == 0
    assert reports == [] and ref["raw"][2] == ref["raw_reduce"][2] == []


@pytest.mark.parametrize("dtag", sorted(DELTA_WIDTHS))
@pytest.mark.parametrize("fmt", FORMATS)
def test_single_rank_delta_send_and_wsync_dispatch_match_reference(fmt, dtag):
    """delta_send and wsync_dispatch (a base given: the delta) against the
    reference: a warm delta is exact with flag 0; at widths (1, 1) the lo
    delta's exceptions overflow, the flag is 1 and the (lossy) result is
    still the reference's bits.  Without a base, wsync_dispatch is the
    full split_send."""
    w, wl = DELTA_WIDTHS[dtag]
    ref = _reference(fmt)
    bits, base = delta_pair(fmt, DELTA_N, 0)
    x, b = to_torch(bits, fmt), to_torch(base, fmt)
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reports:
        got, flag = ss.delta_send(x, b, g, IDPERM, width=w, lo_width=wl)
        wgot, wflag = ss.wsync_dispatch(x, b, g, IDPERM, compressed=True, width=SPLIT_WIDTH,
                                        delta_width=w, delta_lo_width=wl)
        full, fflag = ss.wsync_dispatch(x, None, g, IDPERM, compressed=True,
                                        width=SPLIT_WIDTH, delta_width=2, delta_lo_width=4)
    for key, (out, f), rows in (("delta", (got, flag), reports[:1]),
                                ("wsync", (wgot, wflag), reports[1:2])):
        want, jflag, jreports = ref[f"{key}_{dtag}"]
        assert_bits_equal(out, want, (key, dtag))
        assert f.dtype == torch.int32 and f.dim() == 0
        assert int(f) == jflag == (dtag == "overflow")
        assert report_rows(rows) == jreports
    if dtag == "warm":
        assert_bits_equal(got, x)
    assert_bits_equal(full, ref["wsync_full"][0])
    assert_bits_equal(full, x)
    assert int(fflag) == 0 and report_rows(reports[2:]) == ref["wsync_full"][2]
    assert [r.name for r in reports] == ["delta_send", "delta_send", "split_send"]


def test_chunked_degenerate_chunk_guard_and_empty_tensor():
    """The chunk grid is the reference's: ceil(n / chunks) rounded up to a
    block, then as many chunks as carry data (n = 100: one chunk, not four
    of padding); an empty tensor raises in both packages."""
    for n, chunks in ((100, 4), (513, 4), (1537, 4), (2048, 4), (2065, 4), (5000, 3),
                      (512, 1), (1, 8)):
        per, got = ss.chunk_grid(n, chunks, BLOCK)
        assert per % BLOCK == 0 and per * (got - 1) < n <= per * got, (n, chunks)
        ideal = -(-n // chunks)
        assert (per, got) == (-(-ideal // BLOCK) * BLOCK, -(-n // (-(-ideal // BLOCK) * BLOCK)))
    assert ss.chunk_grid(100, 4, BLOCK) == (512, 1)
    assert ss.chunk_grid(1537, 4, BLOCK) == (512, 4)
    with pytest.raises(ValueError, match="empty"):
        ss.chunked_pipeline_send(torch.zeros(0, dtype=torch.bfloat16), None, IDPERM,
                                 width=SPLIT_WIDTH)
    with pytest.raises(ValueError, match="empty"):
        jss.chunked_pipeline_send(jnp.zeros((0,), jnp.bfloat16), "data", IDPERM,
                                  width=SPLIT_WIDTH)
    with pytest.raises(ValueError, match="strategy"):
        ss.p2p_dispatch(torch.zeros(8, dtype=torch.bfloat16), None, IDPERM, compressed=True,
                        width=SPLIT_WIDTH, strategy="warp_send")


# ---------------------------------------------------------------------------
# the schedule: split_send sends the lo plane before it encodes the exponents
# ---------------------------------------------------------------------------

def _record_schedule(monkeypatch) -> list:
    """Record, in order, every ``all_to_all_single`` (with its ``async_op``
    and byte count), the start and end of the exponent encode of either
    route and each wait on a ppermute (with its byte count)."""
    events = []
    a2a, pack_exp = dist.all_to_all_single, packing.pack_exponents
    encode, wait = kernel_ops.encode_fused_chunks, PendingPermute.wait

    def rec_a2a(out, inp, *a, async_op=False, **k):
        events.append(("send", async_op, inp.numel()))
        return a2a(out, inp, *a, async_op=async_op, **k)

    def rec_pack(*a, **k):
        events.append(("pack_exponents",))
        out = pack_exp(*a, **k)
        events.append(("pack_exponents returned",))
        return out

    def rec_encode(*a, **k):
        out = encode(*a, **k)
        events.append(("encode_fused returned",))
        return out

    def rec_wait(self):
        events.append(("wait", self.out.numel()))
        return wait(self)

    monkeypatch.setattr(dist, "all_to_all_single", rec_a2a)
    monkeypatch.setattr(packing, "pack_exponents", rec_pack)
    monkeypatch.setattr(kernel_ops, "encode_fused_chunks", rec_encode)
    monkeypatch.setattr(PendingPermute, "wait", rec_wait)
    return events


def test_split_send_issues_the_lo_send_before_the_exponent_encode(monkeypatch):
    """The lo plane's all_to_all_single is issued with ``async_op=True``
    before ``pack_exponents`` starts; the exponent wire's five sends follow,
    each waited on at once, and the lo plane is waited on last."""
    x = to_torch(split_bits("bfloat16", 2065, 0), "bfloat16")
    lo_bytes = _pad_up(2065) // 32 * 8 * 4
    with single_process_group("cpu") as g:
        events = _record_schedule(monkeypatch)
        got, _ = ss.split_send(x, g, IDPERM, width=SPLIT_WIDTH)
    assert_bits_equal(got, x)
    assert events[:3] == [("send", True, lo_bytes), ("pack_exponents",),
                          ("pack_exponents returned",)]
    exp_sends = events[3:-1]
    assert [e[0] for e in exp_sends] == ["send", "wait"] * 5
    assert all(s[2] == w[1] != lo_bytes for s, w in zip(exp_sends[::2], exp_sends[1::2]))
    assert events[-1] == ("wait", lo_bytes)


@pytest.mark.parametrize("fused_encode", [True, False])
def test_encode_send_sends_nothing_before_its_encode_returns(monkeypatch, fused_encode):
    """encode_send: the whole message is encoded (one encode_fused, or the
    three-pass encode) before the first send; every send is waited on
    before the next is issued."""
    x = to_torch(split_bits("bfloat16", 2065, 0), "bfloat16")
    done = ("encode_fused returned",) if fused_encode else ("pack_exponents returned",)
    with single_process_group("cpu") as g:
        events = _record_schedule(monkeypatch)
        got, _ = ss.encode_send(x, g, IDPERM, width=SPLIT_WIDTH, fused_encode=fused_encode)
        chunked = len(events)
        ss.chunked_pipeline_send(x, g, IDPERM, width=SPLIT_WIDTH, fused_encode=fused_encode)
    assert_bits_equal(got, x)
    first = events.index(done)
    assert "send" not in [e[0] for e in events[:first]]
    assert [e[0] for e in events[first + 1:chunked]] == ["send", "wait"] * 6
    # the chunked pipeline: chunk k + 1's encode after chunk k's last send
    tail = events[chunked:]
    encodes = [i for i, e in enumerate(tail) if e == done]
    assert len(encodes) == ss.chunk_grid(2065, 4, BLOCK)[1] == 3
    for a, b in zip(encodes, encodes[1:]):
        assert [e[0] for e in tail[a + 1:b]].count("send") == 6


# ---------------------------------------------------------------------------
# 2 ranks: each rank's results against the reference's codec composed
# ---------------------------------------------------------------------------

_encode = jax.jit(jcc._encode_chunks, static_argnames=("width", "block", "exc_frac", "fused"))
_decode = jax.jit(jcc._decode_chunks, static_argnames=("dtype", "n", "width", "block"))
_decode_reduce = jax.jit(jcc._decode_reduce_chunks,
                         static_argnames=("dtype", "n", "width", "block"))


@jax.jit
def _zeros_like(tree):
    return jax.tree.map(jnp.zeros_like, tree)


def _pad_bits(bits: np.ndarray, n_pad: int) -> np.ndarray:
    return np.concatenate([bits, np.zeros(n_pad - bits.size, bits.dtype)])


def ref_receive(fmt: str, n: int) -> dict:
    """The reference's decode of what each rank receives at 2 ranks: the
    wire of the other rank's input (``[0]``: rank 0's, ``[1]``: rank 1's)
    and the all-zero wire (``"zero"``); one encode and one decode of the
    stacked rows."""
    n_pad = _pad_up(n)
    rows = jnp.stack([to_jax(_pad_bits(split_bits(fmt, n, r), n_pad), fmt) for r in (0, 1)])
    wire = _encode(rows, width=SPLIT_WIDTH, block=BLOCK, exc_frac=0.02)
    wire = {k: jnp.concatenate([v, _zeros_like(v[:1])]) for k, v in wire.items()}
    vals, _ = _decode(wire, dtype=jnp.dtype(fmt), n=n_pad, width=SPLIT_WIDTH, block=BLOCK)
    return {0: vals[0, :n], 1: vals[1, :n], "zero": vals[2, :n]}


_RUN: dict = {}


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    if not _RUN:
        _RUN["res"] = run_gloo_ranks(split_send_rank, 2, tmp_path_factory.mktemp("p2p2"))
    return _RUN["res"]


def _expect_from(ptag: str, rank: int):
    """The rank whose input ``rank`` receives along SPLIT_PERMS[ptag], or
    None (untargeted)."""
    src = [s for s, d in SPLIT_PERMS[ptag] if d == rank]
    return src[0] if src else None


@pytest.mark.parametrize("fmt", FORMATS)
def test_two_rank_strategies(ranks2, fmt):
    """Every strategy at every size along both perms: a targeted rank gets
    the sender's bits, the reference's decode of the sender's wire; the
    untargeted rank the reference's decode of the all-zero wire; flags 0;
    each rank's reports the reference's."""
    ref = _reference(fmt)
    for n in SPLIT_SIZES:
        want = ref_receive(fmt, n)
        assert not np_of(want["zero"]).any()  # the zero wire decodes to +0.0
        for ptag in SPLIT_PERMS:
            for r in range(2):
                src = _expect_from(ptag, r)
                for strat in SPLIT_STRATEGIES:
                    key = f"{strat}_{fmt}_{n}_{ptag}"
                    got = ranks2[r][key]
                    assert_bits_equal(got, want["zero" if src is None else src], (key, r))
                    if src is not None:
                        assert_bits_equal(got, split_bits(fmt, n, src), (key, r))
                    assert ranks2[r][f"flag_{key}"] == 0
                    rows = json.loads(str(ranks2[r][f"reports_{key}"]))
                    assert rows == [list(row) for row in ref[f"{strat}_{n}"][2]], (key, r)


@pytest.mark.parametrize("fmt", FORMATS)
def test_two_rank_reducing_receiver(ranks2, fmt):
    """Fused and unfused: the rank's accumulator plus what it receives,
    the reference's decode+reduce of the sender's wire (of the zero wire
    when untargeted: the accumulator, -0.0 as +0.0), NaN as NaN."""
    n_pad = _pad_up(REDUCE_N)
    rows = jnp.stack([to_jax(_pad_bits(split_bits(fmt, REDUCE_N, r, subnormals=False),
                                       n_pad), fmt) for r in (0, 1)])
    wire = _encode(rows, width=SPLIT_WIDTH, block=BLOCK, exc_frac=0.02)
    for ptag in SPLIT_PERMS:
        for r in range(2):
            src = _expect_from(ptag, r)
            recv = {k: (v[src:src + 1] if src is not None else _zeros_like(v[:1]))
                    for k, v in wire.items()}
            acc = jnp.asarray(_pad_bits(reduce_acc(REDUCE_N, r), n_pad))
            want, _ = _decode_reduce(recv, dtype=jnp.dtype(fmt), n=n_pad, width=SPLIT_WIDTH,
                                     block=BLOCK, acc=acc)
            for fused in (True, False):
                key = f"reduce_{fused}_{fmt}_{ptag}"
                assert_equal_nan_as_nan(ranks2[r][key], np.asarray(want)[:REDUCE_N],
                                        (key, r))
                assert ranks2[r][f"flag_{key}"] == 0
            assert_bits_equal(ranks2[r][f"reduce_True_{fmt}_{ptag}"],
                              ranks2[r][f"reduce_False_{fmt}_{ptag}"])


@pytest.mark.parametrize("fmt", FORMATS)
def test_two_rank_delta_send_and_wsync_dispatch(ranks2, fmt):
    """Both ranks hold the same base: a targeted rank decodes the sender's
    delta against it (the reference's encode_delta and decode_delta), flag
    the sender's overflow; the untargeted rank decodes the zero wire, which
    gives back its base, flag 0.  wsync_dispatch gives the same."""
    n_pad = _pad_up(DELTA_N)
    for dtag, (w, wl) in DELTA_WIDTHS.items():
        for ptag in SPLIT_PERMS:
            for r in range(2):
                src = _expect_from(ptag, r)
                key = f"delta_{dtag}_{fmt}_{ptag}"
                _, base = delta_pair(fmt, DELTA_N, r)
                jb = to_jax(_pad_bits(base, n_pad), fmt)
                if src is None:
                    want, wflag = base, 0
                else:
                    xs = to_jax(_pad_bits(delta_pair(fmt, DELTA_N, src)[0], n_pad), fmt)
                    m = jpacking.encode_delta(xs, jb, width=w, lo_width=wl, block=BLOCK)
                    want = np_of(jpacking.decode_delta(m, jb))[:DELTA_N]
                    wflag = int(m.overflow)
                for tag in (key, f"wsync_{key}"):
                    assert_bits_equal(ranks2[r][tag], want, (tag, r))
                    assert ranks2[r][f"flag_{tag}"] == wflag == (
                        src is not None and dtag == "overflow"), (tag, r)


def test_two_rank_raw_dispatch(ranks2):
    for ptag in SPLIT_PERMS:
        for r in range(2):
            src = _expect_from(ptag, r)
            want = (np.zeros(2065, np.uint16) if src is None
                    else split_bits("bfloat16", 2065, src))
            assert_bits_equal(ranks2[r][f"raw_{ptag}"], want, (ptag, r))
            assert ranks2[r][f"flag_raw_{ptag}"] == 0


@pytest.mark.parametrize("strategy", SPLIT_STRATEGIES)
def test_two_rank_transfer_cache(ranks2, strategy):
    """The in-mesh KV wire and its plan twin under each strategy: a targeted
    rank gets every leaf of the sender's cache (the bf16 and f32 buckets
    compressed, the 0-d int32 leaf raw), the untargeted rank zeros (the
    zero wire's decode and the raw ppermute's); flag 0."""
    from repro_torch.tree_util import tree_flatten

    for ptag in SPLIT_PERMS:
        for r in range(2):
            src = _expect_from(ptag, r)
            leaves = tree_flatten(p2p_tree(0 if src is None else src))[0]
            for i, leaf in enumerate(leaves):
                want = np_of(torch.zeros_like(leaf) if src is None else leaf)
                for tag in ("tc", "tc_plan"):
                    assert_bits_equal(ranks2[r][f"{tag}_{strategy}_{ptag}_{i}"], want,
                                      (tag, ptag, r, i))
            assert ranks2[r][f"flag_tc_{strategy}_{ptag}"] == 0
            assert ranks2[r][f"flag_tc_plan_{strategy}_{ptag}"] == 0


def test_two_rank_sync_weights(ranks2):
    """The in-mesh weight sync and its plan twin, full and as a delta: a
    targeted rank gets the sender's weights; the untargeted rank zeros from
    a full send and its own base from a delta (a zero delta); flag 0."""
    from repro_torch.tree_util import tree_flatten

    for btag in ("full", "delta"):
        for ptag in SPLIT_PERMS:
            for r in range(2):
                src = _expect_from(ptag, r)
                if src is not None:
                    want = tree_flatten(weight_trees(src)[0])[0]
                else:
                    own, base = (tree_flatten(t)[0] for t in weight_trees(r))
                    want = [base[i] if btag == "delta" and leaf.is_floating_point()
                            else torch.zeros_like(leaf) for i, leaf in enumerate(own)]
                for i, leaf in enumerate(want):
                    for tag in ("sw", "sw_plan"):
                        assert_bits_equal(ranks2[r][f"{tag}_{btag}_{ptag}_{i}"], np_of(leaf),
                                          (tag, btag, ptag, r, i))
                assert ranks2[r][f"flag_sw_{btag}_{ptag}"] == 0
                assert ranks2[r][f"flag_sw_plan_{btag}_{ptag}"] == 0


