"""The port's weight-sync slice (host path) held against the JAX reference,
bit for bit, on numpy-seeded inputs; mirrors the host-path tests of
``tests/test_sync.py``.

* ``codec.xor_delta``, the delta wire (``encode_delta`` / ``decode_delta``,
  ``pack_delta_plane``) and the full message (``encode_message``): every
  field equal to the reference's, NaN / Inf / subnormal payloads included,
  the overflow flags equal, and the closed-form ``delta_wire_bytes`` equal
  to the reference's ``eval_shape`` count;
* ``calibrate.choose_delta_widths`` and the kind-"wsync" plan equal the
  reference's;
* ``WeightSyncEngine``: every ``SyncUpdate`` field (modes, widths, wire
  bytes, checksum, every message array) equal to the reference engine's on
  the same publishes and acks, the reconstructed weights bit-identical, and
  updates cross-decode both ways;
* ``ServeEngine.ingest_weights`` and ``train/step.make_publish_hook``; greedy
  tokens after a delta ingest equal the reference engine's;
* the ``launch/rl_weight_sync`` CLI at smoke size on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import sched as jsched
from repro.core import calibrate as jcalibrate
from repro.core import codec as jcodec
from repro.core import packing as jpacking
from repro.core.calibrate import CompressionProfile as JProfile
from repro.core.policy import CompressionPolicy as JPolicy
from repro.models import transformer as jtransformer
from repro.sched.compile import delta_wire_bytes as jdelta_wire_bytes
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.sync import SyncUpdate as JSyncUpdate
from repro.sync import WeightSyncEngine as JWeightSyncEngine
from repro.sync import apply_update as japply_update
from repro.train.step import make_publish_hook as jmake_publish_hook
from repro_torch import configs, kernels
from repro_torch.core import calibrate, codec, integrity, packing
from repro_torch.core.calibrate import CompressionProfile
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch import rl_weight_sync
from repro_torch.models import transformer
from repro_torch.sched.cache import PlanCache
from repro_torch.sched.compile import (cached_wsync_plan, compile_wsync_plan,
                                       delta_wire_bytes, wsync_plan_key)
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
from repro_torch.sync import (SyncUpdate, VersionedStore, WeightSyncEngine,
                              apply_update, verify_update)
from repro_torch.train import step as step_lib
from repro_torch.tree_util import tree_flatten, tree_leaves
from torch_port_util import (FORMATS, assert_bits_equal, grad_like_bits, np_of,
                             random_bits, to_jax, to_torch)

DTYPES = ["float32", "bfloat16", "float16"]
POL, JPOL = CompressionPolicy(min_bytes=0), JPolicy(min_bytes=0)
_UINT = {"float32": np.uint32, "bfloat16": np.uint16, "float16": np.uint16,
         "float8_e4m3fn": np.uint8, "float8_e5m2": np.uint8}


def warm_pair(fmt, n, seed=0, flip_bits=3):
    """(new, base) bits: base normal(0, 0.02), new = base XOR a sparse
    low-mantissa mask, the shape of consecutive optimizer steps."""
    rng = np.random.default_rng(seed)
    base = np_of(torch.from_numpy(rng.normal(0, 0.02, n).astype(np.float32)).to(
        getattr(torch, fmt)))
    mask = rng.integers(0, 1 << flip_bits, n).astype(base.dtype)
    mask[rng.random(n) > 0.3] = 0
    return base ^ mask, base


def both(bits, fmt):
    return to_torch(bits, fmt), to_jax(bits, fmt)


# -- parameter trees shared by both packages (numpy bits) -----------------------

def np_params(seed=0):
    rng = np.random.default_rng(seed)

    def floats(fmt, shape, scale):
        v = torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))
        return fmt, np_of(v.to(getattr(torch, fmt)))

    return {"wq": floats("bfloat16", (64, 40), 0.02),
            "wk": floats("bfloat16", (1536,), 0.02),
            "norm": floats("float32", (300,), 1.0),
            "step": ("int32", np.asarray(7, np.int32))}  # not a codec float: raw


def perturb(p, seed=1, flip_bits=3):
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(p):
        fmt, a = p[k]
        if fmt in _UINT:
            mask = rng.integers(0, 1 << flip_bits, a.shape).astype(a.dtype)
            mask[rng.random(a.shape) > 0.3] = 0
            a = a ^ mask
        out[k] = (fmt, a)
    return out


def cold(p, seed=11):
    return {k: (fmt, random_bits(fmt, a.size, seed + i).reshape(a.shape)
                if fmt in _UINT else a) for i, (k, (fmt, a)) in enumerate(sorted(p.items()))}


def ttree(p):
    return {k: to_torch(a, fmt) if fmt in _UINT else torch.from_numpy(a.copy())
            for k, (fmt, a) in p.items()}


def jtree(p):
    return {k: to_jax(a, fmt) if fmt in _UINT else jnp.asarray(a) for k, (fmt, a) in p.items()}


def assert_tree_bits(got, want, ctx=""):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w), ctx
    for i, (a, b) in enumerate(zip(g, w)):
        assert_bits_equal(a, b, f"{ctx} leaf {i}")


def assert_fields_equal(got, want, ctx):
    """Message fields by name, recursively: arrays by dtype, shape and bits."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            assert_fields_equal(getattr(got, f.name), getattr(want, f.name),
                                f"{ctx}.{f.name}")
    elif hasattr(want, "dtype"):
        g, w = np.asarray(got), np.asarray(want)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (ctx, g.dtype, w.dtype, g.shape,
                                                          w.shape)
        assert g.tobytes() == w.tobytes(), ctx
    else:
        assert got == want, (ctx, got, want)


def host(m):
    """A port message with tensor fields as numpy fields (reference dtypes)."""
    from repro_torch.sync.engine import host_message

    return host_message(m)


def assert_updates_equal(got: SyncUpdate, want, ctx=""):
    for k in ("version", "epoch", "base_version", "n_leaves", "wire_bytes",
              "raw_bytes", "checksum", "mode"):
        assert getattr(got, k) == getattr(want, k), (ctx, k, getattr(got, k),
                                                     getattr(want, k))
    assert len(got.buckets) == len(want.buckets)
    for gb, wb in zip(got.buckets, want.buckets):
        assert gb[:3] == wb[:3], (ctx, gb[:3], wb[:3])
        assert_fields_equal(gb[3], jax.device_get(wb[3]), f"{ctx} {gb[0]} {gb[2]}")
    assert_fields_equal(got.raw_leaves, want.raw_leaves, f"{ctx} raw")
    assert verify_update(got)


# ---------------------------------------------------------------------------
# xor_delta and the bucket helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_xor_delta_matches_reference_and_is_an_involution(fmt):
    (x, jx), (b, jb) = both(random_bits(fmt, 4096, 1), fmt), both(random_bits(fmt, 4096, 2), fmt)
    d = codec.xor_delta(x, b)
    assert d.dtype == x.dtype
    assert_bits_equal(d, jcodec.xor_delta(jx, jb), fmt)
    assert_bits_equal(codec.xor_delta(d, b), np_of(x), fmt)
    assert not np_of(codec.xor_delta(x, x)).any()


def test_xor_delta_rejects_mismatch():
    with pytest.raises(ValueError):
        codec.xor_delta(torch.zeros(4), torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        codec.xor_delta(torch.zeros(4), torch.zeros(8))


def test_bucket_helpers_keep_every_bit():
    """concat / split / pad through integer views: NaN payloads survive."""
    bits = random_bits("bfloat16", 700, 3)
    x, jx = both(bits, "bfloat16")
    members = ((2, (10, 30), 300), (0, (400,), 400))
    src = {2: x[:300].reshape(10, 30), 0: x[300:]}
    jsrc = {2: jx[:300].reshape(10, 30), 0: jx[300:]}
    flat = codec.concat_members(src, members)
    assert_bits_equal(flat, jcodec.concat_members(jsrc, members), "concat")
    padded = codec.pad_flat_bits(flat, 512)
    assert_bits_equal(padded, jcodec.pad_flat_bits(jcodec.concat_members(jsrc, members), 512),
                      "pad")
    got = dict(codec.split_members(padded, members))
    assert_bits_equal(got[2], np_of(src[2]), "split 2")
    assert_bits_equal(got[0], np_of(src[0]), "split 0")


# ---------------------------------------------------------------------------
# the delta wire and the full message
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", DTYPES)
@pytest.mark.parametrize("n", [512, 4096, 5000])  # incl. a ragged n
def test_delta_message_matches_reference_warm(fmt, n):
    new, base = warm_pair(fmt, n)
    (x, jx), (b, jb) = both(new, fmt), both(base, fmt)
    w, wl = POL.delta_widths(fmt)
    assert (w, wl) == JPOL.delta_widths(fmt)
    m = packing.encode_delta(x, b, width=w, lo_width=wl)
    jm = jpacking.encode_delta(jx, jb, width=w, lo_width=wl)
    assert m.overflow == int(jm.overflow) == 0
    assert m.wire_bytes() == jm.wire_bytes()
    assert_fields_equal(host(m), jax.device_get(jm), f"{fmt} n={n}")
    assert_bits_equal(packing.decode_delta(m, b), new, "decode")
    assert_bits_equal(jpacking.decode_delta(host(m), jb), new, "the reference decodes ours")


@pytest.mark.parametrize("fmt", DTYPES)
def test_delta_message_nan_inf_subnormal_payloads(fmt):
    """Specials in either operand survive bitwise, through exceptions."""
    lay = codec.LAYOUTS[fmt]
    _, base = warm_pair(fmt, 4096, seed=3)
    new = base.copy()
    top = ((1 << lay.exp_bits) - 1) << lay.mant_bits
    new[7], new[100] = top | 0b101, top  # NaN with a payload, +Inf
    new[200] = (1 << (lay.total_bits - 1)) | top  # -Inf
    new[300], new[400] = 1, 1 << (lay.total_bits - 1)  # smallest subnormal, -0.0
    (x, jx), (b, jb) = both(new, fmt), both(base, fmt)
    m = packing.encode_delta(x, b, width=2, lo_width=2)
    jm = jpacking.encode_delta(jx, jb, width=2, lo_width=2)
    assert m.overflow == int(jm.overflow) == 0
    assert_fields_equal(host(m), jax.device_get(jm), fmt)
    assert_bits_equal(packing.decode_delta(m, b), new, fmt)
    m2 = packing.encode_delta(x, x, width=1, lo_width=1)  # specials in the base
    assert_bits_equal(packing.decode_delta(m2, x), new, fmt)


@pytest.mark.parametrize("fmt", DTYPES)
def test_delta_message_zero_delta(fmt):
    x, jx = both(random_bits(fmt, 4096, 5), fmt)
    m = packing.encode_delta(x, x, width=1, lo_width=1)
    assert m.overflow == 0 and int((m.lo.exc_idx < 4096).sum()) == 0
    assert_fields_equal(host(m), jax.device_get(jpacking.encode_delta(jx, jx, width=1,
                                                                      lo_width=1)), fmt)
    assert_bits_equal(packing.decode_delta(m, x), np_of(x), fmt)


@pytest.mark.parametrize("fmt", DTYPES)
def test_delta_pack_inputs_are_what_encode_delta_packs(fmt):
    """``delta_planes``, ``block_residuals`` and ``lo_delta_fit`` (the steps
    ``packing.encode_delta`` takes) give the two tensors whose packs are the
    delta message's payloads, which equal the reference's."""
    new, base = warm_pair(fmt, 5000, seed=4)
    (x, jx), (b, jb) = both(new, fmt), both(base, fmt)
    w, wl = POL.delta_widths(fmt)
    m = packing.encode_delta(x, b, width=w, lo_width=wl)
    jm = jpacking.encode_delta(jx, jb, width=w, lo_width=wl)
    exp, lo = packing.delta_planes(x, b)
    resid = packing.block_residuals(exp, width=w, block=512)[3]
    v, fits, kept = packing.lo_delta_fit(lo, wl)
    assert v.shape[0] % packing.GROUP == 0 and torch.equal(kept[~fits], torch.zeros_like(v[~fits]))
    assert_bits_equal(packing.bitplane_pack(resid, w), m.exp.payload, f"{fmt} exponent")
    assert_bits_equal(packing.bitplane_pack(kept, wl), m.lo.payload, f"{fmt} lo")
    assert_bits_equal(m.exp.payload, jm.exp.payload, f"{fmt} reference exponent")
    assert_bits_equal(m.lo.payload, jm.lo.payload, f"{fmt} reference lo")


def test_delta_message_overflow_flag_on_cold_delta():
    (x, jx), (b, jb) = (both(random_bits("bfloat16", 4096, s), "bfloat16") for s in (6, 7))
    m = packing.encode_delta(x, b, width=1, lo_width=1)
    jm = jpacking.encode_delta(jx, jb, width=1, lo_width=1)
    assert m.overflow == int(jm.overflow) == 1
    assert_fields_equal(host(m), jax.device_get(jm), "cold")


def test_pack_delta_plane_exceptions_match_reference():
    rng = np.random.default_rng(8)
    vals = rng.integers(0, 4, 4096).astype(np.uint32)
    vals[[3, 77, 500]] = [1 << 20, (1 << 24) - 1, 5000]  # carry-tail outliers
    p = packing.pack_delta_plane(torch.from_numpy(vals.view(np.int32)), 2)
    jp = jpacking.pack_delta_plane(jnp.asarray(vals), 2)
    assert int(p.overflow) == 0
    for k in ("payload", "exc_idx", "exc_raw", "overflow"):
        assert_bits_equal(getattr(p, k), getattr(jp, k), k)
    assert_bits_equal(packing.unpack_delta_plane(p), vals, "unpack")
    # one outlier more than the capacity of a 100-value plane: overflow
    many = np.full(100, 1 << 10, np.uint32)
    p = packing.pack_delta_plane(torch.from_numpy(many.view(np.int32)), 3, exc_frac=0.02)
    jp = jpacking.pack_delta_plane(jnp.asarray(many), 3, exc_frac=0.02)
    assert int(p.overflow) == int(jp.overflow) == 1
    assert_bits_equal(p.exc_idx, jp.exc_idx, "capacity")


@pytest.mark.parametrize("n,w,wl,exc", [(2048, 2, 4, 0.02), (5120, 1, 1, 0.02),
                                         (512, 8, 8, 0.02), (512 * 300, 3, 6, 0.001),
                                         (5000, 2, 4, 0.02)])
def test_delta_wire_bytes_match_reference(n, w, wl, exc):
    """The closed form against the reference's eval_shape count and the
    port's encoder."""
    want = jdelta_wire_bytes(n, jnp.bfloat16, width=w, lo_width=wl, block=512, exc_frac=exc)
    assert delta_wire_bytes(n, width=w, lo_width=wl, block=512, exc_frac=exc) == want
    new, base = warm_pair("bfloat16", n)
    m = packing.encode_delta(to_torch(new, "bfloat16"), to_torch(base, "bfloat16"),
                             width=w, lo_width=wl, exc_frac=exc)
    assert m.wire_bytes() == want


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("fused", [True, False])
def test_full_message_matches_reference(fmt, fused):
    """The port's one-pass encode against each of the reference's two forms
    (``fused``).  Whole blocks, so the reference's fused encode pads
    nothing."""
    bits = grad_like_bits(fmt, 512 * 6, seed=21)
    x, jx = both(bits, fmt)
    m = packing.encode_message(x, width=5)
    jm = jpacking.encode_message(jx, width=5, fused=fused)
    assert m.wire_bytes() == jm.wire_bytes() and m.raw_bytes() == jm.raw_bytes()
    assert_fields_equal(host(m), jax.device_get(jm), fmt)
    assert_bits_equal(packing.decode_message(m), bits, fmt)


def test_choose_delta_widths_match_reference_warm_and_cold():
    new, base = warm_pair("bfloat16", 1 << 15, flip_bits=2)
    (x, jx), (b, jb) = both(new, "bfloat16"), both(base, "bfloat16")
    w, wl = calibrate.choose_delta_widths(x, b)
    assert (w, wl) == jcalibrate.choose_delta_widths(jx, jb)
    assert 1 <= w <= 3 and 1 <= wl <= 4
    c, jc = both(random_bits("bfloat16", 1 << 15, 9), "bfloat16")
    w2, wl2 = calibrate.choose_delta_widths(c, b)
    assert (w2, wl2) == jcalibrate.choose_delta_widths(jc, jb) and wl2 >= 7


def test_policy_delta_widths_clamp_like_reference():
    prof = dataclasses.replace(POL.profile, widths=dict(POL.profile.widths, delta=12,
                                                        delta_lo=0))
    jprof = dataclasses.replace(JPOL.profile, widths=dict(prof.widths))
    for fmt in FORMATS:
        assert (dataclasses.replace(POL, profile=prof).delta_widths(fmt)
                == dataclasses.replace(JPOL, profile=jprof).delta_widths(fmt))


# ---------------------------------------------------------------------------
# the wsync plan
# ---------------------------------------------------------------------------

_PLAN_FIELDS = ("dtype_name", "members", "length", "path", "width", "block", "exc_frac",
                "chunk", "wire_bytes", "raw_bytes", "delta_width", "delta_lo_width",
                "delta_wire_bytes")


@pytest.mark.parametrize("axis,min_bytes", [("data", 0), ("data", 1 << 30), ("model", 0)])
def test_wsync_plan_matches_reference(axis, min_bytes):
    p = np_params()
    plan = compile_wsync_plan(ttree(p), axis, policy=CompressionPolicy(min_bytes=min_bytes),
                              n_dev=1)
    jp = jsched.compile_wsync_plan(jtree(p), axis, policy=JPolicy(min_bytes=min_bytes),
                                   n_dev=1)
    assert plan.kind == jp.kind == "wsync"
    assert (plan.n_leaves, plan.raw_leaf_ix) == (jp.n_leaves, jp.raw_leaf_ix) == (4, (1,))
    assert [tuple(getattr(b, f) for f in _PLAN_FIELDS) for b in plan.buckets] == [
        tuple(getattr(b, f) for f in _PLAN_FIELDS) for b in jp.buckets]
    # split_send's encode is never the fused one-pass kernel, as recorded
    assert [b.encode_fused for b in plan.buckets] == [b.encode_fused for b in jp.buckets]
    assert not any(b.encode_fused for b in plan.buckets if b.compressed)
    s, js = plan.summary(), jp.summary()
    for k in ("n_buckets", "paths", "n_delta", "wire_bytes", "raw_bytes",
              "delta_wire_bytes", "n_encode_fused"):
        assert s[k] == js[k], k
    assert (plan.backend, plan.use_kernels) == ("cpu", False)


def test_wsync_plan_key_misses_on_delta_width_change_and_refuses_broadcast():
    t = ttree(np_params())
    prof = dataclasses.replace(POL.profile, widths=dict(POL.profile.widths, delta_lo=7))
    assert wsync_plan_key(t, "data", POL, 1) != wsync_plan_key(
        t, "data", dataclasses.replace(POL, profile=prof), 1)
    assert wsync_plan_key(t, "data", POL, 1) == wsync_plan_key(ttree(np_params(5)), "data",
                                                                POL, 1)
    # a broadcast schedule enters the key (its triple ends it); an unknown
    # broadcast kind is refused
    tree_plan = compile_wsync_plan(t, "data", policy=POL, n_dev=1, broadcast="tree",
                                   n_receivers=4)
    assert tree_plan.key[:-1] == wsync_plan_key(t, "data", POL, 1)[:-1]
    assert (tree_plan.key[-1], wsync_plan_key(t, "data", POL, 1)[-1]) == (("tree", 2, 4),
                                                                          None)
    with pytest.raises(ValueError, match="broadcast"):
        compile_wsync_plan(t, "data", policy=POL, n_dev=1, broadcast="ring")
    with pytest.raises(ValueError, match="broadcast"):
        cached_wsync_plan(t, "data", policy=POL, n_dev=1, broadcast="ring",
                          cache=PlanCache())


# ---------------------------------------------------------------------------
# version store
# ---------------------------------------------------------------------------

def test_versioned_store_ack_history_and_fencing():
    st = VersionedStore(history=2)
    assert st.version == 0
    with pytest.raises(ValueError):
        st.latest()
    v1, v2 = st.publish({"w": torch.ones(4)}), st.publish({"w": torch.ones(4) * 2})
    assert (v1, v2) == (1, 2) and st.retained() == (1, 2)
    assert not st.ack("r", 3) and not st.ack("r", 0)
    assert st.ack("r", v1) and st.base_for("r") == v1
    v3 = st.publish({"w": torch.ones(4) * 3})  # prunes v1: the ack is stale
    assert st.retained() == (2, 3) and st.get(v1) is None
    assert st.acked_version("r") == v1 and st.base_for("r") is None
    st.ack("r", v3)
    old = st.epoch
    assert st.advance_epoch() == old + 1 and st.acked_version("r") is None
    assert not st.ack("r", v3, epoch=old)
    assert st.ack("r", v3, epoch=st.epoch) and st.base_for("r") == v3
    assert st.acked_replicas() == ("r",)
    back = VersionedStore.from_state_dict(st.state_dict())
    assert (back.version, back.epoch) == (st.version, st.epoch)
    assert torch.equal(back.latest()[0]["w"], st.latest()[0]["w"])


def test_versioned_store_owns_published_tensors():
    """The trainer updates its weights in place: the kept version must not
    change with them."""
    st = VersionedStore()
    w = torch.arange(8, dtype=torch.float32)
    st.publish({"w": w})
    w.mul_(0).add_(-1)
    assert torch.equal(st.latest()[0]["w"], torch.arange(8, dtype=torch.float32))


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------

def _engines(history=4, policy=None, jpolicy=None):
    return (WeightSyncEngine(policy=policy or POL, history=history, plan_cache=PlanCache()),
            JWeightSyncEngine(policy=jpolicy or JPOL, history=history,
                              plan_cache=jsched.PlanCache()))


def _publish(eng, jeng, p):
    v = eng.publish(ttree(p))
    assert jeng.publish(jtree(p)) == v
    return v


def _update(eng, jeng, replica, ctx, **kw):
    u, ju = eng.update_for(replica, **kw), jeng.update_for(replica, **kw)
    assert_updates_equal(u, ju, ctx)
    return u, ju


def test_engine_full_then_delta_then_pruned_history_fallback():
    eng, jeng = _engines(history=2)
    p1 = np_params()
    v1 = _publish(eng, jeng, p1)
    u1, _ = _update(eng, jeng, "r0", "first contact")
    assert u1.mode == "full" and u1.base_version is None
    held = apply_update(u1, device="cpu")
    assert_tree_bits(held, jtree(p1), "full")
    assert eng.ack("r0", u1.version, u1.epoch)
    jeng.ack("r0", u1.version, u1.epoch)
    p2 = perturb(p1, seed=2)
    _publish(eng, jeng, p2)
    u2, _ = _update(eng, jeng, "r0", "warm")
    assert u2.mode == "delta" and u2.base_version == v1 and u2.wire_bytes < u1.wire_bytes
    # the plan's closed-form bytes are the host wire (+ the raw int32 leaf)
    assert u2.wire_bytes == eng.plan_for(ttree(p2)).delta_wire_bytes + 4
    held = apply_update(u2, base_params=held, device="cpu")
    assert_tree_bits(held, jtree(p2), "delta")
    eng.ack("r0", u2.version, u2.epoch)
    jeng.ack("r0", u2.version, u2.epoch)
    for s in (3, 4):  # past the history without acks: the base is pruned
        _publish(eng, jeng, perturb(p2, seed=s))
    u4, _ = _update(eng, jeng, "r0", "pruned")
    assert u4.mode == "full" and u4.base_version is None
    assert_tree_bits(apply_update(u4, device="cpu"), jtree(perturb(p2, seed=4)), "pruned")


def test_engine_current_replica_gets_zero_delta_and_force_modes():
    eng, jeng = _engines()
    p = np_params()
    v = _publish(eng, jeng, p)
    full, _ = _update(eng, jeng, "r", "before the ack")
    eng.ack("r", v)
    jeng.ack("r", v)
    u, _ = _update(eng, jeng, "r", "current")
    assert u.mode == "delta" and u.base_version == v and u.wire_bytes < full.wire_bytes
    assert_tree_bits(apply_update(u, base_params=ttree(p), device="cpu"), jtree(p), "zero")
    for force in ("full", "raw"):
        f, _ = _update(eng, jeng, "r", force, force=force)
        assert f.mode == "full" and f.base_version is None
        assert_tree_bits(apply_update(f, device="cpu"), jtree(p), force)
    with pytest.raises(ValueError, match="force"):
        eng.update_for("r", force="delta")


def test_engine_memoizes_updates_per_base():
    eng = WeightSyncEngine(policy=POL, plan_cache=PlanCache())
    v = eng.publish(ttree(np_params()))
    u_a, u_b = eng.update_for("a"), eng.update_for("b")
    assert u_a is u_b
    eng.ack("a", v)
    assert eng.update_for("a") is not u_a  # another base: a new encode
    eng.publish(ttree(perturb(np_params())))
    assert eng.update_for("b") is not u_b  # a new version clears the memo


def test_engine_overflow_falls_back_to_full_per_bucket():
    eng, jeng = _engines()
    p = np_params()
    v = _publish(eng, jeng, p)
    eng.ack("r", v)
    jeng.ack("r", v)
    c = cold(p)
    _publish(eng, jeng, c)
    u, _ = _update(eng, jeng, "r", "cold")
    assert u.mode == "full" and u.base_version is None
    assert_tree_bits(apply_update(u, device="cpu"), jtree(c), "cold")


def test_engine_full_overflow_ships_raw():
    """Exponents spread over every block at width 1: even the full wire
    overflows, and the bucket ships as raw bits, as in the reference."""
    prof = CompressionProfile(widths={"weight": 1, "gradient": 1, "activation": 1},
                              exc_frac=0.0)
    jprof = JProfile(widths=dict(prof.widths), exc_frac=0.0)
    eng, jeng = _engines(policy=CompressionPolicy(min_bytes=0, profile=prof),
                         jpolicy=JPolicy(min_bytes=0, profile=jprof))
    c = cold(np_params())
    _publish(eng, jeng, c)
    u, _ = _update(eng, jeng, "r", "raw")
    assert u.buckets[0][:3:2] == ("bfloat16", "raw")  # 9 bad blocks, capacity 4
    assert_tree_bits(apply_update(u, device="cpu"), jtree(c), "raw")


def test_engine_epoch_fence_forces_full_and_plan_cache_compiles_once():
    eng, jeng = _engines()
    p = np_params()
    held = {}
    for i in range(4):
        p = perturb(p, seed=20 + i)
        _publish(eng, jeng, p)
        for r in ("a", "b"):
            u, _ = _update(eng, jeng, r, f"publish {i} {r}")
            held[r] = apply_update(u, base_params=held.get(r) if u.base_version else None,
                                   device="cpu")
            eng.ack(r, u.version, u.epoch)
            jeng.ack(r, u.version, u.epoch)
    assert all(assert_tree_bits(h, jtree(p)) is None for h in held.values())
    assert (eng.plan_cache.stats.misses, eng.plan_cache.stats.hits) == (1, 3)
    eng.advance_epoch()
    jeng.advance_epoch()
    _publish(eng, jeng, perturb(p))
    u, _ = _update(eng, jeng, "a", "fenced")
    assert u.mode == "full" and u.base_version is None and u.epoch == 1


def test_updates_cross_decode_both_ways():
    eng, jeng = _engines()
    p1, p2 = np_params(), perturb(np_params(), seed=6)
    v = _publish(eng, jeng, p1)
    eng.ack("r", v)
    jeng.ack("r", v)
    _publish(eng, jeng, p2)
    u, ju = eng.update_for("r"), jeng.update_for("r")
    assert u.mode == ju.mode == "delta"
    treedef = tree_flatten(ttree(p2))[1]
    ref_in_port = SyncUpdate(**{**{f.name: getattr(ju, f.name)
                                   for f in dataclasses.fields(ju)}, "treedef": treedef})
    assert verify_update(ref_in_port)
    assert_tree_bits(apply_update(ref_in_port, base_params=ttree(p1), device="cpu"),
                     jtree(p2), "reference -> port")
    port_in_ref = JSyncUpdate(**{**{f.name: getattr(u, f.name)
                                    for f in dataclasses.fields(u)}, "treedef": ju.treedef})
    assert_tree_bits(ttree(p2), japply_update(port_in_ref, base_params=jtree(p1)),
                     "port -> reference")


# ---------------------------------------------------------------------------
# serving ingestion, the publish hook, the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_models():
    """The reference's smoke smollm init and a perturbed version, as numpy."""
    jcfg = jconfigs.get_smoke("smollm_135m")
    old = jax.tree_util.tree_map(np.asarray, jtransformer.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(30)

    def flip(a):
        u = a.view(_UINT[a.dtype.name])
        mask = rng.integers(0, 8, a.shape).astype(u.dtype)
        mask[rng.random(a.shape) > 0.3] = 0
        return (u ^ mask).view(a.dtype)

    new = jax.tree_util.tree_map(flip, old)
    return jcfg, configs.get_smoke("smollm_135m"), old, new


def test_serve_engine_ingest_weights_hot_swap_and_fences(smoke_models):
    _, cfg, old, new = smoke_models
    serve = ServeEngine(cfg, transformer.load_reference_params(old, cfg, device="cpu"),
                        ServeConfig(batch_slots=2, max_len=32))
    held = serve.model.leaves()
    assert serve.weight_version is None
    sync = WeightSyncEngine(policy=POL, plan_cache=PlanCache())
    new_model = transformer.load_reference_params(new, cfg, device="cpu")
    v1 = sync.publish(serve.model.tree())
    assert serve.ingest_weights(sync.update_for("serve")) == v1
    sync.ack("serve", v1)
    v2 = sync.publish(new_model.tree())
    u = sync.update_for("serve")
    assert u.mode == "delta"
    assert serve.ingest_weights(u) == v2
    assert (serve.weight_version, serve.weight_epoch) == (v2, u.epoch)
    assert_tree_bits(serve.model.tree(), jax.tree_util.tree_map(jnp.asarray, new), "swap")
    assert all(a is b for a, b in zip(serve.model.leaves(), held))  # in place
    with pytest.raises(ValueError, match="full send"):
        serve.ingest_weights(dataclasses.replace(u, base_version=v1 - 1))
    with pytest.raises(ValueError, match="full send"):
        serve.ingest_weights(dataclasses.replace(u, epoch=u.epoch + 1))
    msg = u.buckets[0][3]
    bad = dataclasses.replace(msg, lo=dataclasses.replace(
        msg.lo, payload=integrity.flip_bit(msg.lo.payload, 77)))
    corrupt = dataclasses.replace(u, buckets=((*u.buckets[0][:3], bad),) + u.buckets[1:])
    with pytest.raises(integrity.WireIntegrityError, match="checksum"):
        serve.ingest_weights(corrupt)
    assert serve.weight_version == v2  # nothing applied


_PROMPTS = list(np.random.default_rng(4).integers(0, 256, (3, 16)).astype(np.int32))
_SCFG = dict(batch_slots=2, max_len=64, prefill_chunk=16)


def _serve_tokens(eng, request_cls, sync=None, first=None, second=None):
    """Greedy tokens of ``_PROMPTS``; with ``sync``, the engine first ingests
    a full update of ``first`` and then the delta to ``second``."""
    if sync is not None:
        v = sync.publish(first)
        eng.ingest_weights(sync.update_for("r"))
        sync.ack("r", v)
        sync.publish(second)
        u = sync.update_for("r")
        assert u.mode == "delta"
        eng.ingest_weights(u)
    for i, p in enumerate(_PROMPTS):
        eng.submit(request_cls(rid=i, prompt=p, max_new=6))
    return sorted((r.rid, tuple(r.out)) for r in eng.run())


@pytest.fixture(scope="module")
def perturbed_tokens(smoke_models):
    """The port's greedy tokens on the perturbed weights, no sync involved."""
    _, cfg, _, new = smoke_models
    return _serve_tokens(ServeEngine(cfg, transformer.load_reference_params(
        new, cfg, device="cpu"), ServeConfig(**_SCFG)), Request)


def test_greedy_tokens_after_a_delta_ingest_match_reference(smoke_models, perturbed_tokens):
    """Each package's engine ingests a full update of the perturbed weights,
    then the delta back to the reference's init, and serves the same prompts:
    the tokens are the reference's.  The delta is the XOR of the two
    versions, the same bits either way round.  The tokens are held on the
    init because there the two forwards agree token for token
    (``test_torch_serve.py``); on the perturbed weights they do not, with no
    sync involved (the next test).  The other direction is held within the
    port: a delta to the perturbed weights serves the tokens of an engine
    built on them."""
    jcfg, cfg, old, new = smoke_models
    assert cfg.vocab == 256  # _PROMPTS' token range
    load = lambda t: transformer.load_reference_params(t, cfg, device="cpu")  # noqa: E731
    jload = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    got = _serve_tokens(ServeEngine(cfg, load(new), ServeConfig(**_SCFG)), Request,
                        WeightSyncEngine(policy=POL, plan_cache=PlanCache()),
                        load(new).tree(), load(old).tree())
    want = _serve_tokens(JServeEngine(jcfg, jload(new), JServeConfig(**_SCFG)), JRequest,
                         JWeightSyncEngine(policy=JPOL, plan_cache=jsched.PlanCache()),
                         jload(new), jload(old))
    assert got == want
    forward = _serve_tokens(ServeEngine(cfg, load(old), ServeConfig(**_SCFG)), Request,
                            WeightSyncEngine(policy=POL, plan_cache=PlanCache()),
                            load(old).tree(), load(new).tree())
    assert forward == perturbed_tokens


def test_perturbed_weights_flip_a_near_tied_token_without_sync(smoke_models,
                                                               perturbed_tokens):
    """Why the test above holds tokens on the init weights: each package's
    engine built directly on the perturbed weights, with no sync at all,
    serves the same tokens but one.  Request 2's third token is 209 in the
    port and 36 in the reference: XLA:CPU rounds inside a bf16 sigmoid,
    torch rounds once (ROADMAP Queue C), and that last-bit difference flips
    a near-tied greedy choice."""
    jcfg, _, _, new = smoke_models
    want = _serve_tokens(JServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, new),
                                      JServeConfig(**_SCFG)), JRequest)
    got = perturbed_tokens
    assert got[:2] == want[:2]
    assert got[2][1][:2] == want[2][1][:2]
    assert (got[2][1][2], want[2][1][2]) == (209, 36)


def test_make_publish_hook_cadence():
    eng = WeightSyncEngine(policy=POL, plan_cache=PlanCache())
    jeng = JWeightSyncEngine(policy=JPOL, plan_cache=jsched.PlanCache())
    cfg = configs.get_smoke("smollm_135m")
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    hook, jhook = (step_lib.make_publish_hook(eng, every=2),
                   jmake_publish_hook(jeng, every=2))
    out = [hook(step_lib.TrainState(model=model, opt={}, meta=None, step=s))
           for s in (1, 2, 3, 4)]
    jout = [jhook({"params": jtree(np_params()), "step": jnp.asarray(s)}) for s in (1, 2, 3, 4)]
    assert out == jout == [None, 1, None, 2] and eng.store.version == 2
    assert_tree_bits(eng.store.latest()[0], jax.tree_util.tree_map(
        lambda t: jnp.asarray(np_of(t)), model.tree()), "published")


def test_rl_weight_sync_cli_on_the_cpu_launches_no_kernel(capsys):
    kernels.clear_launch_counts()
    rl_weight_sync.main(["--arch", "smollm_135m", "--smoke", "--device", "cpu",
                         "--batch", "2", "--seq", "32", "--prompt-len", "16",
                         "--max-new", "4"])
    out = capsys.readouterr().out
    modes = [line.split("|")[3].strip() for line in out.splitlines()
             if line.count("|") == 6 and "rollout" in line]
    assert modes == ["full", "delta", "full", "delta", "delta", "full"], out
    assert "identical to a fresh engine" in out and "1 miss, 4 hits" in out
    assert not any(kernels.launch_counts().values())
