"""The port's host P2P engine, KV plan and integrity helpers held against the
JAX package, bit for bit, on numpy-seeded inputs.

* ``Compressor``, both codecs: the same ``Message`` arrays (with the
  reference's dtypes), width and ``wire_bytes()`` as the reference, and
  each package decodes the other's message bit-exactly;
* ``compile_kv_plan``: buckets, members, widths, paths and expected wire
  bytes equal the reference's (the port's closed-form ``p2p_wire_bytes``
  against the reference's ``eval_shape`` of its encoder);
* the port's pytree order is ``jax.tree_util``'s; ``crc32_tree`` and
  ``flip_bit`` are the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import integrity as jintegrity
from repro.core.policy import CompressionPolicy as JPolicy
from repro.p2p import engine as jengine
from repro.sched import compile as jcompile
from repro.sched import plan as jplan
from repro_torch import kernels
from repro_torch.core import integrity
from repro_torch.core.policy import CompressionPolicy
from repro_torch.p2p import engine
from repro_torch.sched import cache as plan_cache_lib
from repro_torch.sched import compile as sched_compile
from repro_torch.sched import plan as sched_plan
from repro_torch.tree_util import tree_flatten, tree_unflatten
from torch_port_util import assert_bits_equal, grad_like_bits, to_jax, to_torch

_MSG_ARRAYS = {"packed": ("payload", "bases", "exc_idx", "exc_raw"),
               "rans": ("words", "lens", "freq")}


def _assert_messages_equal(got, want, ctx: str):
    assert (got.dtype_name, tuple(got.shape), got.raw_bytes, got.codec, got.width) == (
        want.dtype_name, tuple(want.shape), want.raw_bytes, want.codec, want.width), ctx
    assert got.lo_payload.dtype == want.lo_payload.dtype == np.uint32
    np.testing.assert_array_equal(got.lo_payload, want.lo_payload, err_msg=ctx)
    for k in _MSG_ARRAYS[got.codec]:
        g, w = got.exp_payload[k], np.asarray(want.exp_payload[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (ctx, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{ctx} {k}")
    for k in ("n", "overflow", "used_bytes"):
        assert got.exp_payload.get(k) == want.exp_payload.get(k), (ctx, k)
    assert got.wire_bytes() == want.wire_bytes(), ctx


@pytest.mark.parametrize("codec_name", ["packed", "rans"])
@pytest.mark.parametrize("fmt,shape", [("bfloat16", (3, 700)), ("float32", (2048,)),
                                       ("float16", (5, 64, 3))])
def test_compressor_messages_match_and_cross_decode(codec_name, fmt, shape):
    n = int(np.prod(shape))
    bits = grad_like_bits(fmt, n, seed=31, specials=False).reshape(shape)
    x, jx = to_torch(bits, fmt), to_jax(bits, fmt)
    port = engine.Compressor(codec_name=codec_name, device="cpu")
    ref = jengine.Compressor(codec_name=codec_name)
    msg = port.encode(x, tensor_class="activation")
    jmsg = ref.encode(jx, tensor_class="activation")
    _assert_messages_equal(msg, jmsg, f"{codec_name} {fmt}")
    assert_bits_equal(port.decode(msg), bits, "port roundtrip")
    assert_bits_equal(port.decode(jmsg), bits, "port decodes the reference's message")
    assert_bits_equal(ref.decode(msg), bits, "reference decodes the port's message")


def test_compressor_takes_the_plan_width_and_caches_the_probe():
    bits = grad_like_bits("bfloat16", 4096, seed=32, specials=False)
    x = to_torch(bits, "bfloat16")
    eng = engine.Compressor(device="cpu")
    probed = eng.encode(x).width
    assert eng._width_cache[("weight", "bfloat16")] == probed
    plan = sched_compile.compile_kv_plan({"k": x}, "data",
                                         policy=CompressionPolicy(min_bytes=0), n_dev=1)
    assert eng.encode(x, plan=plan).width == 5
    assert_bits_equal(eng.decode(eng.encode(x, plan=plan)), bits, "plan width roundtrip")


def test_rans_table_is_built_once_per_class():
    eng = engine.Compressor(codec_name="rans", device="cpu")
    a = to_torch(grad_like_bits("bfloat16", 2048, seed=33), "bfloat16")
    b = to_torch(grad_like_bits("bfloat16", 2048, seed=34), "bfloat16")
    eng.encode(a, tensor_class="w")
    first = eng._table_cache[("w", "bfloat16")]
    msg = eng.encode(b, tensor_class="w")
    assert eng._table_cache[("w", "bfloat16")] is first
    assert_bits_equal(eng.decode(msg), b, "reused table")


def test_transfer_times_and_send_tensor_match_reference_model():
    bits = grad_like_bits("bfloat16", 8192, seed=35, specials=False)
    eng = engine.Compressor(device="cpu")
    msg = eng.encode(to_torch(bits, "bfloat16"))
    jmsg = jengine.Compressor().encode(to_jax(bits, "bfloat16"))
    model = engine.CodecModel()
    got = eng.transfer_times(msg, engine.WireModel(), model)
    want = jengine.Compressor().transfer_times(jmsg, jengine.WireModel(),
                                               jengine.CodecModel())
    assert got == pytest.approx(want, rel=1e-12)
    out, report = engine.send_tensor(to_torch(bits, "bfloat16"), device="cpu")
    assert_bits_equal(out, bits, "send_tensor")
    assert report["ratio"] == pytest.approx(want["ratio"])


# ---------------------------------------------------------------------------
# KV plan
# ---------------------------------------------------------------------------

def _caches(kind: str):
    """A cache pytree as torch tensors and as the same numpy arrays for JAX."""
    rng = np.random.default_rng(7)
    bf = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    if kind == "serve":
        tree = {"pos": np.array(24, np.int32),
                "blocks": ({"kv": {"k": bf(2, 1, 64, 3, 16), "v": bf(2, 1, 64, 3, 16)}},)}
        dts = {"k": torch.bfloat16, "v": torch.bfloat16}
    else:
        tree = {"a": bf(300), "b": {"c": bf(5, 7), "d": rng.integers(0, 9, 4).astype(np.int32)},
                "e": [bf(40), bf(3)], "z": bf(1000)}
        dts = {"c": torch.float16, "z": torch.bfloat16}
    leaves, treedef = tree_flatten(tree)
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    out = []
    for path, leaf in zip(paths, leaves):
        name = getattr(path[-1], "key", None)
        t = torch.from_numpy(np.asarray(leaf))
        if name in dts:
            t = t.to(dts[name])
        out.append(t)
    ttree = tree_unflatten(treedef, out)
    jtree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [jnp.asarray(t.float().numpy()).astype(str(t.dtype).removeprefix("torch."))
         if t.is_floating_point() else jnp.asarray(t.numpy()) for t in out])
    return ttree, jtree


@pytest.mark.parametrize("kind", ["serve", "mixed"])
def test_tree_flatten_has_the_reference_leaf_order(kind):
    ttree, jtree = _caches(kind)
    leaves, treedef = tree_flatten(ttree)
    jleaves = jax.tree_util.tree_leaves(jtree)
    assert [tuple(t.shape) for t in leaves] == [tuple(j.shape) for j in jleaves]
    assert [str(t.dtype).removeprefix("torch.") for t in leaves] == [
        j.dtype.name for j in jleaves]
    assert tree_unflatten(treedef, leaves).keys() == ttree.keys()


@pytest.mark.parametrize("kind", ["serve", "mixed"])
@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("min_bytes", [0, 1 << 20, 600])
def test_kv_plan_matches_reference(kind, n_dev, min_bytes):
    """Against the reference's default strategy, split_send, the only one
    the port ships."""
    ttree, jtree = _caches(kind)
    plan = sched_compile.compile_kv_plan(ttree, "data",
                                         policy=CompressionPolicy(min_bytes=min_bytes),
                                         n_dev=n_dev)
    jp = jcompile.compile_kv_plan(jtree, "data", policy=JPolicy(min_bytes=min_bytes),
                                  n_dev=n_dev, strategy="split_send")
    assert (plan.kind, plan.axis, plan.n_dev, plan.raw_leaf_ix, plan.n_leaves) == (
        jp.kind, jp.axis, jp.n_dev, jp.raw_leaf_ix, jp.n_leaves)
    assert (plan.backend, plan.use_kernels) == ("cpu", False)
    assert len(plan.buckets) == len(jp.buckets)
    for b, jb in zip(plan.buckets, jp.buckets):
        for f in ("dtype_name", "members", "length", "path", "width", "block",
                  "exc_frac", "fused", "encode_fused", "n_dev", "chunk",
                  "wire_bytes", "raw_bytes"):
            assert getattr(b, f) == getattr(jb, f), (f, getattr(b, f), getattr(jb, f))
    assert (plan.wire_bytes, plan.raw_bytes) == (jp.wire_bytes, jp.raw_bytes)
    for name in ("bfloat16", "float32", "float16", "int32"):
        assert plan.width_for_dtype(name) == jp.width_for_dtype(name)


@pytest.mark.parametrize("fmt", ["bfloat16", "float32", "float8_e4m3fn"])
@pytest.mark.parametrize("n,width", [(512, 1), (512 * 7, 5), (512 * 300, 8)])
def test_p2p_wire_bytes_closed_form_matches_reference(fmt, n, width):
    got = sched_compile.p2p_wire_bytes(n, getattr(torch, fmt), width=width,
                                       block=512, exc_frac=0.02)
    assert got == jcompile.p2p_wire_bytes(n, jnp.dtype(fmt), width=width, block=512,
                                          exc_frac=0.02)


@pytest.mark.parametrize("field,value", [("allreduce_algorithm", "ring"),
                                         ("fused_decode_reduce", False),
                                         ("fused_encode", False)])
def test_policy_refuses_the_knobs_the_port_does_not_run(field, value):
    """The port now runs every value of these knobs that the reference runs:
    each is taken, with the reference's plan fingerprint; only an algorithm
    that neither runs is refused."""
    pol, jpol = CompressionPolicy(**{field: value}), JPolicy(**{field: value})
    assert getattr(pol, field) == getattr(jpol, field) == value
    assert sched_plan.policy_fingerprint(pol) == jplan.policy_fingerprint(jpol)
    with pytest.raises(ValueError, match="allreduce_algorithm"):
        CompressionPolicy(allreduce_algorithm="tree")


def test_policy_fingerprint_and_signature():
    assert sched_plan.policy_fingerprint(CompressionPolicy(), "activation") == \
        jplan.policy_fingerprint(JPolicy(), "activation")
    ttree, _ = _caches("serve")
    sig = sched_plan.tree_signature(ttree)
    assert sig == sched_plan.tree_signature(_caches("serve")[0])
    assert [s for s in sig[1]] == [((2, 1, 64, 3, 16), "bfloat16")] * 2 + [((), "int32")]


def test_cached_kv_plan_hits_on_a_stable_signature():
    ttree, _ = _caches("serve")
    pc = plan_cache_lib.PlanCache()
    pol = CompressionPolicy(min_bytes=0)
    plans = [sched_compile.cached_kv_plan(ttree, "data", policy=pol, n_dev=1,
                                          plan_cache=pc) for _ in range(3)]
    assert plans[0] is plans[1] is plans[2]
    assert (pc.stats.misses, pc.stats.hits) == (1, 2)
    sched_compile.cached_kv_plan(ttree, "data", policy=CompressionPolicy(min_bytes=1),
                                 n_dev=1, plan_cache=pc)
    assert pc.stats.misses == 2
    small = plan_cache_lib.PlanCache(capacity=1)
    for mb in (0, 1, 2):
        sched_compile.cached_kv_plan(ttree, "data", policy=CompressionPolicy(min_bytes=mb),
                                     n_dev=1, plan_cache=small)
    assert small.cache_info()["evictions"] == 2 and len(small) == 1


# ---------------------------------------------------------------------------
# integrity
# ---------------------------------------------------------------------------

def test_crc32_tree_and_flip_bit_match_reference():
    rng = np.random.default_rng(9)
    tree = ({"a": rng.integers(0, 9, (3, 4)).astype(np.uint32), "b": [1, "x", 2.5]},
            np.arange(7, dtype=np.uint16), None)
    assert integrity.crc32_tree(tree) == jintegrity.crc32_tree(tree)
    arr = rng.integers(0, 255, 64).astype(np.uint8)
    np.testing.assert_array_equal(integrity.flip_bit(arr, 77), jintegrity.flip_bit(arr, 77))
    assert integrity.crc32_tree(integrity.flip_bit(arr, 5)) != integrity.crc32_tree(arr)


def test_cpu_compressor_launches_no_kernel_and_cuda_is_the_default():
    kernels.clear_launch_counts()
    for codec_name in ("packed", "rans"):
        eng = engine.Compressor(codec_name=codec_name, device="cpu")
        x = to_torch(grad_like_bits("bfloat16", 1024, seed=3), "bfloat16")
        eng.decode(eng.encode(x))
    assert not any(kernels.launch_counts().values())


def test_compressor_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        engine.Compressor()
