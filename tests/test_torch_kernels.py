"""Plain versions of the port's CUDA kernels held against the JAX reference.

* ``encode_fused``: bit-exact against the Pallas kernel in interpret mode
  (``repro.kernels.encode_fused``) and against ``repro.kernels.ref``.
* ``ops.encode_fused`` / ``encode_fused_chunks``: bit-exact, field by field,
  against the reference's ``ops`` (``use_pallas=False``) on ragged n.
* ``split_with_stats`` (plane_split): bit-exact against the reference's
  plain version and its Pallas kernel in interpret mode; a ragged n raises.
* ``decode_reduce``: bit-exact against the Pallas kernel in interpret mode
  on inputs whose decoded values and sums are never subnormal, because
  XLA:CPU flushes f32 subnormals to zero and the port keeps IEEE subnormals;
  a separate test holds the port's subnormal arithmetic against numpy.

The CUDA kernels themselves run only on the card: ``test_torch_gpu.py``
compares them with these plain versions there and skips elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import packing as jpacking
from repro.kernels import decode_reduce as jdecode_reduce
from repro.kernels import encode_fused as jencode_fused
from repro.kernels import ops as jops
from repro.kernels import plane_split as jplane_split
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.core import codec, packing
from repro_torch.kernels import decode_reduce, encode_fused, ops, plane_split, ref
from torch_port_util import (FORMATS, assert_bits_equal, grad_like_bits,
                             np_of, to_jax, to_torch)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("width", [2, 5, 8])
def test_plain_encode_fused_matches_reference(fmt, width):
    bits = grad_like_bits(fmt, 512 * 16, seed=7)
    got = encode_fused.encode_fused(to_torch(bits, fmt), width, 512)
    want = jref.encode_fused(to_jax(bits, fmt), width, 512)
    for name, g, w in zip(("payload", "lo", "bases", "rng"), got, want):
        assert g.dtype == torch.int32
        assert_bits_equal(g, w, f"{fmt} w={width} {name}")


@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_encode_fused_matches_pallas_interpret(fmt):
    bits = grad_like_bits(fmt, 512 * 8, seed=8)
    got = encode_fused.encode_fused(to_torch(bits, fmt), 5, 512)
    want = jencode_fused.encode_fused(to_jax(bits, fmt), 5, 512, interpret=True)
    for name, g, w in zip(("payload", "lo", "bases", "rng"), got, want):
        assert_bits_equal(g, w, f"{fmt} {name}")


def _assert_wire_equal(got: dict, want: dict, ctx: str):
    assert set(got) == set(want)
    for k in want:
        assert_bits_equal(got[k], want[k], f"{ctx} {k}")
    assert got["bases"].dtype == torch.uint8 and got["exc_raw"].dtype == torch.uint8
    assert got["lo"].dtype == torch.int32 and got["payload"].dtype == torch.int32
    assert got["exc_idx"].dtype == torch.int32 and got["overflow"].dtype == torch.int32


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n", [1, 37, 512 * 9 + 200])
def test_ops_encode_fused_matches_reference_on_ragged_n(fmt, n):
    """Only NaNs that survive a float copy on XLA:CPU: the reference pads
    ragged input with a float concatenate, which there quiets f32/f16 NaNs
    and replaces bf16/fp8 NaNs by one canonical NaN (see the next test)."""
    bits = grad_like_bits(fmt, n, seed=n, xla_copy_nans=True)
    got = ops.encode_fused(to_torch(bits, fmt), 5)
    want = jops.encode_fused(to_jax(bits, fmt), 5, use_pallas=False)
    _assert_wire_equal(got, want, f"{fmt} n={n}")


@pytest.mark.parametrize("fmt", FORMATS)
def test_ops_encode_fused_keeps_nan_payloads_on_ragged_n(fmt):
    """The port pads in the bits domain, so every NaN payload survives a
    ragged encode; it equals the reference's unfused composition (split,
    then pad and pack the planes), which never copies floats."""
    bits = grad_like_bits(fmt, 512 * 3 + 300, seed=15)
    got = ops.encode_fused(to_torch(bits, fmt), 5)
    exp, lo = jcodec.split_planes(to_jax(bits, fmt))
    lay = jcodec.LAYOUTS[fmt]
    lo_planes = jpacking.bitplane_pack(jpacking._pad_to(
        lo.astype(jnp.uint32), jpacking.GROUP, "zero"), lay.lo_bits)
    pk = jpacking.pack_exponents(exp, width=5)
    want = {"lo": lo_planes, "payload": pk.payload, "bases": pk.bases,
            "exc_idx": pk.exc_idx, "exc_raw": pk.exc_raw, "overflow": pk.overflow}
    _assert_wire_equal(got, want, fmt)


@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "float8_e4m3fn"])
def test_ops_encode_fused_chunks_matches_reference(fmt):
    bits = grad_like_bits(fmt, 4 * 512 * 6, seed=9)
    got = ops.encode_fused_chunks(to_torch(bits, fmt).reshape(4, -1), 5)
    want = jops.encode_fused_chunks(to_jax(bits, fmt).reshape(4, -1), 5,
                                    use_pallas=False)
    _assert_wire_equal(got, want, fmt)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n_blocks", [8, 11])
def test_split_with_stats_matches_reference_and_pallas_interpret(fmt, n_blocks):
    """All-zero blocks, subnormals, +-Inf, NaN payloads and blocks of the
    widest exponent range; 11 blocks is not a multiple of the TPU tile (8
    blocks), which the port does not need."""
    bits = grad_like_bits(fmt, 512 * n_blocks, seed=30 + n_blocks)
    got = ops.split_with_stats(to_torch(bits, fmt))
    names = ("exp", "lo", "base", "rng")
    for name, g, w in zip(names, got, jref.split_with_stats(to_jax(bits, fmt))):
        assert g.dtype == torch.int32
        assert_bits_equal(g, w, f"{fmt} {name}")
    if n_blocks % jplane_split.TILE_B == 0:
        want = jops.split_with_stats(to_jax(bits, fmt), use_pallas=True, interpret=True)
        for name, g, w in zip(names, got, want):
            assert_bits_equal(g, w, f"{fmt} {name} (Pallas interpret)")


def test_split_with_stats_rejects_ragged_n_and_other_devices():
    x = torch.zeros(1024, dtype=torch.bfloat16)
    for bad in (x[:1000], x[:0], x.reshape(2, 512)):
        with pytest.raises(ValueError):
            plane_split.split_with_stats(bad)
    with pytest.raises(ValueError):
        plane_split.split_with_stats(x, block=48)  # not a multiple of 32
    with pytest.raises(ValueError):
        plane_split.split_with_stats(x.to("meta"))
    with pytest.raises(ValueError):
        ref.split_with_stats(x[:1000])


def _decode_inputs(fmt, width, n_g, seed):
    """A real wire (exception blocks included) and a normal f32 accumulator:
    no subnormal operand and, with these magnitudes, no subnormal sum."""
    bits = grad_like_bits(fmt, 32 * n_g, seed=seed, subnormals=False)
    pay, lo, bases, _ = encode_fused.encode_fused(to_torch(bits, fmt), width, 512)
    gb = bases.repeat_interleave(512 // packing.GROUP)
    acc = np.random.default_rng(seed).normal(0, 1, 32 * n_g).astype(np.float32)
    return pay, lo, gb, acc


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("width", [2, 5])
def test_plain_decode_reduce_matches_pallas_interpret(fmt, width):
    pay, lo, gb, acc = _decode_inputs(fmt, width, 256, seed=10)
    got = decode_reduce.decode_reduce(pay, lo, gb, torch.from_numpy(acc.copy()),
                                      fmt, width)
    want = jdecode_reduce.decode_reduce(
        jnp.asarray(np_of(pay)), jnp.asarray(np_of(lo)), jnp.asarray(np_of(gb)),
        jnp.asarray(acc), fmt, width, interpret=True)
    g, w = np_of(got), np_of(want)
    nan = np.isnan(got.numpy()) & np.isnan(np.asarray(want))
    # NaN payloads may differ: fp8 NaN widens to 0x7fc00000 in JAX and
    # 0x7ff00000 in torch; every other bit matches
    assert np.array_equal(g[~nan], w[~nan]), fmt
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_decode_reduce_in_slices_matches_pallas_interpret(fmt, monkeypatch):
    """A wire of more than MERGE_SLICE values decodes a slice at a time
    (100 groups here: slices of 100, 100 and 56) with the same bits."""
    pay, lo, gb, acc = _decode_inputs(fmt, 5, 256, seed=12)
    whole = ref.decode_reduce(pay, lo, gb, torch.from_numpy(acc), fmt, 5)
    monkeypatch.setattr(codec, "MERGE_SLICE", 100 * packing.GROUP)
    got = ref.decode_reduce(pay, lo, gb, torch.from_numpy(acc), fmt, 5)
    assert_bits_equal(got, whole, f"{fmt} sliced")
    want = np.asarray(jdecode_reduce.decode_reduce(
        jnp.asarray(np_of(pay)), jnp.asarray(np_of(lo)), jnp.asarray(np_of(gb)),
        jnp.asarray(acc), fmt, 5, interpret=True))
    nan = np.isnan(got.numpy()) & np.isnan(want)
    assert np.array_equal(np_of(got)[~nan], want.view(np.uint32)[~nan]), fmt
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))


def test_plain_decode_reduce_keeps_ieee_subnormals():
    """XLA:CPU would flush these to zero; the port keeps IEEE semantics,
    held against numpy's f32 add."""
    fmt = "float32"
    vals = np.array([1e-45, -3e-39, 1e-40, 5e-41] * 8, np.float32)
    bits = np.tile(vals, 16)  # one block of 512
    x = torch.from_numpy(bits)
    pay, lo, bases, _ = encode_fused.encode_fused(x, 5, 512)
    gb = bases.repeat_interleave(16)
    acc = np.tile(np.array([2e-45, 1e-39, -1e-40, 0.0], np.float32), 128)
    got = decode_reduce.decode_reduce(pay, lo, gb, torch.from_numpy(acc.copy()),
                                      fmt, 5)
    want = acc + bits
    assert np.any(want != 0) and np.all(np.abs(want[want != 0]) < 1.2e-38)
    assert_bits_equal(got, want, "subnormal sums")


def test_decode_reduce_updates_accumulator_in_place():
    pay, lo, gb, acc = _decode_inputs("bfloat16", 5, 16, seed=11)
    a = torch.from_numpy(acc.copy())
    out = ops.decode_reduce(pay, lo, gb, a, "bfloat16", 5)
    assert out is a
    assert_bits_equal(a, ref.decode_reduce(pay, lo, gb, torch.from_numpy(acc),
                                           "bfloat16", 5), "in place")


def test_wrappers_reject_bad_input_and_other_devices():
    x = torch.zeros(1024, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        encode_fused.encode_fused(x[:1000], 5, 512)  # not a block multiple
    with pytest.raises(ValueError):
        encode_fused.encode_fused(x, 33, 512)  # width out of range
    with pytest.raises(ValueError):  # a device that is neither CPU nor CUDA
        encode_fused.encode_fused(x.to("meta"), 5, 512)
    pay, lo, gb, acc = _decode_inputs("bfloat16", 5, 16, seed=12)
    with pytest.raises(ValueError):
        decode_reduce.decode_reduce(pay, lo, gb, torch.from_numpy(acc[:-32]),
                                    "bfloat16", 5)
    with pytest.raises(ValueError):
        decode_reduce.decode_reduce(pay.to("meta"), lo.to("meta"), gb.to("meta"),
                                    torch.from_numpy(acc).to("meta"), "bfloat16", 5)


def test_cuda_is_never_silently_replaced(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        kernels.resolve_device("cuda")
    assert kernels.resolve_device("cpu") == torch.device("cpu")


def test_launch_shapes_tally_each_launch_under_its_shape():
    kernels.clear_launch_counts()
    try:
        for shape in (("uint8", 4, 5), ("int32", 4, 8), ("uint8", 4, 5)):
            kernels.count_launch("pack", shape)
        kernels.count_launch("unpack")
        assert kernels.launch_shapes("pack") == {("uint8", 4, 5): 2, ("int32", 4, 8): 1}
        assert kernels.launch_shapes("unpack") == {}
        assert kernels.launch_counts()["pack"] == 3 and kernels.launch_counts()["unpack"] == 1
    finally:
        kernels.clear_launch_counts()
    assert kernels.launch_shapes("pack") == {}
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_cpu_runs_launch_no_kernel():
    kernels.clear_launch_counts()
    x = torch.from_numpy(grad_like_bits("bfloat16", 2048, 13)).view(torch.bfloat16)
    w = ops.encode_fused(x, 5)
    acc = torch.zeros(2048)
    ops.decode_reduce(w["payload"], w["lo"],
                      w["bases"].to(torch.int32).repeat_interleave(16), acc,
                      "bfloat16", 5)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
