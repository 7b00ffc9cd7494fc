"""Shared helpers of the ``test_torch_*`` suites: seeded numpy inputs handed
to both the JAX reference and the torch port, bit-exact converters, and the
worker of the multi-rank gloo tests (which imports torch and the port only,
so spawned ranks start fast)."""
from __future__ import annotations

import numpy as np
import torch

FORMATS = ("float32", "float16", "bfloat16", "float8_e4m3fn", "float8_e5m2")
_BITS = {"float32": (32, 8, 23), "float16": (16, 5, 10), "bfloat16": (16, 8, 7),
         "float8_e4m3fn": (8, 4, 3), "float8_e5m2": (8, 5, 2)}
_UINT = {8: np.uint8, 16: np.uint16, 32: np.uint32}


def random_bits(fmt: str, n: int, seed: int) -> np.ndarray:
    """Uniformly random bit patterns: every NaN payload, +-Inf, subnormal
    and normal of the format occurs."""
    total = _BITS[fmt][0]
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << total, n, dtype=np.uint64).astype(_UINT[total])


# The NaN that every NaN of a format becomes when XLA:CPU copies floats (e.g.
# in a concatenate): bf16 and e5m2 NaNs lose their payload (e5m2 also its
# sign); f32 and f16 NaNs keep it, once quiet; e4m3fn has one NaN per sign.
_XLA_COPY_NAN = {"bfloat16": 0x7FC0, "float8_e5m2": 0x7F}


def grad_like_bits(fmt: str, n: int, seed: int, *, specials: bool = True,
                   subnormals: bool = True, xla_copy_nans: bool = False) -> np.ndarray:
    """Bit patterns of gradient-like values (normal(0, 0.02), 8% exact zeros)
    with an all-zero block, and, if asked, subnormals, +-Inf, NaN payloads
    and exception blocks (smallest and largest exponent in one block).
    ``xla_copy_nans``: only NaNs that an XLA:CPU float copy leaves as they
    are (quiet f32/f16 payloads, the canonical bf16/fp8 NaN)."""
    total, e, m = _BITS[fmt]
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 0.02, n).astype(np.float32)
    vals[rng.random(n) < 0.08] = 0.0
    bits = torch.from_numpy(vals).to(_torch_dtype(fmt)).view(
        {8: torch.uint8, 16: torch.int16, 32: torch.int32}[total]).numpy()
    bits = bits.view(_UINT[total]).astype(np.uint64)
    if n >= 1024:
        bits[512:1024] = 0
    if subnormals and n >= 1300:
        bits[1100:1164] = rng.integers(1, 1 << m, 64)
        bits[1200:1232] = rng.integers(1, 1 << m, 32) | (1 << (total - 1))
    if specials and n >= 1400:
        top = ((1 << e) - 1) << m
        if fmt == "float8_e4m3fn":  # no infinities; this is its one NaN
            bits[1300] = top | ((1 << m) - 1)
        else:
            bits[1300] = top
            bits[1301] = top | (1 << (total - 1))
            bits[1302:1310] = top | rng.integers(1, 1 << m, 8) | (xla_copy_nans << (m - 1))
            if xla_copy_nans and fmt in _XLA_COPY_NAN:
                bits[1302:1310] = _XLA_COPY_NAN[fmt]
        for j in range(3, n // 512, 25):
            bits[j * 512] = 1 << m
            bits[j * 512 + 1] = ((1 << e) - 2) << m
    return bits.astype(_UINT[total])


def _torch_dtype(fmt: str):
    return getattr(torch, fmt)


def to_torch(bits: np.ndarray, fmt: str) -> torch.Tensor:
    """uint bit patterns -> torch float tensor with exactly those bits."""
    signed = {np.dtype(np.uint8): np.uint8, np.dtype(np.uint16): np.int16,
              np.dtype(np.uint32): np.int32}[bits.dtype]
    return torch.from_numpy(bits.view(signed).copy()).view(_torch_dtype(fmt))


def to_jax(bits: np.ndarray, fmt: str):
    import jax
    import jax.numpy as jnp

    return jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.dtype(fmt))


def np_of(t) -> np.ndarray:
    """Torch tensor (wire ints, uint8, int64, or float) or JAX array -> numpy
    with the bits of a same-width unsigned integer where it is integral
    and f32 bits for floats, so the two frameworks compare as equal arrays."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.int32:
            return t.numpy().view(np.uint32)
        if t.dtype in (torch.float32, torch.float16, torch.bfloat16,
                       torch.float8_e4m3fn, torch.float8_e5m2):
            ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
            return t.view(ints).numpy().view(_UINT[8 * t.element_size()])
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.kind == "f" or a.dtype.name in ("bfloat16", "float8_e4m3fn",
                                               "float8_e5m2"):
        return a.view(_UINT[8 * a.dtype.itemsize])
    return a


def ref_array(t: torch.Tensor) -> np.ndarray:
    """A bf16 or f32 torch tensor as a numpy array of its own dtype (bf16
    from ml_dtypes), bit for bit: a leaf of the reference's numpy trees."""
    import ml_dtypes

    return np_of(t).view(ml_dtypes.bfloat16 if t.dtype == torch.bfloat16 else np.float32)


def assert_bits_equal(got, want, ctx=""):
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape, (ctx, g.shape, w.shape)
    if g.dtype != w.dtype:
        g, w = g.astype(np.int64), w.astype(np.int64)
    bad = np.flatnonzero(g.reshape(-1) != w.reshape(-1))
    assert bad.size == 0, (ctx, f"{bad.size} differ; first at {bad[0]}: "
                                f"{g.reshape(-1)[bad[0]]} vs {w.reshape(-1)[bad[0]]}")


# ---------------------------------------------------------------------------
# worker of the multi-rank gloo tests
# ---------------------------------------------------------------------------

def run_gloo_ranks(worker, world: int, tmp_path, *args, timeout: float = 120.0) -> list:
    """Run ``worker(rank, world, out_path, *args)`` in ``world`` spawned
    processes joined into one gloo group over a ``FileStore`` under
    ``tmp_path`` (no port, so parallel test workers never collide).  Each
    rank runs on one intra-op thread: the ranks share the host's cores with
    each other and with the other test workers.  Each rank saves its results
    as ``.npz`` at ``out_path``; returns them in rank order."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    procs = [ctx.Process(target=_gloo_rank, args=(worker, r, world, store, outs[r], *args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0] * world, [p.exitcode for p in procs]
    return [dict(np.load(o)) for o in outs]


def _gloo_rank(worker, rank, world, store, out, *args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        worker(rank, world, out, *args)
    finally:
        dist.destroy_process_group()


def collectives_rank(rank: int, world: int, out: str, fmt: str, n: int,
                     width: int) -> None:
    """Compressed and raw reduce-scatter and all-gather of this rank's
    seeded input (``grad_like_bits(fmt, n, seed=rank, subnormals=False)``)."""
    from repro_torch.core import compressed_collectives as cc
    from repro_torch.optim import zero1

    x = to_torch(grad_like_bits(fmt, n, seed=rank, subnormals=False), fmt)
    red, flag = cc.reduce_scatter_compressed(x, width=width)
    raw = zero1._raw_reduce_scatter(cc._pad_flat(x, world * 512), None, world)
    shard = x[rank * (n // world): (rank + 1) * (n // world)]
    gat, gflag = cc.all_gather_compressed(shard, width=width)
    raw_gat = cc.raw_all_gather(cc._pad_flat(shard, 512), None)
    np.savez(out, red=np_of(red), raw=np_of(raw), flag=int(flag),
             gat=np_of(gat), raw_gat=np_of(raw_gat), gflag=int(gflag))


def train_twin_rank(rank: int, world: int, out: str, steps: int, batch: int,
                    seq: int) -> None:
    """ZeRO-1 smollm SMOKE training on the CPU, compressed then raw, from
    the same seed: losses and final parameter bits of both twins."""
    from repro_torch.launch import train

    res = {}
    for tag, compress in (("comp", True), ("raw", False)):
        run = train.train("smollm_135m", steps=steps, batch=batch, seq=seq,
                          compress=compress, smoke=True, device="cpu", lr=1e-3,
                          warmup=2)
        res[f"{tag}_losses"] = np.array(run.losses)
        res[f"{tag}_params"] = np.concatenate(
            [np_of(p).view(np.uint8).reshape(-1) for p in run.state.model.leaves()])
        res[f"{tag}_retries"] = run.retries
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# workers of the all-reduce family's multi-rank tests
# ---------------------------------------------------------------------------

PSUM_N = 512 * 8 + 300  # a ragged bucket: 8 blocks and a tail
A2A_INNER = 512 * 2 + 40  # an all_to_all row: 2 blocks and a tail
PSUM_VARIANTS = {  # name -> CompressionPolicy overrides (min_bytes=0)
    "two_shot": {},
    "unfused_encode": {"fused_encode": False},
    "unfused_decode": {"fused_decode_reduce": False},
    "ring": {"allreduce_algorithm": "ring"},
    "ring_unfused": {"allreduce_algorithm": "ring", "fused_encode": False,
                     "fused_decode_reduce": False},
}
REPORT_FIELDS = ("name", "raw_bytes", "wire_bytes", "fused", "decode_hbm_bytes",
                 "encode_fused", "encode_hbm_bytes")


def psum_bits(rank: int, n: int = PSUM_N, fmt: str = "bfloat16") -> np.ndarray:
    """Rank ``rank``'s seeded gradient-like input (no subnormals: XLA:CPU
    flushes them in the reference's reduce)."""
    return grad_like_bits(fmt, n, seed=100 + rank, subnormals=False)


def exact_f32(rank: int, n: int) -> np.ndarray:
    """Small integers times powers of two: the f32 sum of up to four ranks
    is exact, so it is the same in every summation order (the backend's
    all_reduce fixes none)."""
    rng = np.random.default_rng(200 + rank)
    return (rng.integers(-64, 64, n) * 2.0 ** rng.integers(-8, 8, n)).astype(np.float32)


def report_rows(reports) -> list:
    return [[getattr(r, f) for f in REPORT_FIELDS] for r in reports]


def saved_reports(reports) -> np.ndarray:
    """WireReport rows as a JSON string array (``np.load`` takes no pickles)."""
    import json

    return np.array(json.dumps(report_rows(reports)))


def _psum_tree(rank: int):
    """A mixed tree: two bf16 leaves, f32 leaves large and small, an int32
    leaf (raw: not a codec float)."""
    x = to_torch(psum_bits(rank), "bfloat16")
    return {"w": x[:3000].reshape(60, 50), "emb": x[3000:], "norm": torch.from_numpy(
        exact_f32(rank, 700)), "bias": torch.from_numpy(exact_f32(rank + 7, 9)),
        "step": torch.arange(5, dtype=torch.int32) * (rank + 1)}


def psum_rank(rank: int, world: int, out: str) -> None:
    """Every member of the all-reduce family on this rank's seeded inputs:
    psum_compressed in each of PSUM_VARIANTS (values, flags, WireReports),
    psum_raw_twoshot, psum_safe, all_to_all_compressed, ppermute_compressed
    (a ring shift, and one pair only), tree_psum_compressed and
    psum_with_plan on a mixed tree, and at four ranks
    psum_compressed_hierarchical over 2 pods x 2 data ranks (pod-major)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import sched
    from repro_torch.core import compressed_collectives as cc
    from repro_torch.core.policy import CompressionPolicy, capture_wire_reports
    from repro_torch.tree_util import tree_flatten

    pol = CompressionPolicy(min_bytes=0)
    x = to_torch(psum_bits(rank), "bfloat16")
    xe = torch.from_numpy(exact_f32(rank, 3000))
    res = {}
    for name, kw in PSUM_VARIANTS.items():
        with capture_wire_reports() as reps:
            got, flag = cc.psum_compressed(x, policy=dataclasses.replace(pol, **kw))
        res[f"psum_{name}"], res[f"flag_{name}"] = np_of(got), int(flag)
        res[f"reports_{name}"] = saved_reports(reps)
    res["raw_twoshot"] = np_of(cc.psum_raw_twoshot(x))
    res["raw_twoshot_f32"] = np_of(cc.psum_raw_twoshot(xe))
    res["safe_f32"] = np_of(cc.psum_safe(xe))
    res["safe_bf16"] = np_of(cc.psum_safe(xe.to(torch.bfloat16)))
    res["gated_raw"] = np_of(cc.psum_compressed(x, policy=CompressionPolicy.disabled())[0])
    rows = x[: world * A2A_INNER].reshape(world, A2A_INNER)
    for tag, p in (("a2a", pol), ("a2a_unfused", dataclasses.replace(pol, fused_encode=False)),
                   ("a2a_raw", CompressionPolicy.disabled())):
        got, flag = cc.all_to_all_compressed(rows, policy=p)
        res[tag], res[f"flag_{tag}"] = np_of(got), int(flag)
    shift = [(i, (i + 1) % world) for i in range(world)]
    for tag, perm, p in (("pp_shift", shift, pol), ("pp_pair", [(0, world - 1)], pol),
                         ("pp_raw", shift, CompressionPolicy.disabled())):
        got, flag = cc.ppermute_compressed(x, perm, policy=p)
        res[tag], res[f"flag_{tag}"] = np_of(got), int(flag)
    tree = _psum_tree(rank)
    for tag, fn in (("tree", cc.tree_psum_compressed), ("plan", sched.psum_with_plan)):
        with capture_wire_reports() as reps:
            got, flag = fn(tree, policy=pol)
        for i, leaf in enumerate(tree_flatten(got)[0]):
            res[f"{tag}_{i}"] = np_of(leaf)
        res[f"flag_{tag}"] = int(flag)
        res[f"reports_{tag}"] = saved_reports(reps)
    if world == 4:
        pods = [dist.new_group([2 * p, 2 * p + 1]) for p in range(2)]
        datas = [dist.new_group([d, d + 2]) for d in range(2)]
        intra, inter = pods[rank // 2], datas[rank % 2]
        got, flag = cc.psum_compressed_hierarchical(x, intra, inter, policy=pol)
        res["hier"], res["flag_hier"] = np_of(got), int(flag)
        got, _ = cc.psum_compressed_hierarchical(
            x, intra, inter, policy=dataclasses.replace(pol, fused_encode=False,
                                                        fused_decode_reduce=False))
        res["hier_unfused"] = np_of(got)
        got, _ = cc.psum_compressed_hierarchical(xe, intra, inter,
                                                 policy=CompressionPolicy.disabled())
        res["hier_raw_f32"] = np_of(got)
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# worker of the P2P wire's multi-rank tests (core/split_send, the in-mesh KV
# and weight-sync wires)
# ---------------------------------------------------------------------------

SPLIT_SIZES = (100, 513, 1537, 2048, 2065)
SPLIT_STRATEGIES = ("split_send", "encode_send", "chunked")
SPLIT_PERMS = {"swap": [(0, 1), (1, 0)], "pair": [(0, 1)]}  # "pair": rank 0 untargeted
SPLIT_WIDTH = 5
REDUCE_N = 2065
DELTA_N = 2065
DELTA_WIDTHS = {"warm": (2, 4), "overflow": (1, 1)}


def split_bits(fmt: str, n: int, rank: int, *, subnormals: bool = True) -> np.ndarray:
    """Rank ``rank``'s seeded input of the P2P tests: gradient-like values
    with specials and exception blocks; NaNs that survive the reference's
    float-copy pad; subnormals only where no f32 add follows."""
    return grad_like_bits(fmt, n, seed=1000 + 31 * rank + n, subnormals=subnormals,
                          xla_copy_nans=True)


def reduce_acc(n: int, rank: int) -> np.ndarray:
    """A reducing receiver's f32 accumulator: normal values, no subnormals."""
    return np.random.default_rng(2000 + rank).normal(0, 1, n).astype(np.float32)


def delta_pair(fmt: str, n: int, rank: int) -> tuple:
    """(x, base) bits of a warm XOR delta: the base version both ends hold
    (the same on every rank) and this rank's next version, whose low
    mantissa bits (three at most) moved where the exponent is not all ones
    (its NaNs, the canonical ones that survive the reference's float copy,
    stay)."""
    total, e, m = _BITS[fmt]
    base = grad_like_bits(fmt, n, seed=3000, subnormals=True, xla_copy_nans=True)
    flips = np.random.default_rng(3001 + rank).integers(0, 1 << min(m, 3), n).astype(
        base.dtype)
    flips[(base >> m) & ((1 << e) - 1) == (1 << e) - 1] = 0
    return base ^ flips, base


def p2p_tree(rank: int) -> dict:
    """A KV-cache-like pytree: bf16 K and V leaves, an f32 leaf, an int32
    scalar (a raw 0-d leaf)."""
    bits = split_bits("bfloat16", 2 * 2 * 64 * 4 * 8, rank)
    kv = to_torch(bits, "bfloat16").reshape(2, 2, 64, 4, 8)
    return {"k": kv[0], "v": kv[1],
            "b": to_torch(split_bits("float32", 300, rank), "float32"),
            "pos": torch.tensor(7 + rank, dtype=torch.int32)}


def weight_trees(rank: int) -> tuple:
    """(weights, base): a bf16 leaf one warm step from its base version, a
    bf16 and an f32 leaf equal to theirs, an int32 leaf outside the codec."""
    bits, base = delta_pair("bfloat16", 3000, rank)
    same = {"v": to_torch(split_bits("bfloat16", 1000, 9), "bfloat16").reshape(10, 100),
            "b": to_torch(split_bits("float32", 600, 9), "float32"),
            "step": torch.arange(3, dtype=torch.int32) + rank}
    return ({"w": to_torch(bits, "bfloat16").reshape(30, 100), **same},
            {"w": to_torch(base, "bfloat16").reshape(30, 100), **same})


def split_send_rank(rank: int, world: int, out: str) -> None:
    """Every P2P wire on this rank's seeded inputs, along each of
    SPLIT_PERMS: the three strategies (5 formats x SPLIT_SIZES, values,
    flags, WireReports), the reducing receiver fused and unfused, the raw
    dispatch, delta_send and wsync_dispatch (warm and overflowing),
    transfer_cache and sync_weights with their plan twins."""
    from repro_torch import sched
    from repro_torch.core import split_send as ss
    from repro_torch.core.policy import CompressionPolicy, capture_wire_reports
    from repro_torch.sched.cache import PlanCache
    from repro_torch.serve.kv_transfer import transfer_cache
    from repro_torch.sync.wire import sync_weights
    from repro_torch.tree_util import tree_flatten

    fns = {"split_send": ss.split_send, "encode_send": ss.encode_send,
           "chunked": ss.chunked_pipeline_send}
    pol = CompressionPolicy(min_bytes=0)
    res = {}
    for ptag, perm in SPLIT_PERMS.items():
        for fmt in FORMATS:
            for n in SPLIT_SIZES:
                x = to_torch(split_bits(fmt, n, rank), fmt)
                for strat, fn in fns.items():
                    with capture_wire_reports() as reps:
                        got, flag = fn(x, None, perm, width=SPLIT_WIDTH)
                    key = f"{strat}_{fmt}_{n}_{ptag}"
                    res[key], res[f"flag_{key}"] = np_of(got), int(flag)
                    res[f"reports_{key}"] = saved_reports(reps)
            x = to_torch(split_bits(fmt, REDUCE_N, rank, subnormals=False), fmt)
            acc = torch.from_numpy(reduce_acc(REDUCE_N, rank))
            for fused in (True, False):
                got, flag = ss.split_send(x, None, perm, width=SPLIT_WIDTH, reduce_into=acc,
                                          use_fused=fused)
                key = f"reduce_{fused}_{fmt}_{ptag}"
                res[key], res[f"flag_{key}"] = np_of(got), int(flag)
            bits, base = delta_pair(fmt, DELTA_N, rank)
            for dtag, (w, wl) in DELTA_WIDTHS.items():
                got, flag = ss.delta_send(to_torch(bits, fmt), to_torch(base, fmt), None, perm,
                                          width=w, lo_width=wl)
                key = f"delta_{dtag}_{fmt}_{ptag}"
                res[key], res[f"flag_{key}"] = np_of(got), int(flag)
                got, flag = ss.wsync_dispatch(
                    to_torch(bits, fmt), to_torch(base, fmt), None, perm, compressed=True,
                    width=SPLIT_WIDTH, delta_width=w, delta_lo_width=wl)
                res[f"wsync_{key}"], res[f"flag_wsync_{key}"] = np_of(got), int(flag)
        x = to_torch(split_bits("bfloat16", 2065, rank), "bfloat16")
        got, flag = ss.p2p_dispatch(x, None, perm, compressed=False, width=SPLIT_WIDTH)
        res[f"raw_{ptag}"], res[f"flag_raw_{ptag}"] = np_of(got), int(flag)
        tree = p2p_tree(rank)
        for strat in SPLIT_STRATEGIES:
            for tag, fn in (("tc", transfer_cache), ("tc_plan", sched.transfer_cache_with_plan)):
                kw = {"plan_cache": PlanCache()} if tag == "tc_plan" else {}
                got, flag = fn(tree, None, perm, policy=pol, strategy=strat, **kw)
                for i, leaf in enumerate(tree_flatten(got)[0]):
                    res[f"{tag}_{strat}_{ptag}_{i}"] = np_of(leaf)
                res[f"flag_{tag}_{strat}_{ptag}"] = int(flag)
        wtree, wbase = weight_trees(rank)
        for btag, b in (("full", None), ("delta", wbase)):
            for tag, fn in (("sw", sync_weights), ("sw_plan", sched.sync_weights_with_plan)):
                kw = {"cache": PlanCache()} if tag == "sw_plan" else {}
                got, flag = fn(wtree, None, perm, policy=pol, base=b, **kw)
                for i, leaf in enumerate(tree_flatten(got)[0]):
                    res[f"{tag}_{btag}_{ptag}_{i}"] = np_of(leaf)
                res[f"flag_{tag}_{btag}_{ptag}"] = int(flag)
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# the weight-sync fleet's tests (test_torch_faults.py, test_torch_broadcast.py):
# one seeded numpy tree goes to the reference fleet as JAX arrays and to the
# port's as tensors, and the two fleets are compared field for field
# ---------------------------------------------------------------------------

def fleet_params_np(seed: int = 0, *, n_w: int = 2048, n_b: int = 300,
                    step: int = 7) -> dict:
    """The weights of the reference's fleet tests as numpy arrays:
    ``tests/test_faults.py::make_params`` (the defaults) and
    ``tests/test_broadcast.py::fleet_params`` (``n_w=768, n_b=192,
    step=seed``); the bf16 leaf is rounded by JAX, as there."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return {"w": np.asarray(jnp.asarray(rng.normal(0, 0.02, (n_w,)), jnp.bfloat16)),
            "b": np.asarray(jnp.asarray(rng.normal(0, 1, (n_b,)), jnp.float32)),
            "step": np.asarray(step, np.int32)}


def perturb_np(tree: dict, seed: int = 1) -> dict:
    """The reference tests' ``perturb`` on a numpy tree: the same draws of
    ``default_rng(seed)`` in the same (sorted key) order XOR up to three low
    bits into ~30% of every codec float."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(tree):
        a = tree[k]
        if a.dtype.name not in FORMATS:
            out[k] = a
            continue
        u = _UINT[8 * a.dtype.itemsize]
        mask = rng.integers(0, 8, a.shape).astype(np.uint64)
        mask[rng.random(a.shape) > 0.3] = 0
        out[k] = (a.view(u) ^ mask.astype(u)).view(a.dtype)
    return out


class FleetSide:
    """One package's side of a fleet comparison: its fleet API, and its
    tree of a numpy tree (``tree``)."""

    def __init__(self, port: bool):
        self.port = port
        if port:
            from repro_torch.core.policy import CompressionPolicy
            from repro_torch.runtime import faults
            from repro_torch.sched.cache import PlanCache
            from repro_torch import sync
            from repro_torch.tree_util import tree_leaves
        else:
            from repro.core.policy import CompressionPolicy
            from repro.runtime import faults
            from repro.sched.cache import PlanCache
            from repro import sync
            from jax.tree_util import tree_leaves
        self.policy = CompressionPolicy(min_bytes=0)
        self.faults, self.sync, self.PlanCache = faults, sync, PlanCache
        self.tree_leaves = tree_leaves

    def tree(self, np_tree: dict):
        if self.port:
            from repro_torch.models.transformer import numpy_to_torch

            return {k: (numpy_to_torch(a, getattr(torch, a.dtype.name))
                        if a.dtype.name in FORMATS else torch.from_numpy(a.copy()))
                    for k, a in np_tree.items()}
        import jax.numpy as jnp

        return {k: jnp.asarray(a) for k, a in np_tree.items()}

    def engine(self, cache=None):
        return self.sync.WeightSyncEngine(policy=self.policy, plan_cache=cache)

    def fleet(self, names, *, plan=None, cache=None, **cfg_kw):
        kw = {"device": "cpu"} if self.port else {}
        return self.sync.SyncFleet(self.engine(cache), names,
                                   cfg=self.sync.FleetConfig(**cfg_kw), fault_plan=plan, **kw)


def fleet_summary(fleet, side: FleetSide) -> dict:
    """Everything the two packages' fleets must agree on: the trace, stats,
    integrity ledger and wire counts, each replica's protocol state and
    weight bits, the store's versions and the convergence checks."""
    store = fleet.engine.store
    return {
        "trace": list(fleet.trace), "stats": dict(fleet.stats),
        "ledger": fleet.integrity_ledger(), "counts": dict(fleet.wire.counts),
        "sent": fleet.wire.sent, "pending": fleet.wire.pending(),
        "store": (store.version, store.epoch, tuple(store.retained())),
        "converged": fleet.converged(), "bitexact": fleet.verify_bitexact(),
        "replicas": {n: (r.alive, r.version, r.epoch, r.applied, dict(r.rejects),
                         r.stale_seen,
                         None if r.params is None else tuple(
                             np_of(leaf).tobytes() for leaf in side.tree_leaves(r.params)))
                     for n, r in fleet.replicas.items()},
        "orphans": sorted(fleet._orphans),
        "links": {n: (k.failures, k.escalation, k.next_try, k.quarantined)
                  for n, k in fleet._links.items()},
    }


def broadcast_rank(rank: int, world: int, out: str) -> None:
    """The in-mesh broadcast of this rank's ``weight_trees`` over a pipeline
    of k receivers on ranks ``(0, .., k)``, k = 1 .. world - 1, full and as a
    delta, through ``execute_wsync_broadcast`` and ``broadcast_weights``;
    then a star and a tree level (a source repeated) through both, and a raw
    ppermute from rank 0 to every other rank: each must raise ``ValueError``
    on every rank before anything is sent."""
    from repro_torch import sched
    from repro_torch.core import compressed_collectives as cc
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.sync.wire import broadcast_weights
    from repro_torch.tree_util import tree_flatten

    pol = CompressionPolicy(min_bytes=0)
    tree, base = weight_trees(rank)
    res = {}
    for k in range(1, world):
        ranks = tuple(range(k + 1))
        schedule = sched.compile_broadcast_schedule(k, kind="pipeline")
        plan = sched.compile_wsync_plan(tree, "data", policy=pol, n_dev=world,
                                        broadcast="pipeline", n_receivers=k)
        for btag, b in (("full", None), ("delta", base)):
            runs = {"plan": lambda: sched.execute_wsync_broadcast(plan, tree, None, ranks,
                                                                  base=b),
                    "planless": lambda: broadcast_weights(tree, None, schedule, ranks,
                                                          policy=pol, base=b)}
            for tag, fn in runs.items():
                got, flag = fn()
                for i, leaf in enumerate(tree_flatten(got)[0]):
                    res[f"{tag}_{btag}_{k}_{i}"] = np_of(leaf)
                res[f"flag_{tag}_{btag}_{k}"] = int(flag)
    ranks = tuple(range(world))
    for kind in ("star", "tree"):
        schedule = sched.compile_broadcast_schedule(world - 1, kind=kind, fanout=2)
        plan = sched.compile_wsync_plan(tree, "data", policy=pol, n_dev=world,
                                        broadcast=kind, n_receivers=world - 1)
        for tag, fn in (("plan", lambda: sched.execute_wsync_broadcast(plan, tree, None,
                                                                       ranks)),
                        ("planless", lambda: broadcast_weights(tree, None, schedule, ranks,
                                                               policy=pol))):
            try:
                fn()
                res[f"raised_{tag}_{kind}"] = 0
            except ValueError:
                res[f"raised_{tag}_{kind}"] = 1
    try:
        cc.raw_ppermute(tree["b"], None, [(0, r) for r in range(1, world)])
        res["raised_raw_ppermute"] = 0
    except ValueError:
        res["raised_raw_ppermute"] = 1
    np.savez(out, **res)


def obs_psum_rank(rank: int, world: int, out: str) -> None:
    """One ``psum_with_plan`` of this rank's ``_psum_tree`` in a fresh
    ``obs`` window: the registry's counters (JSON), the span names, and
    whether the per-bucket ledger equals the window's consolidated
    reports (``check_ledger_exactness``)."""
    import json

    from repro_torch import obs, sched
    from repro_torch.core.policy import CompressionPolicy, capture_wire_reports
    from repro_torch.obs import regret
    from repro_torch.sched.cache import PlanCache

    obs.set_enabled(True)
    with capture_wire_reports() as reports:
        obs.reset()
        sched.psum_with_plan(_psum_tree(rank), None, policy=CompressionPolicy(min_bytes=0),
                             cache=PlanCache())
    np.savez(out, counters=np.array(json.dumps(obs.snapshot()["counters"])),
             spans=np.array(json.dumps([s.name for s in obs.spans()])),
             exact=int(regret.check_ledger_exactness(reports)["ok"]))


# ---------------------------------------------------------------------------
# worker of the FSDP multi-rank tests
# ---------------------------------------------------------------------------

# local shard shapes (last dim sharded) of the gathered tree; "n" (7,) does
# not divide 2 or 4 ranks, so it stays replicated
FSDP_LOCAL = {"a": ((64, 40), "bfloat16"), "b": ((3, 40, 8), "bfloat16"),
              "c": ((300, 6), "float32"), "n": ((7,), "bfloat16")}
FSDP_VARIANTS = {"fused": {}, "unfused": {"fused_encode": False, "fused_decode_reduce": False},
                 "raw": {"enabled": False}}


def fsdp_bits(shape, fmt: str, seed: int) -> np.ndarray:
    """Seeded gradient-like bits with all-zero and exception blocks and no
    Inf, NaN or subnormal (their sums are not what this checks)."""
    n = int(np.prod(shape))
    bits = grad_like_bits(fmt, n, seed, subnormals=False)
    bits[1300:1310] = 0
    return bits.reshape(shape)


def fsdp_full_shape(shape, world: int) -> tuple:
    return tuple(shape[:-1]) + (shape[-1] * world,)


def fsdp_rank(rank: int, world: int, out: str, steps: int, batch: int, seq: int) -> None:
    """On this rank: ``gather_tree`` of its seeded shards (``FSDP_LOCAL``,
    seed 200 + rank) under each of FSDP_VARIANTS, the gathered leaves and,
    after a backward of seeded cotangents (seed 300 + rank), the shards'
    gradients; then ``steps`` FSDP train steps of smollm SMOKE at 2
    microbatches (``fsdp_min_bytes=0``), compressed and raw, from the same
    seed: losses, gnorms and the final shards' bytes."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch.train import deterministic
    from repro_torch.optim import fsdp
    from repro_torch.optim.optimizers import OptimConfig
    from repro_torch.sched.cache import PlanCache
    from repro_torch.train import step as step_lib

    res = {}
    base = CompressionPolicy(min_bytes=0)
    for name, kw in FSDP_VARIANTS.items():
        tree = {k: to_torch(fsdp_bits(s, d, 200 + rank + 10 * i), d).requires_grad_()
                for i, (k, (s, d)) in enumerate(FSDP_LOCAL.items())}
        plan = fsdp.plan_fsdp(tree, world, min_shard_bytes=0)
        full, flag = fsdp.gather_tree(plan, tree, policy=dataclasses.replace(base, **kw),
                                      cache=PlanCache())
        outs, cts = [], []
        for i, (k, (s, d)) in enumerate(FSDP_LOCAL.items()):
            res[f"{name}_full_{k}"] = np_of(full[k])
            if full[k] is not tree[k]:
                outs.append(full[k])
                cts.append(to_torch(fsdp_bits(fsdp_full_shape(s, world), d,
                                              300 + rank + 10 * i), d))
        torch.autograd.backward(outs, cts)
        for k, t in tree.items():
            if t.grad is not None:
                res[f"{name}_grad_{k}"] = np_of(t.grad)
        res[f"{name}_flag"] = int(flag)
        res[f"{name}_mask"] = np.array(plan.mask_leaves)
    cfg = configs.get_smoke("smollm_135m")
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, global_batch=batch, seq_len=seq),
                        process_index=rank, process_count=world)
    for tag, pol in (("comp", base), ("rawtrain", CompressionPolicy.disabled())):
        tcfg = step_lib.TrainConfig(partition="fsdp", microbatches=2, fsdp_min_bytes=0,
                                    loss_chunk=16, policy=pol,
                                    optim=OptimConfig(lr=1e-3, warmup_steps=2))
        state = step_lib.build_train_state(cfg, tcfg, generator=torch.Generator().manual_seed(0),
                                           device="cpu")
        losses, gnorms, cache = [], [], PlanCache()
        with deterministic():
            for i in range(steps):
                m = step_lib.fsdp_train_step(state, pipe.tensors_at(i, "cpu"), tcfg,
                                             cache=cache)
                losses.append(float(m["loss"]))
                gnorms.append(float(m["gnorm"]))
        res[f"{tag}_losses"], res[f"{tag}_gnorms"] = np.array(losses), np.array(gnorms)
        res[f"{tag}_params"] = np.concatenate(
            [np_of(p).view(np.uint8).reshape(-1) for p in state.model.leaves()])
        res[f"{tag}_misses"], res[f"{tag}_hits"] = cache.stats.misses, cache.stats.hits
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# the steps over a mesh: the reference on 4 forced host devices (a
# subprocess), the port on 4 gloo ranks
# ---------------------------------------------------------------------------

MESH_RUNS = {  # kind -> (mesh shape, axes, TrainConfig fields)
    "zero1": ((2, 2, 1), ("pod", "data", "model"), {}),
    "fsdp": ((2, 2, 1), ("pod", "data", "model"), {"partition": "fsdp", "fsdp_min_bytes": 0}),
    "dp_only": ((2, 2), ("data", "model"), {"dp_only": True}),
}
MESH_ARCH, MESH_BATCH, MESH_SEQ, MESH_LR, MESH_WARMUP = "smollm_135m", 8, 32, 1e-3, 2
MESH_RS_N = 4 * 512 * 3 + 700  # a ragged ZeRO-1 bucket of 4 ranks' gradients
MESH_RS_POLICIES = {"fused": {}, "unfused": {"fused_decode_reduce": False},
                    "raw": {"enabled": False}}
MESH_GATHER = ((64, 40), "bfloat16")  # an FSDP shard: 4 ranks gather (64, 160)


def _mesh_sync_axes(kind: str, axes: tuple) -> tuple:
    """The axes a mesh run syncs over: (pod, data), or every axis under
    ``dp_only``."""
    return axes if kind == "dp_only" else tuple(a for a in axes if a != "model")


def mesh_rs_input(idx: int) -> np.ndarray:
    """The seeded bf16 gradient bucket of DP index ``idx``."""
    return psum_bits(idx, MESH_RS_N)


def mesh_reference(kind: str, out_dir: str) -> None:
    """The reference's side of a mesh run (``MESH_RUNS[kind]``), in a
    process with 4 forced host devices: the reduce-scatter of each device's
    ``mesh_rs_input`` over the sync axes under each of MESH_RS_POLICIES
    (ZeRO-1's plan executor; FSDP's gather and its backward), then 2 train
    steps of smollm SMOKE at 2 microbatches, compressed and raw, from
    ``PRNGKey(0)``, the global batch placed over the sync axes as the
    reference's launcher places it.  The compressed twin's state is
    checkpointed before its first step (step 0) and after it (step 1) under
    ``out_dir/ckpt``; scalars and bits go to ``out_dir/ref.npz``."""
    import os

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import configs as jconfigs
    from repro import sched as jsched
    from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
    from repro.core.policy import CompressionPolicy as JPolicy
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import DataPipeline as JDataPipeline
    from repro.launch.mesh import make_mesh
    from repro.optim import fsdp as jfsdp
    from repro.optim import optimizers as jopt
    from repro.optim import zero1 as jzero1
    from repro.sched import compile as jcompile
    from repro.train import step as jstep

    shape, axes, fields = MESH_RUNS[kind]
    mesh = make_mesh(shape, axes)
    sync = _mesh_sync_axes(kind, axes)
    dpax = sync if len(sync) > 1 else sync[0]
    res = {}
    shard_map = lambda f, i, o: jax.jit(jax.shard_map(  # noqa: E731
        f, mesh=mesh, in_specs=i, out_specs=o, axis_names=set(axes), check_vma=False))
    for tag, kw in MESH_RS_POLICIES.items():
        pol = JPolicy(min_bytes=0, **kw)
        if kind == "fsdp":
            (lshape, dt) = MESH_GATHER
            gather = jfsdp._make_gather(sync, 6, 5, 512, 0.02, pol.enabled, lshape, dt,
                                        pol.fused_decode_reduce, True)

            def body(local, cot):
                (full, _), vjp = jax.vjp(gather, local)
                (grad,) = vjp((cot, np.zeros((), jax.dtypes.float0)))
                return full, grad

            locs = np.concatenate([fsdp_bits(lshape, dt, 400 + d) for d in range(4)])
            cots = np.concatenate([fsdp_bits(fsdp_full_shape(lshape, 4), dt, 500 + d)
                                   for d in range(4)])
            full, grad = shard_map(body, (P(dpax), P(dpax)), (P(dpax), P(dpax)))(
                to_jax(locs, dt), to_jax(cots, dt))
            res[f"rs_{tag}"] = np_of(grad).reshape(4, -1)
            res[f"ag_{tag}"] = np_of(full).reshape(4, -1)
            continue
        meta = jzero1.plan_buckets({"g": jax.ShapeDtypeStruct((MESH_RS_N,), jnp.bfloat16)}, 4)
        plan = jcompile.cached_zero1_plan(meta, policy=pol, axis_name=sync, n_dev=4)
        pad = meta.padded[0] - MESH_RS_N

        def body(x, plan=plan):
            with jsched.Zero1Execution(plan, sync) as ex:
                gs, f = ex.reduce_scatter(0, x)
            return gs, f[None]

        xs = np.concatenate([np.pad(mesh_rs_input(d), (0, pad)) for d in range(4)])
        gs, flag = shard_map(body, (P(dpax),), (P(dpax), P(dpax)))(to_jax(xs, "bfloat16"))
        res[f"rs_{tag}"] = np_of(gs).reshape(4, -1)
        res[f"rs_{tag}_flag"] = np.asarray(flag)

    cfg = jconfigs.get_smoke(MESH_ARCH)
    pipe = JDataPipeline(JDataConfig(vocab=cfg.vocab, global_batch=MESH_BATCH,
                                     seq_len=MESH_SEQ, seed=0))
    bshard = NamedSharding(mesh, P(dpax, None))
    ckpt = JCheckpointManager(os.path.join(out_dir, "ckpt"))
    for tag, pol in (("comp", JPolicy(min_bytes=0)), ("raw", JPolicy.disabled())):
        tcfg = jstep.TrainConfig(loss_chunk=16, microbatches=2, policy=pol,
                                 optim=jopt.OptimConfig(lr=MESH_LR, warmup_steps=MESH_WARMUP),
                                 **fields)
        state, _ = jstep.build_train_state(cfg, tcfg, mesh, jax.random.PRNGKey(0))
        fn = jax.jit(jstep.build_train_step(cfg, tcfg, mesh)[0])
        if tag == "comp":
            ckpt.save(0, state)
        for i in range(2):
            batch = {k: jax.device_put(jnp.asarray(v), bshard)
                     for k, v in pipe.batch_at(i).items()}
            state, m = fn(state, batch)
            for k in ("loss", "gnorm", "overflow"):
                res[f"{tag}_{k}{i}"] = np.asarray(m[k])
            if tag == "comp" and i == 0:
                ckpt.save(1, state)
                res["opt1"] = np.concatenate([np_of(a).reshape(4, -1) for a in
                                              jax.tree_util.tree_leaves(state["opt"])
                                              if np.ndim(a) > 0], axis=1)
        res[f"{tag}_params"] = np.concatenate(
            [np_of(p).view(np.uint8).reshape(-1)
             for p in jax.tree_util.tree_leaves(state["params"])])
    np.savez(os.path.join(out_dir, "ref.npz"), **res)


def reference_env(out_dir) -> dict:
    """The environment of a reference subprocess: the JAX package on 4
    forced host devices, the repo's ``src`` and ``tests`` on the path, and
    a JAX persistent compilation cache that the subprocesses of one pytest
    run share, so that a program another one has compiled is read back,
    not compiled again.  ``out_dir`` is a directory of
    ``tmp_path_factory``: the cache sits in the run's base directory (under
    xdist, the one above the workers'), so it goes with the run's
    temporary files and never outlives the run."""
    import os
    from pathlib import Path

    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    base = Path(out_dir).parent
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    return dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                JAX_COMPILATION_CACHE_DIR=str(base / "jax_cache"),
                JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
                JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
                # a size bound turns on the cache's file lock: the workers
                # read and write it at once
                JAX_COMPILATION_CACHE_MAX_SIZE=str(4 << 30),
                PYTHONPATH=os.pathsep.join([src, here, os.environ.get("PYTHONPATH", "")]))


def reference_code(module: str, fn: str, kind: str, out_dir) -> str:
    """The ``python -c`` program of a reference subprocess."""
    return f"import {module} as u; u.{fn}({kind!r}, {str(out_dir)!r})"


def run_reference(module: str, fn: str, kind: str, out_dir) -> dict:
    """``module.fn(kind, out_dir)`` in a subprocess of
    :func:`reference_env`; returns the ``ref.npz`` it writes there."""
    import os
    import subprocess
    import sys

    res = subprocess.run([sys.executable, "-c", reference_code(module, fn, kind, out_dir)],
                         env=reference_env(out_dir), capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(os.path.join(str(out_dir), "ref.npz")))


def run_mesh_reference(kind: str, out_dir) -> dict:
    """:func:`mesh_reference` in a subprocess (:func:`run_reference`)."""
    return run_reference("torch_port_util", "mesh_reference", kind, out_dir)


def _mesh_tcfg(kind: str, policy=None):
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.optim.optimizers import OptimConfig
    from repro_torch.train import step as step_lib

    return step_lib.TrainConfig(
        loss_chunk=16, microbatches=2,
        policy=CompressionPolicy(min_bytes=0) if policy is None else policy,
        optim=OptimConfig(lr=MESH_LR, warmup_steps=MESH_WARMUP), **MESH_RUNS[kind][2])


def _mesh_state_from(ckpt_dir: str, step: int, mesh, tcfg):
    """This rank's train state of the checkpoint ``step`` under
    ``ckpt_dir``, restored onto ``mesh`` with ``restore(shardings=)`` into
    a state built on the mesh: through ``ElasticController.rescale`` for
    the latest step, else through the manager."""
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.runtime.fault_tolerance import ElasticController
    from repro_torch.train import step as step_lib
    from repro_torch.tree_util import tree_map_up_to

    cfg = configs.get_smoke(MESH_ARCH)
    mgr = CheckpointManager(ckpt_dir)
    specs_fn = lambda m: step_lib.make_train_state_specs(cfg, tcfg, m)  # noqa: E731
    like = step_lib.build_train_state(cfg, tcfg, generator=torch.Generator().manual_seed(9),
                                      mesh=mesh, device="cpu")
    if step == mgr.latest_step():
        got_mesh, state, got = ElasticController(lambda n: mesh, specs_fn).rescale(
            mgr, lambda m: like, 4, device="cpu")
        assert got_mesh is mesh
    else:
        shardings = tree_map_up_to(lambda _, s: (mesh, s), like.global_like(), specs_fn(mesh))
        state, got = mgr.restore(like, step=step, shardings=shardings, device="cpu")
    assert got == step
    return state


def _flat_f32(tensors) -> np.ndarray:
    return np.concatenate([t.detach().float().reshape(-1).numpy() for t in tensors])


def mesh_rank(rank: int, world: int, out: str, kind: str, ref_dir: str) -> None:
    """The port's side of a mesh run on this gloo rank: its DP index and
    pod-major place; the reduce-scatter of its ``mesh_rs_input`` (FSDP: the
    gather of its shard and the backward of its cotangent) under each of
    MESH_RS_POLICIES; one step from the reference's step-0 checkpoint
    restored onto the mesh, beside the reference's step-1 state restored
    the same way; the step-1 optimizer rows as restored; then 2
    steps compressed and raw from the port's own init (ZeRO-1 through the
    launcher on the mesh).  The restored step-1 state is written as a
    checkpoint under ``ref_dir/port_ckpt`` (gathered, rank 0 writes) and
    restored from it without shardings; whether each restored leaf's
    storage holds only this rank's part."""
    import dataclasses
    import os

    import torch
    import torch.distributed as dist

    from repro_torch import configs, sched
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import fsdp, zero1
    from repro_torch.sched import compile as sched_compile
    from repro_torch.sched.cache import PlanCache
    from repro_torch.train import step as step_lib
    from repro_torch.tree_util import bits_equal, tree_leaves

    shape, axes, _ = MESH_RUNS[kind]
    mesh = mesh_lib.make_mesh(shape, axes, device="cpu")
    tcfg = _mesh_tcfg(kind)
    group, sync, _ = step_lib.sync_group(mesh, tcfg)
    idx = dist.get_rank(group)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = mesh_lib.axis_sizes(mesh)
    place = 0
    for a in sync:
        place = place * sizes[a] + coord[a]
    res = {"idx": idx, "place": place, "sync": np.array(sync)}

    for tag, kw in MESH_RS_POLICIES.items():
        pol = CompressionPolicy(min_bytes=0, **kw)
        if kind == "fsdp":
            lshape, dt = MESH_GATHER
            wire = fsdp.GatherWire(sync, 6, 5, 512, 0.02, pol.enabled, lshape, dt,
                                   pol.fused_decode_reduce, True)
            local = to_torch(fsdp_bits(lshape, dt, 400 + idx), dt).requires_grad_()
            full, _ = wire(local, group)
            (grad,) = torch.autograd.grad(full, local, to_torch(
                fsdp_bits(fsdp_full_shape(lshape, 4), dt, 500 + idx), dt))
            res[f"rs_{tag}"], res[f"ag_{tag}"] = np_of(grad).reshape(-1), np_of(full).reshape(-1)
            continue
        x = to_torch(mesh_rs_input(idx), "bfloat16")
        meta = zero1.plan_buckets([x], 4)
        plan = sched_compile.cached_zero1_plan(meta, policy=pol, axis_name=sync, n_dev=4,
                                               device="cpu", cache=PlanCache())
        (gb,) = zero1.flatten_buckets(meta, [x])
        with sched.Zero1Execution(plan, group) as ex:
            gs, flag = ex.reduce_scatter(0, gb)
        res[f"rs_{tag}"], res[f"rs_{tag}_flag"] = np_of(gs), int(flag)

    cfg = configs.get_smoke(MESH_ARCH)
    ckpt_dir = os.path.join(ref_dir, "ckpt")
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, global_batch=MESH_BATCH, seq_len=MESH_SEQ,
                                   seed=0))
    rows = launch_train.dp_rows(pipe.tensors_at(0, "cpu"), idx, 4)
    state = _mesh_state_from(ckpt_dir, 0, mesh, tcfg)
    with launch_train.deterministic():
        if kind == "fsdp":
            m = step_lib.fsdp_train_step(state, rows, tcfg, cache=PlanCache())
        else:
            m = step_lib.train_step(state, rows, tcfg)
    res.update(loss=float(m["loss"]), gnorm=float(m["gnorm"]), overflow=int(m["overflow"]),
               step=state.step, params=_flat_f32(state.model.leaves()))
    want = _mesh_state_from(ckpt_dir, 1, mesh, tcfg)
    res["ref_params"] = _flat_f32(want.model.leaves())
    res["opt1"] = np.concatenate([np_of(t).reshape(-1) for t in tree_leaves(want.opt)
                                  if t.ndim > 0])
    res["opt1_count"] = int(want.opt["count"])
    if kind != "fsdp":  # replicated parameters: the reference's bits on every rank
        res["step1_bits"] = np.concatenate([np_of(p).view(np.uint8).reshape(-1)
                                            for p in want.model.leaves()])
    port_dir = os.path.join(ref_dir, "port_ckpt")
    CheckpointManager(port_dir).save(1, want)  # gathered to rank 0, which writes
    dist.barrier()
    back, _ = CheckpointManager(port_dir).restore(want, device="cpu")  # no shardings
    res["resume_exact"] = int(bits_equal(back.tree(), want.tree()))
    # restored either way, a leaf's storage is its own part, not the global leaf
    res["own_storage"] = np.array([t.untyped_storage().nbytes() == t.numel() * t.element_size()
                                   for st in (want, back) for t in tree_leaves(st.tree())])

    for tag, compress in (("comp", True), ("raw", False)):
        if kind == "zero1":  # through the launcher on the mesh
            run = launch_train.train(MESH_ARCH, steps=2, batch=MESH_BATCH, seq=MESH_SEQ,
                                     compress=compress, smoke=True, device="cpu",
                                     lr=MESH_LR, warmup=MESH_WARMUP, microbatches=2,
                                     mesh=mesh)
            st, losses = run.state, run.losses
        else:  # the launcher builds neither dp_only nor fsdp_min_bytes=0
            pol = CompressionPolicy(min_bytes=0) if compress else CompressionPolicy.disabled()
            tc = dataclasses.replace(tcfg, policy=pol)
            st = step_lib.build_train_state(cfg, tc, generator=torch.Generator().manual_seed(0),
                                            mesh=mesh, device="cpu")
            step_fn, kw = ((step_lib.fsdp_train_step, {"cache": PlanCache()}) if kind == "fsdp"
                           else (step_lib.train_step, {}))
            with launch_train.deterministic():
                losses = [float(step_fn(
                    st, launch_train.dp_rows(pipe.tensors_at(i, "cpu"), idx, 4), tc, **kw)["loss"])
                    for i in range(2)]
        res[f"{tag}_losses"] = np.array(losses)
        res[f"{tag}_params"] = np.concatenate(
            [np_of(p).view(np.uint8).reshape(-1) for p in st.model.leaves()])
    np.savez(out, **res)


def mesh_restore_refused(rank: int, world: int, out: str, ckpt_dir: str) -> None:
    """A ZeRO-1 checkpoint of 4 data ranks restored onto a (2, 1, 1) mesh:
    the stored rows do not fit 2 ranks, and ``rescale`` raises."""
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime.fault_tolerance import ElasticController
    from repro_torch.train import step as step_lib

    cfg, tcfg = configs.get_smoke(MESH_ARCH), _mesh_tcfg("zero1")
    ctl = ElasticController(
        lambda n: mesh_lib.make_mesh((2, n // 2, 1), ("pod", "data", "model"), device="cpu"),
        lambda m: step_lib.make_train_state_specs(cfg, tcfg, m))
    like = lambda m: step_lib.build_train_state(  # noqa: E731
        cfg, tcfg, generator=torch.Generator().manual_seed(0), mesh=m, device="cpu")
    try:
        ctl.rescale(CheckpointManager(ckpt_dir), like, world, device="cpu")
        msg = ""
    except ValueError as e:
        msg = str(e)
    np.savez(out, msg=np.array(msg))


# ---------------------------------------------------------------------------
# tensor parallelism over 'model' (models/tp): the Functions, the
# vocabulary-parallel embedding and cross-entropy on a group of gloo ranks
# ---------------------------------------------------------------------------

TP_D, TP_F, TP_V = 6, 8, 16  # widths; each divides by 4 ranks


def tp_exact(shape, seed: int) -> np.ndarray:
    """f32 multiples of 1/8 in [-1, 1): their sums and products of two are
    exact in f32 in any order."""
    return (np.random.default_rng(seed).integers(-8, 8, shape) / 8).astype(np.float32)


def tp_ops_rank(rank: int, world: int, out: str) -> None:
    """``models/tp`` on this rank of a world-sized model group: each
    Function forward and backward on exact f32 inputs (the copy's input
    the same on every rank, the rank's own weights and cotangents), the
    vocabulary-parallel embedding and cross-entropy on this rank's block of
    the vocabulary (the labels over all of it, then all in the last rank's
    block), a bf16 SwiGLU split over the ranks, and the bf16 MoE layer with
    its experts split over them (:func:`_tp_moe`)."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import layers, tp

    mg = tp.ModelGroup(dist.group.WORLD)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    res = {}
    x = t(tp_exact((4, TP_D), 0)).requires_grad_()
    w = t(tp_exact((TP_D, 5), 100 + rank))
    y = tp.copy(x, mg) @ w
    (y * t(tp_exact((4, 5), 200 + rank))).sum().backward()
    res["copy_y"], res["copy_dx"] = y.detach().numpy(), x.grad.numpy()

    xr = t(tp_exact((4, TP_D), 300 + rank)).requires_grad_()
    y = tp.reduce(xr, mg)
    y.backward(t(tp_exact((4, TP_D), 400)))
    res["reduce_y"], res["reduce_dx"] = y.detach().numpy(), xr.grad.numpy()

    xg = t(tp_exact((3, 2, 4), 500 + rank)).requires_grad_()
    y = tp.gather(xg, mg, 1)
    y.backward(t(tp_exact((3, 2 * world, 4), 600 + rank)))
    res["gather_y"], res["gather_dx"] = y.detach().numpy(), xg.grad.numpy()

    rows = TP_V // world
    table = t(tp_exact((TP_V, TP_D), 700)[rank * rows:(rank + 1) * rows]).requires_grad_()
    tokens = t(np.random.default_rng(701).integers(0, TP_V, (3, 7)))
    e = tp.vocab_embed(tokens, table, mg)
    e.backward(t(tp_exact((3, 7, TP_D), 702)))
    res["embed_y"], res["embed_dt"] = e.detach().numpy(), table.grad.numpy()

    logits = np.random.default_rng(800).normal(0, 3, (2, 5, TP_V)).astype(np.float32)
    for tag, labels in (("ce", np.random.default_rng(801).integers(0, TP_V, (2, 5))),
                        ("ce_last", np.random.default_rng(802).integers(TP_V - rows, TP_V,
                                                                        (2, 5)))):
        lg = t(logits[..., rank * rows:(rank + 1) * rows]).requires_grad_()
        loss = tp.vocab_ce_sum(lg, t(labels), mg)
        loss.backward()
        res[tag], res[f"{tag}_dlogits"] = float(loss), lg.grad.numpy()

    bf = lambda a: t(a).to(torch.bfloat16)  # noqa: E731
    f = TP_F // world
    xs = bf(np.random.default_rng(900).normal(0, 1, (3, TP_D)).astype(np.float32))
    xs.requires_grad_()
    p = {k: bf(np.random.default_rng(s).normal(0, 0.5, sh).astype(np.float32))
         for k, s, sh in (("w1", 901, (TP_D, TP_F)), ("w3", 902, (TP_D, TP_F)),
                          ("w2", 903, (TP_F, TP_D)))}
    blocks = {k: (v[:, rank * f:(rank + 1) * f] if k != "w2" else v[rank * f:(rank + 1) * f])
              .clone().requires_grad_() for k, v in p.items()}
    y = layers.swiglu(blocks, xs, mg)
    y.backward(bf(np.random.default_rng(904).normal(0, 1, (3, TP_D)).astype(np.float32)))
    res["swiglu_y"] = y.detach().float().numpy()
    res["swiglu_dx"] = xs.grad.float().numpy()
    for k, v in blocks.items():
        res[f"swiglu_d{k}"] = v.grad.float().numpy()
    _tp_moe(res, rank, world, mg)
    np.savez(out, **res)


# expert parallelism in bf16: deepseek-v2-lite SMOKE's MoE layer (8 experts,
# top 2, one shared), dropless and at capacity (the C-1 drop), x and the
# cotangent drawn with numpy
TP_MOE_ARCH = "deepseek_v2_lite_16b"
TP_MOE_CASES = {"dropless": (32, {}),
                "capacity": (80, {"dropless_below": 0, "capacity_factor": 0.5})}


def tp_moe_layer(cfg) -> dict:
    """The MoE leaves (one layer's ``ffn``) drawn with numpy in path order
    at the reference's init scales, rounded to bf16: ``{path: f32 array}``."""
    import torch

    from repro_torch.models import transformer

    rng = np.random.default_rng(4)
    out = {}
    for path, (shape, scale) in transformer.tree_paths(
            transformer._layer_shapes(cfg, cfg.pattern[0])["ffn"]):
        a = np.ones(shape, np.float32) if scale is None else \
            (rng.normal(0, 1, shape) * scale).astype(np.float32)
        out[path] = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return out


def tp_moe_x(cfg, n_tok: int, seed: int) -> np.ndarray:
    """(1, n_tok, D) normal f32 values (x at seed 6, the cotangent at 9),
    rounded to bf16 where they are used."""
    return np.random.default_rng(seed).normal(0, 1, (1, n_tok, cfg.d_model)).astype(np.float32)


def nest_paths(flat: dict) -> dict:
    """``{"a/b": v}`` -> ``{"a": {"b": v}}``."""
    tree = {}
    for path, v in flat.items():
        *keys, last = path.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _tp_moe(res: dict, rank: int, world: int, mg) -> None:
    """The MoE layer with this rank's block of the experts (``spec_moe``:
    ``we1``/``we3``/``we2`` by expert, the shared SwiGLU column/row
    parallel, the router whole) forward and backward in bf16 on each
    ``TP_MOE_CASES`` input; the slot table ``moe_route`` gave it."""
    import torch

    from repro_torch import configs
    from repro_torch.models import layers, transformer

    cfg = configs.get_smoke(TP_MOE_ARCH)
    specs = dict(transformer.tree_paths(layers.spec_moe(cfg)))
    bf = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)  # noqa: E731
    route = layers.moe_route
    for tag, (n_tok, kw) in TP_MOE_CASES.items():
        leaves = {}
        for path, a in tp_moe_layer(cfg).items():
            t = bf(a)
            for d, e in enumerate(specs[path]):
                if e == "model":
                    t = t.chunk(world, d)[rank]
            leaves[path] = t.clone().requires_grad_()
        slots = []

        def recorded(*args, **kwargs):
            out = route(*args, **kwargs)
            slots.append(out[2])
            return out

        layers.moe_route = recorded
        try:
            x = bf(tp_moe_x(cfg, n_tok, 6)).requires_grad_()
            y = layers.moe(nest_paths(leaves), x, cfg, mg=mg, **kw)
            y.backward(bf(tp_moe_x(cfg, n_tok, 9)))
        finally:
            layers.moe_route = route
        (slot,) = slots
        k = cfg.moe.top_k
        res[f"moe_{tag}_tok"] = torch.where(slot < n_tok * k, slot // k, n_tok).numpy()
        res[f"moe_{tag}_y"] = y.detach().float().numpy()
        res[f"moe_{tag}_dx"] = x.grad.float().numpy()
        for path, t in leaves.items():
            res[f"moe_{tag}_d/{path}"] = t.grad.float().numpy()


# ---------------------------------------------------------------------------
# the recurrent mixers over 'model': Mamba over its inner channels, mLSTM
# and sLSTM over their heads, on a group of gloo ranks
# ---------------------------------------------------------------------------

# case -> (arch, mixer, config overrides, x shape); Mamba in f32 (its bf16
# scan backward is ill-conditioned in both packages), the cells in bf16;
# "_gqa": 4 query heads over 2 KV heads, so at 4 ranks a rank's query head
# reads a KV head whose columns split inside it
TP_MIXER_CASES = {
    "mamba": ("jamba_v0_1_52b", "mamba", {"dtype": "float32"}, (2, 64)),
    "mlstm": ("xlstm_350m", "mlstm", {}, (2, 16)),
    "slstm": ("xlstm_350m", "slstm", {}, (2, 16)),
    "mlstm_gqa": ("xlstm_350m", "mlstm", {"n_heads": 4, "kv_heads": 2}, (2, 16)),
    "slstm_gqa": ("xlstm_350m", "slstm", {"n_heads": 4, "kv_heads": 2}, (2, 16)),
}


def tp_mixer_config(case: str, package: str = "torch"):
    """The case's SMOKE config (``package`` "torch" or "jax") with its
    overrides, and its mixer's ``LayerSpec``."""
    import dataclasses

    arch, mixer, over, _ = TP_MIXER_CASES[case]
    if package == "jax":
        from repro import configs as jconfigs
        cfg = jconfigs.get_smoke(arch)
    else:
        from repro_torch import configs
        cfg = configs.get_smoke(arch)
    cfg = dataclasses.replace(cfg, **over)
    return cfg, next(s for s in cfg.pattern if s.mixer == mixer)


def tp_mixer_arrays(case: str) -> tuple:
    """The case's weights (``{path: f32 array}`` of one mixer, drawn with
    numpy in path order at the reference's init scales, rounded to bf16
    where the leaf is the model dtype's and that is bf16), its input x and
    its output cotangent (normal f32, rounded likewise)."""
    import torch

    from repro_torch.models import transformer

    cfg, spec = tp_mixer_config(case)
    bf16 = cfg.dtype == "bfloat16"
    rnd = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy() \
        if bf16 else a  # noqa: E731
    rng = np.random.default_rng(11)
    w = {}
    for path, (shape, init) in transformer.tree_paths(
            transformer._layer_shapes(cfg, spec, False)["mixer"]):
        if init in (None, "ones"):
            a = np.ones(shape, np.float32)
        elif init == "zeros":
            a = np.zeros(shape, np.float32)
        elif init == "uniform":
            a = (rng.random(shape) * 2 + 0.5).astype(np.float32)
        else:
            a = (rng.normal(0, 1, shape) * init).astype(np.float32)
        w[path] = a if init in transformer.F32_INITS else rnd(a)
    shape = TP_MIXER_CASES[case][3] + (cfg.d_model,)
    x = rnd(np.random.default_rng(12).normal(0, 1, shape).astype(np.float32))
    ct = rnd(np.random.default_rng(13).normal(0, 1, shape).astype(np.float32))
    return w, x, ct


def tp_mixer_run(case: str, mg=None) -> dict:
    """The case's mixer forward and backward on this rank's blocks of its
    weights (``transformer.block_specs``; all of them without ``mg``):
    ``y``, ``dx`` and ``d/<path>``, each as f32."""
    import torch

    from repro_torch.models import layers, transformer

    cfg, spec = tp_mixer_config(case)
    n = 1 if mg is None else mg.size
    specs = {p[len("blocks/0/mixer/"):]: s[1:] for p, s in
             transformer.block_specs(cfg, n).items() if p.startswith("blocks/0/mixer/")}
    dt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    w, x, ct = tp_mixer_arrays(case)
    leaves = {}
    for path, a in w.items():
        t = torch.from_numpy(a)
        t = t if path in ("a_log", "d_skip", "dt_bias") else t.to(dt)  # Mamba's f32 leaves
        leaves[path] = transformer._block(t, specs[path], mg).requires_grad_()
    xt = torch.from_numpy(x).to(dt).requires_grad_()
    y, _ = getattr(layers, spec.mixer)(nest_paths(leaves), xt, cfg, mg=mg)
    y.backward(torch.from_numpy(ct).to(dt))
    out = {"y": y.detach().float().numpy(), "dx": xt.grad.float().numpy()}
    for path, t in leaves.items():
        out[f"d/{path}"] = (torch.zeros_like(t) if t.grad is None else t.grad).float().numpy()
    return out


def tp_mixers_rank(rank: int, world: int, out: str) -> None:
    """Every ``TP_MIXER_CASES`` case on this rank of a world-sized model
    group (:func:`tp_mixer_run`), keys ``<case>/...``."""
    import torch.distributed as dist

    from repro_torch.models import tp

    mg = tp.ModelGroup(dist.group.WORLD)
    res = {}
    for case in TP_MIXER_CASES:
        res.update({f"{case}/{k}": v for k, v in tp_mixer_run(case, mg).items()})
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# ZeRO-1 with tensor and expert parallelism over 'model': the reference on 4
# forced host devices (one subprocess a mesh), the port on 4 gloo ranks
# ---------------------------------------------------------------------------

TP_RUNS = {  # kind -> (mesh shape, axes, SMOKE archs); "fsdp_" kinds train FSDP
    "tp": ((2, 2), ("data", "model"),
           ("tinyllama_1_1b", "gemma3_27b", "deepseek_v2_lite_16b", "whisper_small",
            "jamba_v0_1_52b", "xlstm_350m", "qwen2_vl_72b")),
    "tp_pods": ((2, 1, 2), ("pod", "data", "model"),
                ("tinyllama_1_1b", "deepseek_v2_lite_16b")),
    # tinyllama's K/V columns split inside a head; 8 experts over 4 ranks
    "tp_heads": ((1, 4), ("data", "model"),
                 ("tinyllama_1_1b", "deepseek_v2_lite_16b", "jamba_v0_1_52b")),
    "fsdp_tp": ((2, 2), ("data", "model"), ("tinyllama_1_1b", "jamba_v0_1_52b")),
    # the same mesh in a file of its own, for the test workers' balance
    "fsdp_tp_zoo": ((2, 2), ("data", "model"), ("qwen2_vl_72b", "deepseek_v3_671b")),
    # every leaf's columns split 4 ways; tinyllama's K/V inside a head; no
    # MoE arch: the reference's FSDP step with an MoE layer at data = 1
    # does not lower on XLA:CPU (jamba, deepseek-v3: "Cross-partition
    # allreduce must be in (partial) manual partitioning mode")
    "fsdp_tp_heads": ((1, 4), ("data", "model"), ("tinyllama_1_1b", "qwen2_vl_72b")),
    "fsdp_tp_pods": ((2, 1, 2), ("pod", "data", "model"), ("tinyllama_1_1b",)),
}
MESH_RUNS.update({k: (shape, axes, {}) for k, (shape, axes, _) in TP_RUNS.items()})
TP_CKPT_ARCH = "tinyllama_1_1b"
# the MoE arch runs in f32: in bf16 the router's near ties part between the
# packages and between layouts, and its step's loss with them (measured at
# (2, 2) on 8 x 160 tokens: loss relative 1.9e-4, 5.0% of the weights
# different; the reference's own one-device and (1, 4) losses on 8 x 32
# part by 2.2e-4); in f32 the port's step gives the reference's loss bits
#
# jamba and deepseek-v3 run in f32 too: both route through MoE layers whose
# bf16 near ties part the same way, and jamba's bf16 backward through the
# Mamba scan is ill-conditioned in both packages (ROADMAP Queue C: grad
# norms 7.74 and 6.78 about an f32 7.30 at one rank), which the 1e-2 grad
# norm bound would not hold between the packages
TP_F32 = ("deepseek_v2_lite_16b", "jamba_v0_1_52b", "deepseek_v3_671b")
# their depth cut in both packages, to the reference's compile: jamba to
# pattern positions 1-2, (Mamba, MoE) then (attention, SwiGLU), one layer
# of each kind, as the card's FSDP job; deepseek-v3 to its dense prefix
# layer and one MoE layer
TP_CUT = {"jamba_v0_1_52b": (1, 2), "deepseek_v3_671b": (0,)}
# deepseek-v3's production optimizer; factored from 8 wide, so SMOKE's
# leaves factor, split over 'model' on their last dim and on the one
# before (the row and column means over the model group)
TP_OPTIM = {"deepseek_v3_671b": {"name": "adafactor", "factored_min_dim": 8}}


def tp_batch_shape(arch: str) -> tuple:
    """(global batch, seq) of an arch's TP step: 8 x 32, or for
    deepseek-v2-lite 8 x 160, so that each MoE layer takes 640 tokens a DP
    rank or more, above ``dropless_below``: the capacity regime (the C-1
    quirk included), as ``test_torch_zoo_moe_train`` steps it."""
    return (8, 160) if arch == "deepseek_v2_lite_16b" else (8, 32)


def tp_configs(arch: str) -> tuple:
    """(the port's, the reference's) SMOKE config of a TP run: in f32 where
    ``TP_F32`` says, its depth cut where ``TP_CUT`` says."""
    import dataclasses

    from repro import configs as jconfigs
    from repro_torch import configs

    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    if arch in TP_F32:
        cfg, jcfg = (dataclasses.replace(c, dtype="float32") for c in (cfg, jcfg))
    if arch in TP_CUT:
        cfg, jcfg = (dataclasses.replace(c, pattern=tuple(c.pattern[i] for i in TP_CUT[arch]))
                     for c in (cfg, jcfg))
    return cfg, jcfg


def tp_fsdp(kind: str) -> bool:
    return kind.startswith("fsdp")


def _tp_sync(axes: tuple) -> tuple:
    return tuple(a for a in axes if a != "model")


def mesh_tp_reference(kind: str, out_dir: str) -> None:
    """The reference's side of ``TP_RUNS[kind]``, in a process with 4
    forced host devices: the reduce-scatter of each device's
    ``mesh_rs_input`` over (pod, data) inside its model index under each
    of MESH_RS_POLICIES (an FSDP kind: the gather of each device's seeded
    model-local shard over (pod, data) and the backward of a seeded
    cotangent); then per arch its ZeRO-1 or FSDP state from
    ``PRNGKey(0)`` (each device's parameter shards, the global parameters
    by path, ZeRO-1's ``zero1_meta``), checkpointed before (step 0) and
    after (step 1) one compressed step on ``registry.make_batch`` of
    ``tp_batch_shape(arch)`` (seed 0), its loss, grad norm and flag.  Files under
    ``out_dir/<arch>/ckpt``; arrays in ``out_dir/ref.npz``."""
    import os

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import sched as jsched
    from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
    from repro.core.policy import CompressionPolicy as JPolicy
    from repro.launch.mesh import make_mesh
    from repro.models import registry as jregistry
    from repro.optim import fsdp as jfsdp
    from repro.optim import optimizers as jopt
    from repro.optim import zero1 as jzero1
    from repro.sched import compile as jcompile
    from repro.train import step as jstep
    from repro_torch.models import transformer

    shape, axes, archs = TP_RUNS[kind]
    fsdp = tp_fsdp(kind)
    mesh = make_mesh(shape, axes)
    sync = _tp_sync(axes)
    n_dp = int(np.prod(shape[:-1]))
    devs = list(mesh.devices.flat)
    res = {}
    smap = lambda f, i, o: jax.jit(jax.shard_map(  # noqa: E731
        f, mesh=mesh, in_specs=i, out_specs=o, axis_names=set(axes), check_vma=False))
    meta = jzero1.plan_buckets({"g": jax.ShapeDtypeStruct((MESH_RS_N,), jnp.bfloat16)}, n_dp)
    xs = np.concatenate([np.pad(mesh_rs_input(d), (0, meta.padded[0] - MESH_RS_N))
                         for d in range(4)])
    for tag, kw in MESH_RS_POLICIES.items():
        if fsdp:
            pol = JPolicy(min_bytes=0, **kw)
            lshape, dt = MESH_GATHER
            gather = jfsdp._make_gather(sync, 6, 5, 512, 0.02, pol.enabled, lshape, dt,
                                        pol.fused_decode_reduce, True)

            def gbody(local, cot, gather=gather):
                (full, _), vjp = jax.vjp(gather, local)
                (grad,) = vjp((cot, np.zeros((), jax.dtypes.float0)))
                return full, grad

            locs = np.concatenate([fsdp_bits(lshape, dt, 400 + d) for d in range(4)])
            cots = np.concatenate([fsdp_bits(fsdp_full_shape(lshape, n_dp), dt, 500 + d)
                                   for d in range(4)])
            full, grad = smap(gbody, (P(axes), P(axes)), (P(axes), P(axes)))(
                to_jax(locs, dt), to_jax(cots, dt))
            res[f"rs_{tag}"], res[f"ag_{tag}"] = (np_of(grad).reshape(4, -1),
                                                  np_of(full).reshape(4, -1))
            continue
        plan = jcompile.cached_zero1_plan(meta, policy=JPolicy(min_bytes=0, **kw),
                                          axis_name=sync, n_dev=n_dp)

        def body(x, plan=plan):
            with jsched.Zero1Execution(plan, sync) as ex:
                gs, f = ex.reduce_scatter(0, x)
            return gs, f[None]

        gs, flag = smap(body, (P(axes),), (P(axes), P(axes)))(to_jax(xs, "bfloat16"))
        res[f"rs_{tag}"], res[f"rs_{tag}_flag"] = np_of(gs).reshape(4, -1), np.asarray(flag)

    dpax = sync if len(sync) > 1 else sync[0]
    for arch in archs:
        cfg = tp_configs(arch)[1]
        # remat changes no value; without it the reference's FSDP step
        # compiles in half the time, but at data = 1 it does not lower
        tcfg = jstep.TrainConfig(loss_chunk=16, policy=JPolicy(min_bytes=0),
                                 optim=jopt.OptimConfig(lr=MESH_LR, warmup_steps=MESH_WARMUP,
                                                        **TP_OPTIM.get(arch, {})),
                                 **({"partition": "fsdp", "fsdp_min_bytes": 0,
                                     "remat": n_dp == 1} if fsdp else {}))
        state, _ = jstep.build_train_state(cfg, tcfg, mesh, jax.random.PRNGKey(0))
        parts = [[] for _ in devs]
        for leaf in jax.tree_util.tree_leaves(state["params"]):
            for sh in leaf.addressable_shards:
                parts[devs.index(sh.device)].append(np_of(sh.data).view(np.uint8).reshape(-1))
        res[f"{arch}_init"] = np.stack([np.concatenate(p) for p in parts])
        for path, a in transformer.tree_paths(jax.tree_util.tree_map(np.asarray,
                                                                    state["params"])):
            res[f"{arch}_param/{path}"] = np_of(a)
        if not fsdp:
            meta = jstep.zero1_meta(cfg, n_dp, tcfg, mesh)
            res[f"{arch}_meta"] = np.array([*meta.lengths, *meta.padded, meta.n_dp, meta.block])
            res[f"{arch}_members"] = np.array([(b, i, size) for b, mem in enumerate(meta.members)
                                               for i, _, size in mem])
        ckpt = JCheckpointManager(os.path.join(out_dir, arch, "ckpt"))
        ckpt.save(0, state)
        batch = {k: jax.device_put(v, NamedSharding(mesh, P(dpax, *(None,) * (v.ndim - 1))))
                 for k, v in jregistry.make_batch(cfg, *tp_batch_shape(arch),
                                                  rng=np.random.default_rng(0)).items()}
        state, m = jax.jit(jstep.build_train_step(cfg, tcfg, mesh)[0])(state, batch)
        for k in ("loss", "gnorm", "overflow"):
            res[f"{arch}_{k}"] = np.asarray(m[k])
        ckpt.save(1, state)
    np.savez(os.path.join(out_dir, "ref.npz"), **res)


def run_mesh_tp_reference(kind: str, out_dir) -> dict:
    """:func:`mesh_tp_reference` in a subprocess (:func:`run_reference`)."""
    return run_reference("torch_port_util", "mesh_tp_reference", kind, out_dir)


def _tp_tcfg(policy=None, kind: str = "tp", arch: str = ""):
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.optim.optimizers import OptimConfig
    from repro_torch.train import step as step_lib

    return step_lib.TrainConfig(
        loss_chunk=16, policy=CompressionPolicy(min_bytes=0) if policy is None else policy,
        optim=OptimConfig(lr=MESH_LR, warmup_steps=MESH_WARMUP, **TP_OPTIM.get(arch, {})),
        **({"partition": "fsdp", "fsdp_min_bytes": 0} if tp_fsdp(kind) else {}))


def _leaf_bytes(tensors) -> np.ndarray:
    return np.concatenate([np_of(t).view(np.uint8).reshape(-1) for t in tensors])


def tp_restore(cfg, mesh, tcfg, ckpt_dir: str, step: int):
    """This rank's train state of checkpoint ``step`` under ``ckpt_dir``,
    restored onto ``mesh`` with ``restore(shardings=)`` into a state built
    on the mesh."""
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train import step as step_lib
    from repro_torch.tree_util import tree_map_up_to

    like = step_lib.build_train_state(cfg, tcfg, generator=torch.Generator().manual_seed(9),
                                      mesh=mesh, device="cpu")
    shardings = tree_map_up_to(lambda _, s: (mesh, s), like.global_like(),
                               step_lib.make_train_state_specs(cfg, tcfg, mesh))
    state, got = CheckpointManager(ckpt_dir).restore(like, step=step, shardings=shardings,
                                                     device="cpu")
    assert got == step
    return state


def _tp_twin(arch: str, cfg, mesh, compress: bool, rows_of, tcfg=None):
    """2 steps from the port's own init (seed 0) at ``compress``: through
    the launcher on the mesh, or (an encoder-decoder model, which the
    launcher refuses, or an FSDP ``tcfg``, whose ``fsdp_min_bytes = 0``
    the launcher does not set) through ``train_step`` or
    ``fsdp_train_step`` on ``registry.make_batch`` batches of seeds 0 and
    1.  Returns (losses, state, retries)."""
    import dataclasses

    import torch

    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry
    from repro_torch.train import step as step_lib

    from repro_torch.sched.cache import PlanCache

    fsdp = tcfg is not None and tcfg.partition == "fsdp"
    if not cfg.enc_dec and not fsdp:
        batch, seq = tp_batch_shape(arch)
        run = launch_train.train(cfg, steps=2, batch=batch, seq=seq, compress=compress,
                                 device="cpu", lr=MESH_LR, warmup=MESH_WARMUP, mesh=mesh)
        return run.losses, run.state, run.retries
    pol = CompressionPolicy(min_bytes=0) if compress else CompressionPolicy.disabled()
    tc = dataclasses.replace(_tp_tcfg() if tcfg is None else tcfg, policy=pol)
    st = step_lib.build_train_state(cfg, tc, generator=torch.Generator().manual_seed(0),
                                    mesh=mesh, device="cpu")
    step_fn, kw = ((step_lib.fsdp_train_step, {"cache": PlanCache()}) if fsdp
                   else (step_lib.train_step, {}))
    with launch_train.deterministic():
        losses = [float(step_fn(st, rows_of(registry.make_batch(
            cfg, *tp_batch_shape(arch), rng=np.random.default_rng(i), device="cpu")),
            tc, **kw)["loss"]) for i in range(2)]
    return losses, st, 0


def _global_numpy(tree):
    """A global train-state tree of torch tensors as the reference's numpy
    tree (bf16 leaves as ml_dtypes bf16, f32 as f32, ints as they are)."""
    from repro_torch.tree_util import tree_map

    return tree_map(lambda t: ref_array(t) if t.is_floating_point() else t.numpy(), tree)


def _fsdp_keys_model_local(state, cfg, tcfg, groups, n_dp: int, cache) -> bool:
    """Whether ``cache`` holds exactly one ``fsdp_gather`` plan for each
    signature of the state's sharded leaves, keyed by this rank's shard of
    its model block with the sharded dim last (the reference's
    ``cached_fsdp_gather_plan(tuple(lshape), ...)``), and each leaf that
    'model' splits is held at its global dim over ``n_model``."""
    from repro_torch.models import transformer
    from repro_torch.sched import compile as sched_compile
    from repro_torch.sched.plan import dtype_name
    from repro_torch.train import step as step_lib

    mg = state.model.mg
    dims = step_lib.model_dims(cfg, mg.size)
    whole = dict(transformer.tree_paths(transformer.abstract_params(cfg)))
    keys, ok = set(), True
    for path, d in transformer.tree_paths(state.fsdp_dims):
        if d < 0:
            continue
        leaf = state.model.params[path]
        shard = leaf[0].movedim(d - 1, -1) if path.startswith("blocks/") else leaf.movedim(d, -1)
        key = sched_compile.fsdp_gather_plan_key(tuple(shard.shape), dtype_name(leaf.dtype),
                                                 groups.axes, tcfg.policy, n_dp, "cpu")
        keys.add(key)
        ok &= key in cache
        if dims[path] >= 0:
            ok &= leaf.shape[dims[path]] * mg.size == whole[path].shape[dims[path]]
    return ok and len(cache) == len(keys) > 0


def mesh_tp_rank(rank: int, world: int, out: str, kind: str, ref_dir: str) -> None:
    """The port's side of ``TP_RUNS[kind]`` on this gloo rank: its DP index
    and model rank; the reduce-scatter of its ``mesh_rs_input`` over its
    (pod, data) group under each of MESH_RS_POLICIES (an FSDP kind: the
    gather of its seeded model-local shard over that group, and the
    backward of its cotangent); per arch the reference's parameters
    through ``load_reference_params(mesh=)`` (FSDP: its step-0 state
    through ``load_reference_fsdp_state(mesh=)``) and its step-0
    checkpoint through ``restore(shardings=)`` (this rank's blocks, FSDP
    their DP shards), ZeRO-1's bucket layout, one step from that state
    beside the reference's step-1 state restored the same way, 2 steps
    compressed and raw from the port's own init (the bytes of the leaves
    no axis splits after them), and this rank's blocks of
    ``transformer.init(mesh=)``.  On ``tp``: the restored step-1 state of
    TP_CKPT_ARCH saved by the port (gathered, rank 0 writes) under
    ``ref_dir/port_ckpt`` and restored without shardings; then its
    launcher run with an overflow forced on one rank (model rank 1 of the
    last DP index) in the first compressed step.  On an FSDP kind every
    arch's restored step-1 state is saved so, under
    ``ref_dir/port_ckpt/<arch>``."""
    import os

    import ml_dtypes
    import torch
    import torch.distributed as dist

    from repro_torch import sched
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry, transformer
    from repro_torch.optim import fsdp as fsdp_lib
    from repro_torch.optim import zero1
    from repro_torch.sched import compile as sched_compile
    from repro_torch.sched.cache import PlanCache
    from repro_torch.train import step as step_lib
    from repro_torch.tree_util import bits_equal, tree_leaves

    shape, axes, archs = TP_RUNS[kind]
    fsdp = tp_fsdp(kind)
    mesh = mesh_lib.make_mesh(shape, axes, device="cpu")
    groups = step_lib.sync_group(mesh, _tp_tcfg(kind=kind))
    idx, n_dp = dist.get_rank(groups.group), dist.get_world_size(groups.group)
    mg = groups.model
    res = {"idx": idx, "mrank": mg.rank, "sync": np.array(groups.axes)}
    x = to_torch(mesh_rs_input(rank), "bfloat16")
    for tag, kw in MESH_RS_POLICIES.items():
        pol = CompressionPolicy(min_bytes=0, **kw)
        if fsdp:
            lshape, dt = MESH_GATHER
            wire = fsdp_lib.GatherWire(groups.axes, 6, 5, 512, 0.02, pol.enabled, lshape, dt,
                                       pol.fused_decode_reduce, True)
            local = to_torch(fsdp_bits(lshape, dt, 400 + rank), dt).requires_grad_()
            full, _ = wire(local, groups.group)
            (grad,) = torch.autograd.grad(full, local, to_torch(
                fsdp_bits(fsdp_full_shape(lshape, n_dp), dt, 500 + rank), dt))
            res[f"rs_{tag}"], res[f"ag_{tag}"] = np_of(grad).reshape(-1), np_of(full).reshape(-1)
            continue
        meta = zero1.plan_buckets([x], n_dp)
        plan = sched_compile.cached_zero1_plan(
            meta, policy=pol, axis_name=groups.axes, n_dev=n_dp, device="cpu", cache=PlanCache())
        (gb,) = zero1.flatten_buckets(meta, [x])
        with sched.Zero1Execution(plan, groups.group) as ex:
            gs, flag = ex.reduce_scatter(0, gb)
        res[f"rs_{tag}"], res[f"rs_{tag}_flag"] = np_of(gs), int(flag)

    ref = np.load(os.path.join(ref_dir, "ref.npz"))
    rows_of = lambda b: launch_train.dp_rows(b, idx, n_dp)  # noqa: E731
    for arch in archs:
        cfg = tp_configs(arch)[0]
        tcfg = _tp_tcfg(kind=kind, arch=arch)
        ckpt_dir = os.path.join(ref_dir, arch, "ckpt")
        state = tp_restore(cfg, mesh, tcfg, ckpt_dir, 0)
        if fsdp:
            glob, _ = CheckpointManager(ckpt_dir).restore(state.global_like(), step=0,
                                                          device="cpu")
            loaded = step_lib.load_reference_fsdp_state(
                _global_numpy(glob), cfg, tcfg, n_dp=n_dp, dp_index=idx, device="cpu",
                mesh=mesh)
            res[f"{arch}_load_opt_exact"] = int(bits_equal(loaded.opt, state.opt))
        else:
            dts = transformer.leaf_dtypes(cfg)
            tree = {p: ref[f"{arch}_param/{p}"].view(
                ml_dtypes.bfloat16 if dts[p] == torch.bfloat16 else np.float32) for p in dts}
            loaded = transformer.load_reference_params(tree, cfg, device="cpu", mesh=mesh)
            m = state.meta
            res[f"{arch}_meta"] = np.array([*m.lengths, *m.padded, m.n_dp, m.block])
            res[f"{arch}_members"] = np.array([(b, i, size) for b, mem in enumerate(m.members)
                                               for i, _, size in mem])
        res[f"{arch}_load"] = _leaf_bytes(loaded.model.leaves() if fsdp else loaded.leaves())
        res[f"{arch}_restored"] = _leaf_bytes(state.model.leaves())
        batch = registry.make_batch(cfg, *tp_batch_shape(arch), rng=np.random.default_rng(0),
                                    device="cpu")
        cache = PlanCache()
        with launch_train.deterministic():
            m = (step_lib.fsdp_train_step(state, rows_of(batch), tcfg, cache=cache)
                 if fsdp else step_lib.train_step(state, rows_of(batch), tcfg))
        if fsdp:  # one fsdp_gather plan a signature, keyed by the model-local shard
            res[f"{arch}_plan_keys"] = int(_fsdp_keys_model_local(state, cfg, tcfg, groups,
                                                                   n_dp, cache))
        res.update({f"{arch}_loss": float(m["loss"]), f"{arch}_gnorm": float(m["gnorm"]),
                    f"{arch}_overflow": int(m["overflow"]), f"{arch}_step": state.step,
                    f"{arch}_params": _flat_f32(state.model.leaves())})
        want = tp_restore(cfg, mesh, tcfg, ckpt_dir, 1)
        res[f"{arch}_ref_params"] = _flat_f32(want.model.leaves())
        for tag, compress in (("comp", True), ("raw", False)):
            losses, st, _ = _tp_twin(arch, cfg, mesh, compress, rows_of, tcfg if fsdp else None)
            res[f"{arch}_{tag}_losses"] = np.array(losses)
            res[f"{arch}_{tag}_params"] = _leaf_bytes(st.model.leaves())
        kept = transformer.block_specs(cfg, mg.size)
        whole = [d < 0 for d in tree_leaves(st.fsdp_dims)] if fsdp else [True] * len(kept)
        res[f"{arch}_rep"] = _leaf_bytes([p for (path, p), w in zip(st.model.params.items(),
                                                                   whole, strict=True)
                                          if w and "model" not in kept[path]])
        res[f"{arch}_own_init"] = _leaf_bytes(transformer.init(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu", mesh=mesh).leaves())
        if fsdp or (kind == "tp" and arch == TP_CKPT_ARCH):
            port_dir = os.path.join(ref_dir, "port_ckpt", arch if fsdp else "")
            CheckpointManager(port_dir).save(1, want)  # gathered to rank 0, which writes
            dist.barrier()
            back, _ = CheckpointManager(port_dir).restore(want, device="cpu")
            pre = f"{arch}_" if fsdp else ""
            res[f"{pre}resume_exact"] = int(bits_equal(back.tree(), want.tree()))
            res[f"{pre}own_storage"] = np.array([
                t.untyped_storage().nbytes() == t.numel() * t.element_size()
                for s in (want, back) for t in tree_leaves(s.tree())])
        if kind == "tp" and arch == TP_CKPT_ARCH:
            orig, seen = zero1.zero1_step, []

            def forced(*args, **kw):  # one rank's first compressed step overflows
                out = orig(*args, **kw)
                if kw["policy"].enabled:
                    seen.append(1)
                    if len(seen) == 1 and (idx, mg.rank) == (n_dp - 1, 1):
                        out = (out[0], out[1], torch.ones_like(out[2]), out[3])
                return out

            zero1.zero1_step = forced
            try:
                losses, st, retries = _tp_twin(arch, cfg, mesh, True, rows_of)
            finally:
                zero1.zero1_step = orig
            res.update(forced_losses=np.array(losses), forced_retries=retries,
                       forced_params=_leaf_bytes(st.model.leaves()))
    np.savez(out, **res)


def tp_mixer_serve_run(case: str, mg=None) -> dict:
    """The case's mixer in its serving forms on this rank's blocks (all of
    them without ``mg``): a prefill over all positions but the last, which
    returns the state, then a decode step of the last position from it;
    ``y`` (both outputs joined) and ``state/<name>`` (the decode's new
    state), each as f32."""
    import torch

    from repro_torch.models import layers, transformer

    cfg, spec = tp_mixer_config(case)
    n = 1 if mg is None else mg.size
    specs = {p[len("blocks/0/mixer/"):]: s[1:] for p, s in
             transformer.block_specs(cfg, n).items() if p.startswith("blocks/0/mixer/")}
    dt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    w, x, _ = tp_mixer_arrays(case)
    p = nest_paths({path: transformer._block(
        torch.from_numpy(a) if path in ("a_log", "d_skip", "dt_bias") else
        torch.from_numpy(a).to(dt), specs[path], mg) for path, a in w.items()})
    xt = torch.from_numpy(x).to(dt)
    fn = getattr(layers, spec.mixer)
    kw = {"return_state": True} if spec.mixer == "mamba" else {"serve": True}
    with torch.no_grad():
        y0, st = fn(p, xt[:, :-1], cfg, mg=mg, **kw)
        y1, st = fn(p, xt[:, -1:], cfg, state=st, mg=mg, **kw)
    out = {"y": torch.cat([y0, y1], 1).float().numpy()}
    out.update({f"state/{k}": t.float().numpy() for k, t in st.items()})
    return out


def tp_mixer_serve_rank(rank: int, world: int, out: str) -> None:
    """:func:`tp_mixer_serve_run` of every ``TP_MIXER_CASES`` case on this
    rank of a world-sized model group, keys ``<case>/...``."""
    import torch.distributed as dist

    from repro_torch.models import tp

    mg = tp.ModelGroup(dist.group.WORLD)
    np.savez(out, **{f"{case}/{k}": v for case in TP_MIXER_CASES
                     for k, v in tp_mixer_serve_run(case, mg).items()})
