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
    rank saves its results as ``.npz`` at ``out_path``; returns them in rank
    order."""
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
    import torch.distributed as dist

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
