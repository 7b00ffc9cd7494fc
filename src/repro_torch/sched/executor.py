"""Plan executor: drive the compressed collectives from a CommPlan (torch
port of ``repro.sched.executor``, the collective kinds).

The executor is thin: every wire still goes through the
``core/compressed_collectives`` primitives, with the arguments the planless
entry point would pass, so plan-driven and planless execution give the same
bits (same ops, same rank accumulation order).  What changes is where the
decisions are made: the planless paths re-derive buckets, gates and widths
at every call, the executor replays a schedule compiled once and cached on
its signature (``sched/cache.py``).

Wire accounting: a plan execution records ONE consolidated ``WireReport``
(name ``plan:<kind>``) in place of the per-wire reports of its buckets,
which it captures (``policy.capture_wire_reports``) and folds, keeping the
raw and wire totals and the fused/unfused HBM split.  The same record feeds
the ``obs`` registry (``plan_exec_total``, the plan wire totals and ratio)
and the drift detector, and each bucket's reports feed the per-bucket
ledger (``bucket_wire_*_total`` by kind, dtype and width), so the ledger's
per-kind sums equal the consolidated reports'.  The port replays a plan
eagerly: its ``plan:<kind>`` span and ``plan_exec_total`` fire once per
execution (the reference's once per trace under ``jit``), and the span is
the host's time to replay the plan, whose kernels run asynchronously.

Entry points:
  * :func:`psum_with_plan`: pytree all-reduce (the plan twin of
    ``tree_psum_compressed``), over :func:`execute_psum`;
  * :func:`reduce_scatter_with_plan`: flat local bucket -> reduced shard;
  * :func:`all_gather_with_plan`: flat local shard -> gathered buckets;
  * :class:`Zero1Execution`: ZeRO-1's two phases around its update
    (``optim/zero1.zero1_step``);
  * :func:`p2p_send_with_plan`: one P2P send (the plan twin of
    ``core/split_send.p2p_send``, kind "p2p"), over :func:`execute_p2p`;
  * :func:`transfer_cache_with_plan`: a KV-cache pytree over the in-mesh
    P2P wire (the plan twin of ``serve/kv_transfer.transfer_cache``, kind
    "kv"), over :func:`execute_kv_transfer`;
  * :func:`sync_weights_with_plan`: a weight pytree, full or as XOR deltas
    against a base version (the plan twin of ``sync/wire.sync_weights``,
    kind "wsync"), over :func:`execute_wsync`;
  * :func:`execute_wsync_broadcast`: a wsync plan's ``BroadcastSchedule``
    as its sequence of hop levels (:func:`wsync_hop_perms`), each one
    :func:`execute_wsync` (the plan twin of ``sync/wire.broadcast_weights``).

Every function takes the ``torch.distributed`` group that carries the wire
(``None``: the world), and the P2P kinds the ``perm`` of ``(source,
target)`` group ranks; the plan's ``axis`` holds the labels it was gated
on.  The host serve and weight-sync engines also read the ``kv`` and
``wsync`` plans for their host wires.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import codec
from repro_torch.core.compressed_collectives import (
    _no_flag, all_gather_compressed, check_perm, psum_compressed_ring, psum_raw_twoshot,
    psum_safe, reduce_scatter_compressed)
from repro_torch.core.policy import (WireReport, capture_wire_reports,
                                     record_wire_report)
from repro_torch.core.split_send import p2p_dispatch, send_raw_leaves, wsync_dispatch
from repro_torch.obs import drift as drift_lib
from repro_torch.sched import compile as sched_compile
from repro_torch.sched.cache import PlanCache, default_cache
from repro_torch.sched.plan import (PATH_COMPRESSED, PATH_RAW_PSUM, PATH_RAW_TWOSHOT,
                                    PATH_RING, PATH_TWO_SHOT, BucketPlan, CommPlan,
                                    dtype_name)
from repro_torch.tree_util import tree_flatten, tree_unflatten


def consolidate_reports(plan: CommPlan, caught) -> WireReport | None:
    """Fold the per-wire reports of one plan execution into one record.
    ``fused`` is uniform across a plan's reduce-side wires (one policy
    knob), so one flag classifies the whole decoded-HBM sum."""
    if not caught:
        return None
    return WireReport(
        name=f"plan:{plan.kind}",
        axis=str(_label(plan)),
        raw_bytes=sum(r.raw_bytes for r in caught),
        wire_bytes=sum(r.wire_bytes for r in caught),
        fused=any(r.fused and r.decode_hbm_bytes for r in caught),
        decode_hbm_bytes=sum(r.decode_hbm_bytes for r in caught),
        encode_fused=any(r.encode_fused and r.encode_hbm_bytes for r in caught),
        encode_hbm_bytes=sum(r.encode_hbm_bytes for r in caught),
    )


def _plan_span(plan: CommPlan):
    """Span of one plan execution (``plan:<kind>``): the host's wall clock
    of the eager replay."""
    return obs.span(f"plan:{plan.kind}", plan_key=f"{hash(plan.key) & 0xFFFFFFFF:08x}",
                    buckets=len(plan.buckets))


def _emit(plan: CommPlan, caught) -> None:
    """Record the consolidated WireReport of one plan execution and mirror
    it into the metrics registry, both from the SAME record, so the
    snapshot's per-kind wire totals equal ``summarize_wire_reports`` over
    the ``plan:*`` reports of the same run."""
    rep = consolidate_reports(plan, caught)
    if rep is not None:
        record_wire_report(rep)
    obs.metric("plan_exec_total").inc(kind=plan.kind)
    if rep is not None:
        obs.metric("plan_wire_raw_bytes_total").inc(rep.raw_bytes, kind=plan.kind)
        obs.metric("plan_wire_bytes_total").inc(rep.wire_bytes, kind=plan.kind)
        obs.metric("plan_wire_ratio").set(rep.ratio, kind=plan.kind)
        obs.metric("plan_wire_ratio_hist").observe(rep.ratio, kind=plan.kind)
        # executor wires are sized from shapes when the plan compiles, so
        # live == predicted unless a plan is replayed against another mix
        drift_lib.observe_plan(plan, rep)


@contextlib.contextmanager
def _bucket_ledger(plan: CommPlan, dtype_name: str, width: int):
    """Per-bucket wire ledger: capture ONE bucket's wire reports, forward
    them as they are to the enclosing plan capture (so consolidation sees
    what it would without the ledger), and ledger the bucket's raw and wire
    byte sums under (kind, dtype, width), the data of ``obs/regret.py``.
    No-op when obs is disabled."""
    if not obs.enabled():
        yield
        return
    with capture_wire_reports() as inner:
        yield
    for r in inner:
        record_wire_report(r)
    if inner:
        obs.metric("bucket_wire_raw_bytes_total").inc(
            sum(r.raw_bytes for r in inner), kind=plan.kind, dtype=dtype_name,
            width=width)
        obs.metric("bucket_wire_bytes_total").inc(
            sum(r.wire_bytes for r in inner), kind=plan.kind, dtype=dtype_name,
            width=width)


def _label(plan: CommPlan):
    """The gate label a plan was compiled under: one axis name, or a tuple."""
    return plan.axis[0] if len(plan.axis) == 1 else plan.axis


# ---------------------------------------------------------------------------
# bucket drivers (shared by every entry point)
# ---------------------------------------------------------------------------

def _exec_reduce_scatter(b: BucketPlan, x: torch.Tensor, group, label):
    """One RS bucket: compressed at the plan's widths, or the raw RS.
    Returns (f32 shard, flag) either way."""
    if b.path == PATH_COMPRESSED:
        return reduce_scatter_compressed(
            x, group, width=b.width, block=b.block, exc_frac=b.exc_frac,
            use_fused=b.fused, fused_encode=b.encode_fused, axis_name=label)
    from repro_torch.optim.zero1 import _raw_reduce_scatter

    return _raw_reduce_scatter(x, group, b.n_dev), _no_flag(x)


def _exec_all_gather(b: BucketPlan, y: torch.Tensor, group, label):
    """One AG bucket.  Returns (stacked (n_dev, chunk) when compressed, the
    flat gather when raw; flag)."""
    if b.path == PATH_COMPRESSED:
        return all_gather_compressed(
            y, group, width=b.width, block=b.block, exc_frac=b.exc_frac,
            fused_encode=b.encode_fused, axis_name=label)
    from repro_torch.optim.zero1 import _raw_all_gather

    return _raw_all_gather(y, group), _no_flag(y)


def _exec_psum_bucket(b: BucketPlan, bucket: torch.Tensor, group, label):
    """One psum bucket: the dispatch of ``psum_compressed``."""
    dt = bucket.dtype
    if b.path == PATH_RAW_PSUM:
        return psum_safe(bucket, group), _no_flag(bucket)
    if b.path == PATH_RAW_TWOSHOT:
        return psum_raw_twoshot(bucket, group), _no_flag(bucket)
    if b.path == PATH_RING:
        return psum_compressed_ring(
            bucket, group, width=b.width, block=b.block, exc_frac=b.exc_frac,
            out_dtype=dt, use_fused=b.fused, fused_encode=b.encode_fused,
            axis_name=label)
    if b.path != PATH_TWO_SHOT:
        raise ValueError(f"psum bucket with path {b.path!r}")
    red, f1 = reduce_scatter_compressed(
        bucket, group, width=b.width, block=b.block, exc_frac=b.exc_frac,
        use_fused=b.fused, fused_encode=b.encode_fused, axis_name=label)
    gath, f2 = all_gather_compressed(
        red.to(dt), group, width=b.ag_width, block=b.block, exc_frac=b.exc_frac,
        fused_encode=b.encode_fused, axis_name=label)
    return gath.reshape(-1)[: b.length].to(dt), torch.maximum(f1, f2)


# ---------------------------------------------------------------------------
# pytree all-reduce
# ---------------------------------------------------------------------------

def execute_psum(plan: CommPlan, tree, group=None):
    """Run a compiled psum plan over a pytree of tensors.  Bit-identical to
    ``tree_psum_compressed`` under the policy the plan was compiled from.
    Returns (tree, flag)."""
    leaves, treedef = tree_flatten(tree)
    if len(leaves) != plan.n_leaves:
        raise ValueError(f"tree of {len(leaves)} leaves, plan of {plan.n_leaves}")
    label = _label(plan)
    out = list(leaves)
    flag = _no_flag(leaves[0])
    with _plan_span(plan), capture_wire_reports() as caught:
        for b in plan.buckets:
            parts = [leaves[i].reshape(-1) for i, _, _ in b.members]
            bucket = torch.cat(parts) if len(parts) > 1 else parts[0]
            with _bucket_ledger(plan, b.dtype_name, b.width):
                red, f = _exec_psum_bucket(b, bucket, group, label)
            flag = torch.maximum(flag, f)
            off = 0
            for i, shape, size in b.members:
                out[i] = red[off: off + size].reshape(shape)
                off += size
        with _bucket_ledger(plan, "raw", 0):
            for i in plan.raw_leaf_ix:
                out[i] = psum_safe(leaves[i], group)
    _emit(plan, caught)
    return tree_unflatten(treedef, out), flag


def psum_with_plan(tree, group=None, *, axis_name="data", policy=None,
                   tensor_class: str = "gradient", plan: CommPlan = None,
                   cache: PlanCache = None):
    """Plan-driven pytree all-reduce over ``group``.  With ``plan=None``
    the plan is looked up by (tree signature, axis label, group size,
    policy, device) in ``cache`` (default: the process cache) and compiled
    on first sight.  Returns (tree, overflow_flag)."""
    if plan is None:
        if policy is None:
            raise ValueError("psum_with_plan needs policy= or plan=")
        n_dev = dist.get_world_size(group)
        cache = default_cache() if cache is None else cache
        key = sched_compile.psum_plan_key(tree, axis_name, policy, tensor_class, n_dev)
        plan = cache.get_or_compile(key, lambda: sched_compile.compile_psum_plan(
            tree, axis_name, policy=policy, tensor_class=tensor_class, n_dev=n_dev,
            key=key))
    return execute_psum(plan, tree, group)


# ---------------------------------------------------------------------------
# flat phases
# ---------------------------------------------------------------------------

def _flat_plan(kind: str, x: torch.Tensor, group, axis_name, policy,
               tensor_class: str, cache) -> CommPlan:
    if policy is None:
        raise ValueError(f"{kind}_with_plan needs policy= or plan=")
    key_fn = getattr(sched_compile, f"{kind}_plan_key")
    compile_fn = getattr(sched_compile, f"compile_{kind}_plan")
    n_dev, name = dist.get_world_size(group), dtype_name(x.dtype)
    cache = default_cache() if cache is None else cache
    key = key_fn(x.numel(), name, axis_name, policy, tensor_class, n_dev, x.device)
    return cache.get_or_compile(key, lambda: compile_fn(
        x.numel(), name, axis_name, policy=policy, n_dev=n_dev,
        tensor_class=tensor_class, key=key, device=x.device))


def reduce_scatter_with_plan(x: torch.Tensor, group=None, *, axis_name="data",
                             policy=None, tensor_class: str = "gradient",
                             plan: CommPlan = None, cache: PlanCache = None):
    """Plan-driven flat reduce-scatter (ZeRO-1's gate).  Returns (f32 local
    shard, flag): ``reduce_scatter_compressed``'s, or the raw RS's."""
    if plan is None:
        plan = _flat_plan("reduce_scatter", x, group, axis_name, policy, tensor_class,
                          cache)
    b = plan.buckets[0]
    with _plan_span(plan), capture_wire_reports() as caught:
        with _bucket_ledger(plan, b.dtype_name, b.width):
            out = _exec_reduce_scatter(b, x, group, _label(plan))
    _emit(plan, caught)
    return out


def all_gather_with_plan(y: torch.Tensor, group=None, *, axis_name="data",
                         policy=None, tensor_class: str = "weight",
                         plan: CommPlan = None, cache: PlanCache = None):
    """Plan-driven flat all-gather.  Returns (gathered, flag)."""
    if plan is None:
        plan = _flat_plan("all_gather", y, group, axis_name, policy, tensor_class,
                          cache)
    b = plan.buckets[0]
    with _plan_span(plan), capture_wire_reports() as caught:
        with _bucket_ledger(plan, b.dtype_name, b.width):
            out = _exec_all_gather(b, y, group, _label(plan))
    _emit(plan, caught)
    return out


# ---------------------------------------------------------------------------
# ZeRO-1 phase driver
# ---------------------------------------------------------------------------

class Zero1Execution:
    """One plan-driven ZeRO-1 sync: the optimizer update runs BETWEEN the RS
    and AG phases, so the two phases are exposed separately, and the wire
    accounting is consolidated when the context closes without an error."""

    def __init__(self, plan: CommPlan, group=None):
        self.plan = plan
        self.group = group
        self._cap = capture_wire_reports()
        self._caught = None
        self._span = None

    def __enter__(self):
        self._span = _plan_span(self.plan)
        self._span.__enter__()
        self._caught = self._cap.__enter__()
        return self

    def __exit__(self, *exc):
        self._cap.__exit__(*exc)
        self._span.__exit__(*exc)
        if exc[0] is None:
            _emit(self.plan, self._caught)
        return False

    def reduce_scatter(self, i: int, gbucket: torch.Tensor):
        """Bucket ``i``'s RS phase: (f32 shard, flag)."""
        b = self.plan.buckets[i].rs
        with _bucket_ledger(self.plan, b.dtype_name, b.width):
            return _exec_reduce_scatter(b, gbucket, self.group, _label(self.plan))

    def all_gather(self, i: int, shard: torch.Tensor):
        """Bucket ``i``'s AG phase: (gathered, flag)."""
        b = self.plan.buckets[i].ag
        with _bucket_ledger(self.plan, b.dtype_name, b.width):
            return _exec_all_gather(b, shard, self.group, _label(self.plan))


# ---------------------------------------------------------------------------
# P2P wires: kinds "p2p", "kv" and "wsync"
# ---------------------------------------------------------------------------

def _exec_p2p_bucket(b: BucketPlan, x: torch.Tensor, group, perm, *, strategy: str,
                     label, reduce_into=None):
    """One P2P message from its BucketPlan: ``p2p_send``'s dispatch with the
    gate, width and fused knobs read off the plan (``split_send.p2p_dispatch``
    is the seam both share)."""
    return p2p_dispatch(x, group, perm, compressed=b.path == PATH_COMPRESSED,
                        width=b.width, block=b.block, exc_frac=b.exc_frac,
                        strategy=strategy, reduce_into=reduce_into, fused=b.fused,
                        encode_fused=b.encode_fused, axis_name=label)


def _check_kind(plan: CommPlan, kind: str) -> None:
    if plan.kind != kind:
        raise ValueError(f"a {plan.kind!r} plan handed to the {kind!r} executor")


def _check_leaves(plan: CommPlan, leaves, what: str) -> None:
    """A stale plan (another leaf count, shape or dtype) raises rather than
    scatter the wire into the wrong leaves."""
    if len(leaves) != plan.n_leaves:
        raise ValueError(f"{what} of {len(leaves)} leaves, plan of {plan.n_leaves}")
    for b in plan.buckets:
        for i, shape, _ in b.members:
            leaf = leaves[i]
            if tuple(leaf.shape) != tuple(shape) or dtype_name(leaf.dtype) != b.dtype_name:
                raise ValueError(f"{what} leaf {i} is {tuple(leaf.shape)}/"
                                 f"{dtype_name(leaf.dtype)} but the plan recorded "
                                 f"{tuple(shape)}/{b.dtype_name}")


def execute_p2p(plan: CommPlan, x: torch.Tensor, group, perm, *, reduce_into=None):
    """Run a compiled kind-"p2p" plan on ``x``: the bits of ``p2p_send``
    under the (policy, tensor class, strategy) the plan was compiled from.
    Returns (received, flag), or (``reduce_into`` + received in f32, flag)
    for a reducing receiver.  Records one ``plan:p2p`` WireReport."""
    _check_kind(plan, "p2p")
    _check_leaves(plan, [x], "tensor")
    b = plan.buckets[0]
    with _plan_span(plan), capture_wire_reports() as caught:
        with _bucket_ledger(plan, b.dtype_name, b.width):
            out = _exec_p2p_bucket(b, x, group, perm, strategy=plan.strategy,
                                   label=_label(plan), reduce_into=reduce_into)
    _emit(plan, caught)
    return out


def p2p_send_with_plan(x: torch.Tensor, group, perm, *, axis_name="data", policy=None,
                       tensor_class: str = "weight", strategy: str = "split_send",
                       reduce_into=None, plan: CommPlan = None, cache: PlanCache = None):
    """Plan-driven P2P send over ``group``.  With ``plan=None`` the plan is
    looked up by (shape, dtype, strategy, axis label, group size, policy,
    device) in ``cache`` (default: the process cache) and compiled on first
    sight.  Bit-identical to ``split_send.p2p_send``."""
    if plan is None:
        if policy is None:
            raise ValueError("p2p_send_with_plan needs policy= or plan=")
        plan = sched_compile.cached_p2p_plan(
            x, axis_name, policy=policy, n_dev=dist.get_world_size(group),
            tensor_class=tensor_class, strategy=strategy, cache=cache)
    return execute_p2p(plan, x, group, perm, reduce_into=reduce_into)


def execute_kv_transfer(plan: CommPlan, cache, group, perm):
    """Run a compiled kind-"kv" plan on a KV-cache pytree: the bits of
    ``serve/kv_transfer.transfer_cache`` under the (policy, strategy) the
    plan was compiled from: the buckets concatenate the same leaves in the
    same order and ride the same wire; raw leaves take the raw ppermute.
    Returns (cache at the target, flag); records one ``plan:kv`` report."""
    _check_kind(plan, "kv")
    leaves, treedef = tree_flatten(cache)
    _check_leaves(plan, leaves, "cache")
    out = list(leaves)
    flag = _no_flag(leaves[0])
    with _plan_span(plan), capture_wire_reports() as caught:
        for b in plan.buckets:
            with _bucket_ledger(plan, b.dtype_name, b.width):
                got, f = _exec_p2p_bucket(b, codec.concat_members(leaves, b.members),
                                          group, perm, strategy=plan.strategy,
                                          label=_label(plan))
            flag = torch.maximum(flag, f)
            for i, leaf in codec.split_members(got, b.members):
                out[i] = leaf
        with _bucket_ledger(plan, "raw", 0):
            send_raw_leaves(leaves, plan.raw_leaf_ix, out, group, perm)
    _emit(plan, caught)
    return tree_unflatten(treedef, out), flag


def transfer_cache_with_plan(cache, group, perm, *, axis_name="data", policy=None,
                             strategy: str = "split_send", plan: CommPlan = None,
                             plan_cache: PlanCache = None):
    """Plan-driven in-mesh KV-cache transfer over ``group``.  With
    ``plan=None`` the plan is looked up by the cache's signature (structure,
    leaf shapes and dtypes), the strategy, the policy and the group size in
    ``plan_cache``: a decode loop with a stable cache compiles once and hits
    after.  Bit-identical to ``serve/kv_transfer.transfer_cache``."""
    if plan is None:
        if policy is None:
            raise ValueError("transfer_cache_with_plan needs policy= or plan=")
        plan = sched_compile.cached_kv_plan(
            cache, axis_name, policy=policy, n_dev=dist.get_world_size(group),
            strategy=strategy, plan_cache=plan_cache)
    return execute_kv_transfer(plan, cache, group, perm)


def execute_wsync(plan: CommPlan, tree, group, perm, *, base=None):
    """Run a compiled kind-"wsync" plan on a weight pytree: the bits of
    ``sync/wire.sync_weights(tree, ..., base=base)`` under the (policy,
    strategy) the plan was compiled from (both call
    ``split_send.wsync_dispatch`` with the same arguments).  ``base``, the
    version both ends hold, ships XOR deltas on every delta-eligible bucket;
    ``None`` ships full tensors.  Returns (tree at the target, flag); a
    nonzero flag after a delta means the delta overflowed its widths and the
    caller must send in full.  Records one ``plan:wsync`` report."""
    _check_kind(plan, "wsync")
    leaves, treedef = tree_flatten(tree)
    base_leaves = None
    if base is not None:
        base_leaves, base_def = tree_flatten(base)
        if base_def != treedef:
            raise ValueError("the base tree's structure is not the weight tree's")
    _check_leaves(plan, leaves, "weight")
    out = list(leaves)
    flag = _no_flag(leaves[0])
    with _plan_span(plan), capture_wire_reports() as caught:
        for b in plan.buckets:
            bucket = codec.concat_members(leaves, b.members)
            bucket_base = (None if base_leaves is None
                           else codec.concat_members(base_leaves, b.members))
            with _bucket_ledger(plan, b.dtype_name, b.width):
                got, f = wsync_dispatch(
                    bucket, bucket_base, group, perm,
                    compressed=b.path == PATH_COMPRESSED, width=b.width,
                    delta_width=b.delta_width, delta_lo_width=b.delta_lo_width,
                    block=b.block, exc_frac=b.exc_frac, strategy=plan.strategy,
                    fused=b.fused, encode_fused=b.encode_fused, axis_name=_label(plan))
            flag = torch.maximum(flag, f)
            for i, leaf in codec.split_members(got, b.members):
                out[i] = leaf
        with _bucket_ledger(plan, "raw", 0):
            send_raw_leaves(leaves, plan.raw_leaf_ix, out, group, perm)
    _emit(plan, caught)
    return tree_unflatten(treedef, out), flag


def sync_weights_with_plan(tree, group, perm, *, axis_name="data", policy=None,
                           base=None, strategy: str = "split_send",
                           plan: CommPlan = None, cache: PlanCache = None):
    """Plan-driven in-mesh weight sync over ``group``.  With ``plan=None``
    the plan is looked up by the weight tree's signature, the strategy, the
    policy and the group size in ``cache``: a trainer that publishes a
    stable tree compiles once and hits after.  Bit-identical to
    ``sync/wire.sync_weights``."""
    if plan is None:
        if policy is None:
            raise ValueError("sync_weights_with_plan needs policy= or plan=")
        plan = sched_compile.cached_wsync_plan(
            tree, axis_name, policy=policy, n_dev=dist.get_world_size(group),
            strategy=strategy, cache=cache)
    return execute_wsync(plan, tree, group, perm, base=base)


def wsync_hop_perms(schedule, ranks) -> tuple:
    """Lower a :class:`~repro_torch.sched.plan.BroadcastSchedule` to one perm
    a hop level for the in-mesh wire.  ``ranks[0]`` is the trainer's group
    rank, ``ranks[1:]`` the receivers' in slot order (the distributor's
    sorted-name order).  Level ``h`` sends from the hop-``h-1`` holders to
    the hop-``h`` receivers, so replaying the levels in order delivers every
    rank once: a star is one wide level, a pipeline a chain of one-pair
    levels.  A rank list of another fleet size raises (a stale schedule)."""
    ranks = tuple(ranks)
    if len(ranks) != schedule.n_receivers + 1:
        raise ValueError(f"stale broadcast schedule: compiled for "
                         f"{schedule.n_receivers} receivers, got {len(ranks) - 1} ranks")
    return tuple(tuple((ranks[p], ranks[c]) for p, c in level)
                 for level in schedule.levels())


def execute_wsync_broadcast(plan: CommPlan, tree, group, ranks, *, base=None):
    """Run a wsync plan that carries a ``BroadcastSchedule`` as its hop
    levels: level h re-sends what the hop-(h-1) holders received along that
    level's perm (:func:`wsync_hop_perms`), one :func:`execute_wsync` each.

    The in-mesh twin of the fleet's host broadcast, driven by the same
    schedule; the host fleet forwards the encoded ``SyncUpdate`` as it is,
    while each in-mesh level encodes again at its sources.  A level whose
    perm repeats a source or a target (a star or tree node with more than
    one child) raises ``ValueError`` before anything is sent, as the
    reference's ``ppermute`` refuses it.  Returns (tree, flag): the tree each
    rank holds after the last level (the sender's bits at the ranks that
    level reaches; a rank it does not target holds what an untargeted
    ppermute leaves, zeros or, for a delta, its own base) and the
    ``torch.maximum`` of every level's flag, so a nonzero flag means some
    level's delta overflowed and the caller must send in full."""
    _check_kind(plan, "wsync")
    if plan.broadcast is None:
        raise ValueError("plan carries no BroadcastSchedule; use execute_wsync "
                         "with an explicit perm")
    levels = wsync_hop_perms(plan.broadcast, ranks)
    for level in levels:
        check_perm(level)
    current, flag = tree, _no_flag(tree_flatten(tree)[0][0])
    for level in levels:
        current, f = execute_wsync(plan, current, group, list(level), base=base)
        flag = torch.maximum(flag, f)
    return current, flag
