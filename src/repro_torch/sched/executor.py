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
raw and wire totals and the fused/unfused HBM split.

Entry points:
  * :func:`psum_with_plan`: pytree all-reduce (the plan twin of
    ``tree_psum_compressed``), over :func:`execute_psum`;
  * :func:`reduce_scatter_with_plan`: flat local bucket -> reduced shard;
  * :func:`all_gather_with_plan`: flat local shard -> gathered buckets;
  * :class:`Zero1Execution`: ZeRO-1's two phases around its update
    (``optim/zero1.zero1_step``).

Every function takes the ``torch.distributed`` group that carries the wire
(``None``: the world); the plan's ``axis`` holds the labels it was gated on.
The ``kv`` and ``wsync`` kinds are replayed by the serve and weight-sync
engines over the host wire, not here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.compressed_collectives import (
    _no_flag, all_gather_compressed, psum_compressed_ring, psum_raw_twoshot,
    psum_safe, reduce_scatter_compressed)
from repro_torch.core.policy import (WireReport, capture_wire_reports,
                                     record_wire_report)
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


def _emit(plan: CommPlan, caught) -> None:
    """Record the consolidated WireReport of one plan execution.  The
    reference also feeds its metrics registry and its plan-drift monitor
    from this record here; they come with the port of ``obs``."""
    rep = consolidate_reports(plan, caught)
    if rep is not None:
        record_wire_report(rep)


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
    with capture_wire_reports() as caught:
        for b in plan.buckets:
            parts = [leaves[i].reshape(-1) for i, _, _ in b.members]
            bucket = torch.cat(parts) if len(parts) > 1 else parts[0]
            red, f = _exec_psum_bucket(b, bucket, group, label)
            flag = torch.maximum(flag, f)
            off = 0
            for i, shape, size in b.members:
                out[i] = red[off: off + size].reshape(shape)
                off += size
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
    with capture_wire_reports() as caught:
        out = _exec_reduce_scatter(plan.buckets[0], x, group, _label(plan))
    _emit(plan, caught)
    return out


def all_gather_with_plan(y: torch.Tensor, group=None, *, axis_name="data",
                         policy=None, tensor_class: str = "weight",
                         plan: CommPlan = None, cache: PlanCache = None):
    """Plan-driven flat all-gather.  Returns (gathered, flag)."""
    if plan is None:
        plan = _flat_plan("all_gather", y, group, axis_name, policy, tensor_class,
                          cache)
    with capture_wire_reports() as caught:
        out = _exec_all_gather(plan.buckets[0], y, group, _label(plan))
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

    def __enter__(self):
        self._caught = self._cap.__enter__()
        return self

    def __exit__(self, *exc):
        self._cap.__exit__(*exc)
        if exc[0] is None:
            _emit(self.plan, self._caught)
        return False

    def reduce_scatter(self, i: int, gbucket: torch.Tensor):
        """Bucket ``i``'s RS phase: (f32 shard, flag)."""
        return _exec_reduce_scatter(self.plan.buckets[i].rs, gbucket, self.group,
                                    _label(self.plan))

    def all_gather(self, i: int, shard: torch.Tensor):
        """Bucket ``i``'s AG phase: (gathered, flag)."""
        return _exec_all_gather(self.plan.buckets[i].ag, shard, self.group,
                                _label(self.plan))
