"""Dry run of every (arch x shape x mesh) cell on fake tensors (torch port
of ``repro.launch.dryrun``).

The reference lowers and compiles each live cell's step on 256 or 512
placeholder CPU devices and reads XLA's memory and cost analyses.  The port
has no compiler to ask, so it runs the program of one rank: rank 0 of a
``fake`` process group of 256 (``single``: (data, model) = (16, 16)) or
512 (``multi``: (pod, data, model) = (2, 16, 16)) ranks, on the production
mesh (``launch.mesh.make_production_mesh(device="cpu")``), every tensor a
``FakeTensor`` under ``FakeTensorMode``: shapes and dtypes, no storage, the
kernels' plain versions as the route (the tensors lie on the CPU), and the
collectives answered by the fake backend.  No device is involved, as in
the reference's dry run: this is the one entry point that names no card,
and it never touches one when one is present.  Nothing else routes through
it.

Per cell it builds the rank's inputs (a train cell's ``TrainState`` of
:func:`make_train_config`, ZeRO-1 or FSDP by ``cells.TRAIN_KNOBS``; a serve
cell's parameters at ``shard_over_dp_bytes = 2 GiB`` and its cache block;
the batch, with ``frames`` for whisper and ``vision_embeds`` for qwen2-vl),
runs the step once (``train_step``/``fsdp_train_step``, ``prefill``,
``decode_step``) under a FLOP counter, a tracker of live storages
(:class:`LiveBytes`) and ``torch.profiler``, and writes
``<arch>__<shape>__<mesh>[__raw].json`` in the reference's schema
(``roofline/report.collect`` reads it) and ``<tag>.trace.json``, the
profiler's Chrome trace cut to the collective events that
``roofline/analysis.collective_bytes`` reads.

Two host reads of the main path are answered here: a decode cell's cache
holds its position as a real int32 scalar among the fake leaves
(``kernels.host_int``), and the ZeRO-1 step's overflow flag, a fake tensor,
takes the committing branch (``train/step.train_step``).

The ZeRO-1 state differs from the reference's specs on purpose: the specs
lay each bucket leaf out ``(dp, None)`` over ``(n_dp, n_model *
shard_len)``, so bytes computed from them count a rank's row once a model
shard; the port's rank holds its ``(shard_len,)`` block.  The JSON's
``argument_size_bytes`` is what the rank holds; ``spec_argument_size_bytes``
beside it is what the specs give.

Usage (CPU only, any machine):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama_1_1b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out-dir experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.core import codec
from repro_torch.core import policy as policy_lib
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch import cells as cells_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import registry, tp, transformer
from repro_torch.optim import optimizers as opt_lib
from repro_torch.roofline import analysis
from repro_torch.serve import sharding as serve_sharding
from repro_torch.train import step as step_lib
from repro_torch.tree_util import tree_flatten, tree_flatten_up_to, tree_leaves, tree_map_up_to

SHARD_OVER_DP_BYTES = 2 << 30  # the serve cells' parameter layout, as the reference's
# the profiler's names of element types (a cpu_op's "Input type")
TYPE_NAMES = {
    torch.float32: "float", torch.float64: "double", torch.float16: "c10::Half",
    torch.bfloat16: "c10::BFloat16", torch.int32: "int", torch.int64: "long int",
    torch.int16: "short int", torch.int8: "signed char", torch.uint8: "unsigned char",
    torch.bool: "bool", torch.float8_e4m3fn: "c10::Float8_e4m3fn",
    torch.float8_e5m2: "c10::Float8_e5m2",
}
# what the trace file keeps: the events collective_bytes reads
_TRACE_KEEP = tuple(analysis._C10D_OPS) + (analysis.LIST_TYPE_EVENT,)


def _shape(shape_name) -> cells_lib.Shape:
    return cells_lib.SHAPES[shape_name] if isinstance(shape_name, str) else shape_name


def _batch_structs(cfg, mesh, batch: int, seq: int, *, dp: tuple) -> tuple:
    """``(struct, specs)`` of a global batch (``registry.batch_specs``): its
    rows over ``dp`` where they divide, else replicated, as the
    reference's ``_batch_structs``."""
    n_dp = int(np.prod([mesh_lib.axis_sizes(mesh)[a] for a in dp]))
    lead = (dp if len(dp) > 1 else dp[0]) if batch % n_dp == 0 else None
    struct = registry.batch_specs(cfg, batch, seq)
    return struct, {k: (lead,) + (None,) * (t.ndim - 1) for k, t in struct.items()}


def input_specs(arch: str, shape_name, mesh) -> tuple:
    """``(struct, specs)`` of every input of the cell's step function, in
    the reference's order (``meta`` tensors of the global shapes, specs as
    ``launch/mesh`` holds them): train ``(state, batch)``; prefill
    ``(params, batch, cache)``; decode ``(params, tokens, cache[, enc_out])``.
    A leaf's per-device shape is ``mesh.shard_shape(t.shape, spec, mesh)``
    (:func:`local_shapes`), the reference's ``sharding.shard_shape``."""
    cfg = configs.get(arch)
    shape = _shape(shape_name)
    dp = step_lib.dp_axes_of(mesh)
    if shape.kind == "train":
        tcfg = make_train_config(arch, mesh)
        state = step_lib.abstract_train_state(cfg, tcfg, mesh)
        batch = _batch_structs(cfg, mesh, shape.global_batch, shape.seq_len,
                               dp=step_lib.train_axes_of(mesh, tcfg))
        return (state, batch)
    pspecs = serve_sharding.serve_param_specs(cfg, mesh,
                                              shard_over_dp_bytes=SHARD_OVER_DP_BYTES)
    params = serve_sharding.abstract_params_sharded(cfg, mesh, pspecs)
    cache = serve_sharding.abstract_cache(cfg, mesh, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        (b, bs) = _batch_structs(cfg, mesh, shape.global_batch, shape.seq_len, dp=dp)
        b.pop("labels")
        bs.pop("labels")
        return (params, (b, bs), cache)
    # decode: one new token against a seq_len-deep cache
    (b, bs) = _batch_structs(cfg, mesh, shape.global_batch, 1, dp=dp)
    extra = ()
    if cfg.enc_dec:
        enc = torch.empty((shape.global_batch, cfg.enc_seq, cfg.d_model),
                          dtype=codec.LAYOUTS[cfg.dtype].dtype, device="meta")
        extra = ((enc, bs["tokens"] + (None,)),)
    return (params, (b["tokens"], bs["tokens"]), cache) + extra


def local_shapes(arg, mesh) -> list:
    """The per-device shapes of one :func:`input_specs` entry, in its
    struct's leaf order."""
    struct, specs = arg
    leaves, treedef = tree_flatten(struct)
    return [mesh_lib.shard_shape(t.shape, s, mesh)
            for t, s in zip(leaves, tree_flatten_up_to(treedef, specs))]


def make_train_config(arch: str, mesh, *, compressed: bool = True,
                      dp_only: bool | None = None) -> step_lib.TrainConfig:
    """The train cell's ``TrainConfig``: partition, optimizer and
    microbatches from ``cells.TRAIN_KNOBS`` (microbatches at most the
    rank's rows of ``train_4k``), ``dp_only`` where the knobs set it."""
    knobs = cells_lib.TRAIN_KNOBS[arch]
    partition, optimizer, micro = knobs[:3]
    dpo = knobs[3] if len(knobs) > 3 else False
    if dp_only is not None:
        dpo = dp_only
    sizes = mesh_lib.axis_sizes(mesh)
    n_sync = int(np.prod(list(sizes.values()))) if dpo else mesh_lib.dp_size(mesh)
    local_batch = max(1, cells_lib.SHAPES["train_4k"].global_batch // n_sync)
    return step_lib.TrainConfig(
        microbatches=min(micro, local_batch), partition=partition,
        optim=opt_lib.OptimConfig(name=optimizer),
        policy=CompressionPolicy() if compressed else CompressionPolicy.disabled(),
        dp_only=dpo)


def build_step_fn(arch: str, shape_name, mesh, *, compressed: bool = True) -> tuple:
    """``(step, donate)``: the cell's step over the rank's inputs
    (:func:`build_inputs`) and the indices of the inputs it updates in
    place (the reference's donated arguments)."""
    cfg = configs.get(arch)
    shape = _shape(shape_name)
    if shape.kind == "train":
        tcfg = make_train_config(arch, mesh, compressed=compressed)
        fn = step_lib.fsdp_train_step if tcfg.partition == "fsdp" else step_lib.train_step

        def train(state, batch):
            return fn(state, batch, tcfg)
        return train, (0,)
    if shape.kind == "prefill":
        def prefill(model, batch, cache):
            return transformer.prefill(model, batch["tokens"], cache,
                                       vision_embeds=batch.get("vision_embeds"),
                                       frames=batch.get("frames"))
        return prefill, (2,)
    if cfg.enc_dec:
        def decode(model, tokens, cache, enc_out):
            return transformer.decode_step(model, tokens, cache, enc_out=enc_out)
        return decode, (2,)

    def decode(model, tokens, cache):
        return transformer.decode_step(model, tokens, cache)
    return decode, (2,)


def make_groups(mesh, tcfg: step_lib.TrainConfig | None = None) -> None:
    """Every process group a cell's step reads, made now: ``axis_group``
    reads the mesh's rank grid on the host, which a ``FakeTensorMode``
    refuses.  Each is cached on the mesh."""
    dp = step_lib.dp_axes_of(mesh)
    for axes in (("model",), dp, dp + ("model",)):
        mesh_lib.axis_group(mesh, axes)
    tp.model_group(mesh)
    if tcfg is not None:
        step_lib.sync_group(mesh, tcfg)


def build_inputs(arch: str, shape_name, mesh, specs: tuple, *, compressed: bool = True,
                 seed: int = 0) -> tuple:
    """The rank's inputs of the cell's step, on the CPU (fake tensors under
    a ``FakeTensorMode``, real ones otherwise): the train state (this
    rank's blocks, :func:`make_train_config`) or the serve parameters and
    cache block, and the batch of the per-device shapes of ``specs``
    (:func:`input_specs`).  A decode cell's cache sits at ``seq_len - 1``,
    its position a real int32 scalar."""
    cfg = configs.get(arch)
    shape = _shape(shape_name)
    gen = torch.Generator().manual_seed(seed)

    def zeros(arg):
        return tree_map_up_to(lambda t, s: torch.zeros(mesh_lib.shard_shape(t.shape, s, mesh),
                                                       dtype=t.dtype), *arg)

    if shape.kind == "train":
        tcfg = make_train_config(arch, mesh, compressed=compressed)
        state = step_lib.build_train_state(cfg, tcfg, generator=gen, mesh=mesh, device="cpu")
        return (state, zeros(specs[1]))
    model = transformer.init(cfg, generator=gen, device="cpu", mesh=mesh,
                             param_specs=specs[0][1])
    cache = transformer.init_cache(cfg, shape.global_batch, shape.seq_len, device="cpu",
                                   mesh=mesh)
    if shape.kind == "prefill":
        return (model, zeros(specs[1]), cache)
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        cache["pos"] = torch.tensor(shape.seq_len - 1, dtype=torch.int32)
    tokens = zeros(specs[1])
    return (model, tokens, cache) + tuple(zeros(s) for s in specs[3:])


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def input_tensors(x) -> list:
    """The tensors of an input: a model's parameters, a train state's model
    and optimizer leaves, or a tree's leaves."""
    if isinstance(x, step_lib.TrainState):
        return input_tensors(x.model) + tree_leaves(x.opt)
    if isinstance(x, torch.nn.Module):
        return [p.detach() for p in x.parameters()]
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def storage_bytes(tensors) -> int:
    """The bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


class LiveBytes(TorchDispatchMode):
    """The live bytes of the storages that ops make while active, on top of
    the ``arguments`` (tensors alive before, kept alive while the mode
    lives), and their peak; works on fake and real tensors alike.  A
    storage counts from the first op output that holds it until the last
    tensor holding it dies.  Also records the
    arguments' storages that ops write in place (``written``) and, per
    c10d collective, ``(kind, bytes, group name)`` counted as
    ``roofline.analysis.collective_bytes`` counts it (``collectives``); a
    collective over a tensor list runs inside a ``LIST_TYPE_EVENT`` range
    whose name carries the list's element type, which the trace alone does
    not give."""

    def __init__(self, arguments):
        super().__init__()
        # held, so no argument's storage is freed (and its address taken by
        # a new one) while active: a step may replace a state's leaves
        self.held = list(arguments)
        self.args = {}
        for t in arguments:
            self.args[_storage_key(t)] = t.untyped_storage().nbytes()
        self.arg_bytes = sum(self.args.values())
        self.live = {}  # storage key -> [bytes, tensors alive]
        self.tensors = {}  # id of a tracked tensor -> its storage key
        self.total = self.peak = self.arg_bytes
        self.written: set = set()
        self.collectives: list = []
        self.schemas: dict = {}  # op -> (name, (index, name) of each argument it writes)

    def _drop(self, tid: int) -> None:
        key = self.tensors.pop(tid)
        entry = self.live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.total -= entry[0]
            del self.live[key]

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self.args or id(t) in self.tensors:
            return
        n = t.untyped_storage().nbytes()
        entry = self.live.setdefault(key, [0, 0])
        if n > entry[0]:
            self.total += n - entry[0]
            entry[0] = n
            self.peak = max(self.peak, self.total)
        entry[1] += 1
        self.tensors[id(t)] = key
        weakref.finalize(t, self._drop, id(t))

    def _collective(self, name: str, args) -> None:
        kind, ix = analysis._C10D_OPS[name]
        arg = args[ix]
        ts = arg if isinstance(arg, (list, tuple)) else [arg]
        n = sum(t.numel() for t in ts)
        if name == "c10d::alltoall_base_" and args[analysis._A2A_INPUT_SPLITS]:
            rows = ts[0].shape[0] if ts[0].dim() else 1
            n = n // max(rows, 1) * sum(args[analysis._A2A_INPUT_SPLITS])
            kind = "collective-permute"
        pg = args[1] if name == "c10d::allreduce_" else args[2]
        group = torch._C._distributed_c10d.ProcessGroup.unbox(pg).group_name
        self.collectives.append((kind, n * ts[0].element_size(), group))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self.schemas:
            sch = func._schema
            self.schemas[func] = (sch.name, tuple(
                (i, a.name) for i, a in enumerate(sch.arguments)
                if a.alias_info is not None and a.alias_info.is_write))
        name, writes = self.schemas[func]
        for i, arg_name in writes:
            a = args[i] if i < len(args) else kwargs.get(arg_name)
            for t in (a if isinstance(a, (list, tuple)) else [a]):
                if isinstance(t, torch.Tensor) and _storage_key(t) in self.args:
                    self.written.add(_storage_key(t))
        if name in analysis._C10D_OPS:
            self._collective(name, args)
            if isinstance(args[0], (list, tuple)):
                typ = TYPE_NAMES[args[0][0].dtype]
                with torch.profiler.record_function(analysis.LIST_TYPE_EVENT + typ):
                    out = func(*args, **kwargs)
                return out
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def summary(self, outputs) -> dict:
        """The reference's ``memory`` fields: arguments, outputs (storages
        that are not arguments), the peak above the arguments, the
        arguments written in place."""
        outs = {}
        for t in outputs:
            if _storage_key(t) not in self.args:
                outs[_storage_key(t)] = t.untyped_storage().nbytes()
        return {"argument_size_bytes": self.arg_bytes,
                "output_size_bytes": sum(outs.values()),
                "temp_size_bytes": self.peak - self.arg_bytes,
                "alias_size_bytes": sum(self.args[k] for k in self.written),
                "generated_code_size_bytes": None}

    def collective_summary(self) -> dict:
        """``{"bytes": {kind: B}, "counts": {kind: n}, "by_group": {group:
        {kind: B}}}`` of the collectives seen."""
        out = {k: 0 for k in analysis._COLL_KINDS}
        counts = dict(out)
        by_group: dict = {}
        for kind, n, group in self.collectives:
            out[kind] += n
            counts[kind] += 1
            g = by_group.setdefault(group, {k: 0 for k in analysis._COLL_KINDS})
            g[kind] += n
        return {"bytes": out, "counts": counts, "by_group": by_group}


def measure(step, args, *, trace_path: str | None = None) -> dict:
    """Run ``step(*args)`` once under a FLOP counter, :class:`LiveBytes`
    and (with ``trace_path``) ``torch.profiler``; the wire reports it makes
    are captured, and the module ledger is cleared before and after.
    Returns ``{"out", "memory", "flops", "wire", "reports", "collectives",
    "run_s"}`` (and ``"trace"``, the collective events kept, with
    ``trace_path``)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    live = LiveBytes([t for a in args for t in input_tensors(a)])
    policy_lib.clear_wire_reports()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        prof = (stack.enter_context(profile(activities=[ProfilerActivity.CPU],
                                            record_shapes=True))
                if trace_path else None)
        reports = stack.enter_context(policy_lib.capture_wire_reports())
        counter = stack.enter_context(FlopCounterMode(display=False))
        stack.enter_context(live)
        out = step(*args)
    run_s = time.perf_counter() - t0
    policy_lib.clear_wire_reports()
    res = {"out": out, "memory": live.summary(input_tensors(out)),
           "flops": counter.get_total_flops(), "reports": list(reports),
           "wire": analysis.summarize_wire_reports(reports),
           "collectives": live.collective_summary(), "run_s": run_s}
    if trace_path:
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        kept = [e for e in events if e.get("ph") == "X"
                and str(e.get("name", "")).startswith(_TRACE_KEEP)]
        with open(trace_path, "w") as f:
            json.dump({"traceEvents": kept}, f)
        res["trace"] = kept
    return res


@contextlib.contextmanager
def fake_world(n: int):
    """A ``fake`` process group of ``n`` ranks, this process rank 0; the
    world is destroyed on exit.  A process that already has a default group
    cannot hold a second one: it raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes a fake world of its own; this process "
                           "already has a default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_of(mesh_kind: str, mesh_shape=None) -> tuple:
    """``(shape, axes)``: the production mesh of ``mesh_kind`` (``single``
    (16, 16), ``multi`` (2, 16, 16)), or ``mesh_shape`` (2 or 3 dims)."""
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if mesh_kind == "multi" else (16, 16)
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    return tuple(int(s) for s in mesh_shape), axes


def _wire_fields(wire: dict) -> dict:
    keep = ("n", "n_fused", "raw_bytes", "wire_bytes", "ratio", "decode_hbm_paid",
            "decode_hbm_eliminated", "encode_hbm_paid", "encode_hbm_eliminated")
    out = {k: wire[k] for k in keep}
    out["by_name"] = {k: {"n": v["n"], "wire_bytes": v["wire_bytes"], "ratio": v["ratio"]}
                      for k, v in wire["by_name"].items()}
    return out


def _check_inputs(args, specs, mesh, tcfg) -> dict:
    """Hold the rank's inputs against :func:`input_specs`: every parameter,
    cache and batch leaf has its per-device shape; the optimizer state's
    bytes are the specs' (FSDP) or the specs' over the model size (ZeRO-1,
    whose specs count a rank's bucket row once a model shard).  Returns
    the specs' per-device bytes."""
    def same(tensors, arg):
        want = local_shapes(arg, mesh)
        got = [tuple(t.shape) for t in tensors]
        if got != want:
            bad = [(g, w) for g, w in zip(got, want) if g != w][:3]
            raise AssertionError(f"rank inputs {bad} differ from the specs' per-device "
                                 f"shapes ({len(got)} leaves against {len(want)})")

    spec_bytes = sum(mesh_lib.shard_bytes(a, mesh) for a in specs)
    for i, (a, s) in enumerate(zip(args, specs)):
        if isinstance(a, step_lib.TrainState):
            st, sp = s
            same(input_tensors(a.model), (st["params"], sp["params"]))
            leaves = tree_leaves(a.opt)
            held = storage_bytes(t for t in leaves if t.dim())
            scalars = storage_bytes(t for t in leaves if not t.dim())
            want = mesh_lib.shard_bytes((st["opt"], sp["opt"]), mesh)
            n_inner = 1 if tcfg.partition == "fsdp" or tcfg.dp_only else \
                mesh_lib.axis_sizes(mesh)["model"]
            if held * n_inner + scalars != want:
                raise AssertionError(f"optimizer state {held} + {scalars} B a rank, the "
                                     f"specs' {want} B over {n_inner} model shards")
        elif isinstance(a, torch.nn.Module):
            same(input_tensors(a), s)
        else:
            same(tree_leaves(a), s)
    return spec_bytes


def _check_collectives(coll: dict, traced, reports, mesh, args, tcfg) -> None:
    """The trace's collective bytes (``traced``, None without a trace) are
    the ones the step issued, and the sync group's are what the plan and
    the wire reports say the rank moves: at every kind the trace's bytes
    equal what :class:`LiveBytes` counted; over the sync group of ``n`` ranks the all-to-all bytes are
    the reduce-scatter phases' and ``n`` times the all-gather bytes (the
    rank's shard) are the all-gather phases' (an all-gather's wire is all
    ``n`` shards).  The phases' bytes are the ZeRO-1 plan's (a bucket's
    wire bytes, or its raw bytes where the policy gates it off; the plan's
    wire bytes are the wire reports'), or an FSDP step's wire reports' by
    name (a raw FSDP step reports none: its sync bytes are not held
    against anything).  A serve step reports no compressed wire."""
    if traced is not None and (traced["bytes"] != coll["bytes"]
                               or traced["counts"] != coll["counts"]):
        raise AssertionError(f"trace collectives {traced} differ from the step's {coll}")
    if tcfg is None:
        if reports:
            raise AssertionError(f"a serve step reported compressed wires {reports}")
        return
    group = step_lib.sync_group(mesh, tcfg).group
    ours = coll["by_group"].get(group.group_name, dict.fromkeys(analysis._COLL_KINDS, 0))
    wire = sum(r.wire_bytes for r in reports)
    if tcfg.partition == "fsdp":
        if not tcfg.policy.enabled:
            return
        rs, ag = (sum(r.wire_bytes for r in reports if r.name == n)
                  for n in ("reduce_scatter", "all_gather"))
    else:
        plan = step_lib.zero1_plan(args[0], tcfg)
        if wire != plan.wire_bytes:
            raise AssertionError(f"the wire reports {wire} B, the zero1 plan "
                                 f"{plan.wire_bytes} B")
        rs, ag = (sum(b.wire_bytes if b.compressed else b.raw_bytes for b in phase)
                  for phase in zip(*((p.rs, p.ag) for p in plan.buckets)))
    n = dist.get_world_size(group)
    if (ours["all-to-all"], n * ours["all-gather"]) != (rs, ag):
        raise AssertionError(f"the sync group ({n} ranks) moved {ours['all-to-all']} B of "
                             f"all-to-all and {ours['all-gather']} B of all-gather shards; "
                             f"the reduce-scatter phases {rs} B, the all-gather phases {ag} B")


def run_cell(arch: str, shape_name, mesh_kind: str, out_dir: str, *,
             compressed: bool = True, save_trace: bool = True, mesh_shape=None,
             fake: bool = True) -> dict:
    """Run one cell on rank 0 of a fake world (:func:`mesh_of`; a test may
    pass a small ``mesh_shape`` and a ``cells.Shape`` in place of a name)
    and write ``<tag>.json`` and ``<tag>.trace.json`` into ``out_dir``.
    Returns the JSON's record.  ``fake=False`` runs the same program on
    real CPU tensors in a gloo world of one rank (``mesh_shape`` all ones):
    what the fake run's accounting is held against."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.train import single_process_group

    shape = _shape(shape_name)
    t0 = time.perf_counter()
    dims, axes = mesh_of(mesh_kind, mesh_shape)
    tag = f"{arch}__{shape.name}__{mesh_kind}" + ("" if compressed else "__raw")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, tag + ".trace.json") if save_trace else None
    if not fake and int(np.prod(dims)) != 1:
        raise ValueError(f"a run on real tensors takes a mesh of one rank, not {dims}")
    world = fake_world(int(np.prod(dims))) if fake else single_process_group("cpu")
    with world:
        mesh = mesh_lib.make_mesh(dims, axes, device="cpu")
        tcfg = (make_train_config(arch, mesh, compressed=compressed)
                if shape.kind == "train" else None)
        make_groups(mesh, tcfg)
        specs = input_specs(arch, shape, mesh)
        with FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext():
            args = build_inputs(arch, shape, mesh, specs, compressed=compressed)
            spec_bytes = _check_inputs(args, specs, mesh, tcfg)
            step, _ = build_step_fn(arch, shape, mesh, compressed=compressed)
            build_s = time.perf_counter() - t0
            res = measure(step, args, trace_path=trace_path)
        _check_collectives(res["collectives"], analysis.collective_bytes(res["trace"])
                           if trace_path else None, res["reports"], mesh, args, tcfg)
    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind, "compressed": compressed,
        "ok": True, "mesh_shape": dict(zip(axes, dims)), "fake": fake,
        "build_s": round(build_s, 1), "run_s": round(res["run_s"], 1),
        "memory": dict(res["memory"], spec_argument_size_bytes=spec_bytes),
        "cost": {"flops": res["flops"]},
        "cost_raw_keys": ["flops"],
        "cost_source": {"flops": "torch.utils.flop_counter.FlopCounterMode, one rank"},
        "wire": _wire_fields(res["wire"]),
        "collectives": {k: res["collectives"][k] for k in ("bytes", "counts")},
        "n_chips": int(np.prod(dims)),
        "model_flops": analysis.model_flops_for(arch, shape),
    }
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--raw", action="store_true", help="compression-disabled baseline")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--no-trace", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(c.arch, c.shape.name) for c in cells_lib.live_cells()]
    elif args.arch and args.shape in (None, "all"):
        todo = [(c.arch, c.shape.name) for c in cells_lib.live_cells() if c.arch == args.arch]
        assert todo, f"unknown arch {args.arch}"
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        todo = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in todo:
        for mk in meshes:
            try:
                r = run_cell(arch, shape, mk, args.out_dir, compressed=not args.raw,
                             save_trace=not args.no_trace)
                mem = r["memory"]
                print(f"OK   {arch:22s} {shape:12s} {mk:6s} build {r['build_s']:7.1f}s "
                      f"run {r['run_s']:7.1f}s "
                      f"args {mem['argument_size_bytes'] / 2**30:7.2f}GiB "
                      f"temp {mem['temp_size_bytes'] / 2**30:7.2f}GiB "
                      f"flops {r['cost']['flops']:.4e} wire {r['wire']['ratio']:.4f} "
                      f"coll {sum(r['collectives']['bytes'].values())}", flush=True)
            except Exception as e:
                failures += 1
                print(f"FAIL {arch:22s} {shape:12s} {mk:6s} "
                      f"{type(e).__name__}: {str(e)[:200]}", flush=True)
                traceback.print_exc()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
