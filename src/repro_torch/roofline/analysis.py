"""Three-term roofline of a measured step (torch port of
``repro.roofline.analysis``).

    compute term    = FLOPs            / peak FLOP/s
    memory term     = HBM bytes        / HBM bandwidth
    collective term = collective bytes / link bandwidth

The reference reads a dry run's XLA cost analysis and parses its compiled
HLO text for the collectives.  The port reads what a step on the card did:
its FLOPs counted by ``torch.utils.flop_counter.FlopCounterMode`` (remat
replays included) and its collective bytes from a ``torch.profiler`` Chrome
trace of the step (:func:`collective_bytes`).  The cell JSON that
:func:`analyze_cell` reads keeps the reference's schema (``arch``,
``shape``, ``mesh``, ``ok``, ``cost``, ``wire``), with a ``.trace.json``
beside it in place of the ``.hlo.txt``.

The compressed collectives' WireReports (``core/policy``) give the packed
bytes of the same wires (:func:`summarize_wire_reports`):
``obs/regret.check_ledger_exactness`` holds the per-bucket ledger against
that summary, and the cell JSON's ``wire`` field stores it.

Hardware constants: the published figures of an NVIDIA H100 SXM5 80GB HBM3
at its 700 W limit.  Collective bytes are per-device operand bytes (what a
device injects), divided by one link's rate: a first-order model.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

# -- hardware constants: NVIDIA H100 SXM5 80GB HBM3, 700 W, published -------
PEAK_FLOPS_BF16 = 989.4e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # NVLink bytes/s per GPU per direction
NET_BW = 50e9  # bytes/s per GPU across nodes (400 Gb/s NDR)

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d dispatcher ops -> (kind, index of the argument whose bytes a device
# injects): an all-gather's input shard, a reduce-scatter's full input, an
# all-reduce's tensors, an all-to-all's input (a ppermute's: see below)
_C10D_OPS = {
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::allgather_": ("all-gather", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
}
_A2A_INPUT_SPLITS = 4  # alltoall_base_(output, input, group, out_splits, in_splits, ...)
# a range nested in a collective over a tensor list whose name ends in the
# list's element type: the dry run's (``launch/dryrun.LiveBytes``), as the
# fake backend records no event of its own
LIST_TYPE_EVENT = "c10d_list_type::"

# element sizes by the names a trace gives dtypes: a cpu_op's "Input type"
# (the C++ type) and NCCL's record_param_comms "dtype" (the ScalarType)
_ITEMSIZE = {
    "float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2, "int": 4,
    "long int": 8, "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1,
    "unsigned short": 2, "unsigned int": 4, "unsigned long": 8,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
    "Float": 4, "Double": 8, "Half": 2, "BFloat16": 2, "Int": 4, "Long": 8,
    "Short": 2, "Char": 1, "Byte": 1, "Bool": 1, "UInt16": 2, "UInt32": 4,
    "UInt64": 8, "Float8_e4m3fn": 1, "Float8_e5m2": 1,
}


def _numel(dims) -> int:
    """Elements of a trace's "Input Dims" entry: one tensor's dims or a
    list of them."""
    if dims and isinstance(dims[0], list):
        return sum(_numel(d) for d in dims)
    n = 1
    for d in dims:
        n *= int(d)
    return n


def _first_dims(dims):
    return dims[0] if dims and isinstance(dims[0], list) else dims


def _itemsize(name: str, where: str) -> int:
    if name not in _ITEMSIZE:
        raise ValueError(f"{where}: unknown element type {name!r}")
    return _ITEMSIZE[name]


def _events(trace) -> list:
    if isinstance(trace, str):
        trace = json.loads(trace)
    if isinstance(trace, dict):
        trace = trace.get("traceEvents", [])
    return [e for e in trace if e.get("ph") == "X"]


def collective_bytes(trace) -> dict:
    """Per-device collective operand bytes by kind, from a ``torch.profiler``
    Chrome trace exported with ``record_shapes=True`` (its JSON text, the
    parsed object, or its event list).

    It reads the ``c10d::*`` op events, which every backend's calls go
    through, on the calling thread: the op's name gives the kind
    (``_C10D_OPS``), its "Input Dims" the operand's elements and its
    "Input type" their type.  The port's P2P send, a ppermute, is an
    ``alltoall_base_`` with explicit split sizes ("Concrete Inputs"): it
    counts as a collective-permute of the rows its input splits send.  An argument that
    is a tensor list (``allreduce_``) carries no type; it is read from the
    backend's own event of the call: NCCL's ``record_param_comms`` nested in
    the op (its "dtype"), gloo's ``gloo:*`` event of the same dims that
    starts first at or after the op (its "Input type"), or, on the fake
    backend, a ``LIST_TYPE_EVENT`` range nested in the op (its name's
    suffix).  A collective whose type the trace does not give raises
    ValueError.  Under a Python dispatch mode (the dry run's fake tensors)
    the profiler records an op again inside itself at each redispatch: an
    op nested in a counted one on its thread is the same call, counted
    once."""
    events = _events(trace)
    comms = [e for e in events if e.get("name") == "record_param_comms"]
    marks = [e for e in events if str(e.get("name", "")).startswith(LIST_TYPE_EVENT)]
    gloo = sorted((e for e in events if str(e.get("name", "")).startswith("gloo:")),
                  key=lambda e: e["ts"])
    claimed: set = set()

    def list_itemsize(op, dims) -> int:
        for e in comms:
            if (e.get("tid") == op.get("tid") and op["ts"] <= e["ts"] <= op["ts"] + op["dur"]
                    and "dtype" in e.get("args", {})):
                return _itemsize(e["args"]["dtype"], op["name"])
        for e in marks:
            if e.get("tid") == op.get("tid") and op["ts"] <= e["ts"] <= op["ts"] + op["dur"]:
                return _itemsize(e["name"][len(LIST_TYPE_EVENT):], op["name"])
        for i, e in enumerate(gloo):
            a = e.get("args", {})
            if i in claimed or e["ts"] < op["ts"] or not a.get("Input Dims"):
                continue
            if a["Input Dims"][0] == _first_dims(dims):
                claimed.add(i)
                return _itemsize(a["Input type"][0], op["name"])
        raise ValueError(f"{op['name']} at {op['ts']}: the trace gives no element type "
                         f"of its tensor list")

    out = {k: 0 for k in _COLL_KINDS}
    counts = {k: 0 for k in _COLL_KINDS}
    ends: dict = {}  # thread -> end of the last op counted on it
    for op in sorted((e for e in events if e.get("name") in _C10D_OPS),
                     key=lambda e: e["ts"]):
        if op["ts"] < ends.get(op.get("tid"), float("-inf")):
            continue
        ends[op.get("tid")] = op["ts"] + op["dur"]
        kind, ix = _C10D_OPS[op["name"]]
        args = op.get("args", {})
        if "Input Dims" not in args:
            raise ValueError(f"{op['name']}: no Input Dims; export the trace with "
                             f"record_shapes=True")
        dims, typ = args["Input Dims"][ix], args["Input type"][ix]
        size = list_itemsize(op, dims) if typ == "TensorList" else _itemsize(typ, op["name"])
        n = _numel(dims)
        if op["name"] == "c10d::alltoall_base_":
            concrete = args.get("Concrete Inputs") or []
            raw = concrete[_A2A_INPUT_SPLITS] if len(concrete) > _A2A_INPUT_SPLITS else ""
            splits = json.loads(raw) if raw else []
            if splits:  # a ppermute: rows toward the targets only
                rows = _first_dims(dims)[0] if _first_dims(dims) else 0
                n = n // max(rows, 1) * sum(splits)
                kind = "collective-permute"
        out[kind] += n * size
        counts[kind] += 1
    return {"bytes": out, "counts": counts, "total_bytes": sum(out.values())}


@dataclasses.dataclass(frozen=True)
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops: float  # per-device FLOPs of the step
    hbm_bytes: float  # per-device bytes accessed
    coll_bytes: float  # per-device collective operand bytes
    model_flops: float  # 6·N_active·D (whole step, global)
    n_chips: int
    # measured wire accounting from the collectives' WireReports (the cell
    # JSON stores summarize_wire_reports output); 0 when the cell
    # compresses nothing
    wire_bytes: float = 0.0  # packed bytes actually on compressed wires
    wire_raw_bytes: float = 0.0  # what those wires would move raw
    decode_hbm_eliminated: float = 0.0  # fused-receive HBM savings
    encode_hbm_eliminated: float = 0.0  # fused-transmit (split+pack) savings

    @property
    def wire_ratio(self) -> float:
        """Measured wire compression ratio (packed / raw); 0 = no data."""
        return self.wire_bytes / self.wire_raw_bytes if self.wire_raw_bytes else 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline-ideal step time = max of the three terms (perfect
        overlap assumed)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (FLOPs × chips): how much of the executed compute
        is useful (catches remat and redundancy)."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the bound:
        (useful FLOPs / chips / peak) / t_bound."""
        t_useful = self.model_flops / self.n_chips / PEAK_FLOPS_BF16
        return t_useful / self.t_bound if self.t_bound else 0.0


def model_flops_for(arch: str, shape) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE) for a train shape; 2·N·D per
    processed token for prefill, per generated token for decode (forward
    only).  ``shape`` is a name of ``launch/cells.SHAPES`` or a
    ``cells.Shape``."""
    from repro_torch import configs
    from repro_torch.launch import cells as cells_lib

    cfg = configs.get(arch)
    shape = cells_lib.SHAPES[shape] if isinstance(shape, str) else shape
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # one token a sequence a step


def analyze_cell(json_path: str, trace_path: Optional[str] = None) -> Roofline:
    """The :class:`Roofline` of one cell JSON and its profiler trace
    (default: the JSON's path with ``.trace.json``).  ``n_chips`` and
    ``model_flops`` come from the record when it has them (a one-card cell,
    a shape outside ``cells.SHAPES``), else as the reference derives them:
    512 chips on a ``multi`` mesh, 256 otherwise, and
    :func:`model_flops_for`."""
    with open(json_path) as f:
        rec = json.load(f)
    trace_path = trace_path or json_path.replace(".json", ".trace.json")
    with open(trace_path) as f:
        coll = collective_bytes(f.read())
    n_chips = int(rec.get("n_chips") or (512 if rec["mesh"] == "multi" else 256))
    model_flops = rec.get("model_flops")
    if model_flops is None:
        model_flops = model_flops_for(rec["arch"], rec["shape"])
    wire = rec.get("wire") or {}
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        flops=float(rec["cost"].get("flops", 0.0) or 0.0),
        hbm_bytes=float(rec["cost"].get("bytes accessed", 0.0) or 0.0),
        coll_bytes=float(coll["total_bytes"]), model_flops=float(model_flops),
        n_chips=n_chips,
        wire_bytes=float(wire.get("wire_bytes", 0) or 0),
        wire_raw_bytes=float(wire.get("raw_bytes", 0) or 0),
        decode_hbm_eliminated=float(wire.get("decode_hbm_eliminated", 0) or 0),
        encode_hbm_eliminated=float(wire.get("encode_hbm_eliminated", 0) or 0),
    )


# ---------------------------------------------------------------------------
# Measured wire accounting from collective-emitted WireReports
# ---------------------------------------------------------------------------

def summarize_wire_reports(reports) -> dict:
    """Aggregate a sequence of WireReports into roofline-ready totals.

    Returns a dict with total raw/wire bytes, the overall compression
    ratio, the decoded-float HBM round-trip bytes still *paid* (unfused
    receives) and the bytes *eliminated* (fused receives), plus a
    per-collective-name breakdown.  ``decode_hbm_bytes`` on a report is the
    potential round-trip; the ``fused`` flag decides which bucket it lands
    in."""
    by_name: dict = {}

    def blank(name=None):
        d = {"n": 0, "raw_bytes": 0, "wire_bytes": 0,
             "decode_hbm_paid": 0, "decode_hbm_eliminated": 0, "n_fused": 0,
             "encode_hbm_paid": 0, "encode_hbm_eliminated": 0,
             "n_encode_fused": 0}
        if name is not None:
            d["name"] = name
        return d

    tot = blank()
    for r in reports:
        for d in (tot, by_name.setdefault(r.name, blank(r.name))):
            d["n"] += 1
            d["raw_bytes"] += r.raw_bytes
            d["wire_bytes"] += r.wire_bytes
            key = "decode_hbm_eliminated" if r.fused else "decode_hbm_paid"
            d[key] += r.decode_hbm_bytes
            d["n_fused"] += int(r.fused)
            ekey = ("encode_hbm_eliminated" if r.encode_fused
                    else "encode_hbm_paid")
            d[ekey] += r.encode_hbm_bytes
            d["n_encode_fused"] += int(r.encode_fused)
    tot["ratio"] = tot["wire_bytes"] / max(tot["raw_bytes"], 1)
    for d in by_name.values():
        d["ratio"] = d["wire_bytes"] / max(d["raw_bytes"], 1)
    tot["by_name"] = by_name
    return tot


def wire_report_seconds(reports, *, link_bw: float = LINK_BW) -> float:
    """First-order collective time of the reported wires (bytes / rate)."""
    return sum(r.wire_bytes for r in reports) / link_bw


def markdown_row(r: Roofline) -> str:
    return (f"| {r.arch} | {r.shape} | {r.mesh} | "
            f"{r.t_compute*1e3:.2f} | {r.t_memory*1e3:.2f} | "
            f"{r.t_collective*1e3:.2f} | {r.bottleneck} | "
            f"{r.useful_flops_fraction:.2f} | {r.roofline_fraction:.3f} |")


MD_HEADER = ("| arch | shape | mesh | compute (ms) | memory (ms) | "
             "collective (ms) | bottleneck | useful-FLOPs | roofline-frac |\n"
             "|---|---|---|---|---|---|---|---|---|")


def markdown_row_wire(r: Roofline) -> str:
    """Cell row with the measured wire accounting (the collectives'
    WireReports) next to the trace's collective bytes: two views of the same
    wires.  The two "HBM saved" columns are the fused-receive
    (decode+reduce) and fused-transmit (split+pack) round-trips the cell
    eliminated."""
    if r.wire_raw_bytes:
        wire = (f"{r.wire_bytes/2**20:.1f} | {r.wire_ratio:.3f} | "
                f"{r.decode_hbm_eliminated/2**20:.1f} | "
                f"{r.encode_hbm_eliminated/2**20:.1f}")
    else:
        wire = "- | - | - | -"
    return (f"| {r.arch} | {r.shape} | {r.mesh} | "
            f"{r.t_compute*1e3:.2f} | {r.t_memory*1e3:.2f} | "
            f"{r.t_collective*1e3:.2f} | {r.coll_bytes/2**20:.1f} | "
            f"{wire} | {r.bottleneck} | "
            f"{r.useful_flops_fraction:.2f} | {r.roofline_fraction:.3f} |")


MD_HEADER_WIRE = (
    "| arch | shape | mesh | compute (ms) | memory (ms) | collective (ms) | "
    "trace coll MiB | wire MiB | wire ratio | dec HBM saved MiB | "
    "enc HBM saved MiB | bottleneck | useful-FLOPs | roofline-frac |\n"
    "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|")
