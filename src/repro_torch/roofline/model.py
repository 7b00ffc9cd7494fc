"""Analytic compute / memory model of a cell (torch port of
``repro.roofline.model``).

``analytic_cost`` gives explicit, documented FLOPs and HBM-byte formulas
from the architecture configs and the distribution plan; remat replays are
itemized, so the useful-FLOPs ratio measures recompute waste.
``analyze_cell_v2`` sets them beside a step's measured collective bytes.

The reference also walks the compiled HLO's while loops and multiplies
each collective by its loop's trip count
(``collective_bytes_trip_aware``), because XLA's cost analysis counts a
loop body once.  A profiler trace records every execution of a collective,
so the port reads the trace (``analysis.collective_bytes``) and has no such
walk.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.roofline.analysis import Roofline, collective_bytes


@dataclasses.dataclass(frozen=True)
class AnalyticCost:
    """Per-STEP totals (whole job, divide by chips for per-device)."""
    gemm_flops: float  # matmul flops incl. remat replays
    attn_flops: float  # attention score/AV flops incl. remat/flash-bwd
    model_flops: float  # the 6·N_active·D (or 2·N·D) "useful" figure
    hbm_bytes_per_device: float
    notes: str

    @property
    def total_flops(self) -> float:
        return self.gemm_flops + self.attn_flops


def analytic_cost(arch: str, shape, mesh_kind: str = "single", *,
                  micro_remat: Optional[bool] = None, n_chips: Optional[int] = None,
                  n_model: int = 16) -> AnalyticCost:
    """The cost of one step of ``arch`` at ``shape`` (a name of
    ``cells.SHAPES`` or a ``cells.Shape``) on ``n_chips`` chips (default, as
    the reference: 512 on a ``multi`` mesh, 256 otherwise) whose model axis
    has ``n_model`` (default 16), which must divide ``n_chips`` (else
    ValueError); a one-card step is ``n_chips=1, n_model=1``.  Parameters
    are sharded over all chips where the arch trains under FSDP
    (``cells.TRAIN_KNOBS``), else over the model axis alone."""
    from repro_torch import configs
    from repro_torch.launch import cells as cells_lib

    cfg = configs.get(arch)
    shape = cells_lib.SHAPES[shape] if isinstance(shape, str) else shape
    if n_chips is None:
        n_chips = 512 if mesh_kind == "multi" else 256
    if n_model < 1 or n_chips % n_model:
        raise ValueError(f"a model axis of {n_model} does not divide {n_chips} chips")
    n_dp = n_chips // n_model
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    n_active = cfg.active_param_count()
    P_total = cfg.param_count()

    # ---- GEMM flops ----------------------------------------------------------
    if shape.kind == "train":
        _, _, micro = cells_lib.TRAIN_KNOBS[arch][:3]
        mr = micro_remat if micro_remat is not None else (micro > 1)
        # fwd 2ND + bwd 4ND + layer-remat fwd replay 2ND
        # + microbatch-remat fwd replay 2ND (when grad accum is remat'd)
        fwd_eq = 1 + 2 + 1 + (1 if mr else 0)
        gemm = 2.0 * n_active * tokens * fwd_eq
        model = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        gemm = 2.0 * n_active * tokens
        model = gemm
    else:  # decode: one token per sequence
        gemm = 2.0 * n_active * B
        model = gemm

    # ---- attention flops -----------------------------------------------------
    specs = list(cfg.prefix) + list(cfg.pattern) * cfg.repeats
    attn = 0.0
    for s in specs:
        if s.mixer not in ("attn", "mla"):
            continue
        hd_eff = cfg.hd + (cfg.mla.rope_dim if s.mixer == "mla" else 0)
        ctx = min(s.window or S, S)
        if shape.kind == "decode":
            attn += 4.0 * B * ctx * cfg.n_heads * hd_eff  # qk + av, 1 query
        else:
            # causal ≈ half of S×ctx; qk+av = 2 gemms
            per_fwd = 2.0 * B * S * ctx * cfg.n_heads * hd_eff
            if shape.kind == "train":
                # fwd + flash-bwd (2 recompute passes + dq/dk/dv ≈ 3.5x)
                # + layer-remat replay of fwd (+ microbatch remat replay)
                _, _, micro = cells_lib.TRAIN_KNOBS[arch][:3]
                mr = micro_remat if micro_remat is not None else (micro > 1)
                per_fwd *= (1 + 3.5 + 1 + (1 if mr else 0))
            attn += per_fwd

    # ---- HBM bytes per device -------------------------------------------------
    dt = 2  # bf16
    P_dev = P_total * dt / n_chips if cells_lib.TRAIN_KNOBS[arch][0] == "fsdp" \
        else P_total * dt / n_model  # zero1: replicated over dp
    act_dev = tokens / n_dp * cfg.d_model * dt  # one boundary act per layer
    L = cfg.n_layers
    if shape.kind == "train":
        # params read fwd+bwd+remat(+micro), grads written once, optimizer
        # state read+write (fp32 master+moments ≈ 3x params f32 sharded)
        hbm = P_dev * (4 + 1) + act_dev * L * 4 + 3 * P_total * 4 / n_chips * 2
    elif shape.kind == "prefill":
        hbm = P_dev + act_dev * L * 2 + _kv_bytes(cfg, B, S) / n_chips
    else:
        hbm = P_dev + _kv_bytes(cfg, B, S) / n_chips  # read all params + the cache
    return AnalyticCost(gemm_flops=gemm, attn_flops=attn, model_flops=model,
                        hbm_bytes_per_device=hbm,
                        notes=f"fwd_eq incl. remat; P_dev={P_dev/2**30:.2f}GiB")


def analyze_cell_v2(json_path: str, trace_path: Optional[str] = None):
    """``(Roofline, collective bytes, record)``: the analytic compute and
    memory of the cell beside its trace's collective bytes (default trace:
    the JSON's path with ``.trace.json``).  ``n_chips`` comes from the
    record when it has it (then with a model axis of 1), else by mesh."""
    with open(json_path) as f:
        rec = json.load(f)
    trace_path = trace_path or json_path.replace(".json", ".trace.json")
    with open(trace_path) as f:
        coll = collective_bytes(f.read())
    if rec.get("n_chips"):
        n_chips = int(rec["n_chips"])
        ac = analytic_cost(rec["arch"], rec["shape"], rec["mesh"], n_chips=n_chips,
                           n_model=1)
    else:
        n_chips = 512 if rec["mesh"] == "multi" else 256
        ac = analytic_cost(rec["arch"], rec["shape"], rec["mesh"])
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        flops=ac.total_flops / n_chips, hbm_bytes=ac.hbm_bytes_per_device,
        coll_bytes=float(coll["total_bytes"]), model_flops=ac.model_flops,
        n_chips=n_chips,
    ), coll, rec


def _kv_bytes(cfg, B, S) -> float:
    total = 0
    specs = list(cfg.prefix) + list(cfg.pattern) * cfg.repeats
    for s in specs:
        if s.mixer == "attn":
            total += 2 * B * S * cfg.kv_heads * cfg.hd * 2
        elif s.mixer == "mla":
            total += B * S * (cfg.mla.kv_lora + cfg.mla.rope_dim) * 2
        elif s.mixer == "mamba":
            di = cfg.mamba.expand * cfg.d_model
            total += B * di * (cfg.mamba.d_state * 4 + cfg.mamba.d_conv * 2)
        elif s.mixer in ("mlstm", "slstm"):
            total += B * cfg.n_heads * cfg.hd * cfg.hd * 4
    if cfg.enc_dec:
        total += B * cfg.enc_seq * cfg.d_model * 2
    return float(total)
