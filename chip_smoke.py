#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper, sm_90a) and the CUDA toolkit.  Phases, one
result line each:

1. build  - compile every kernel from ``src/repro_torch/kernels/csrc``;
            print the build time and the card's name and power limit.
2. check  - each CUDA kernel against its plain PyTorch version on the card,
            5 formats x widths {2, 5, 8}, ragged n, all-zero blocks,
            subnormals, +-Inf, NaN payloads and exception blocks:
            encode_fused's four outputs bit for bit, decode_reduce's f32
            output bit for bit (NaN matched as NaN).
3. main   - smollm_135m at full width, ZeRO-1 on a single-rank NCCL group,
            batch 8 x seq 512: 3 compressed steps, then 3 steps of the raw
            twin from the same weights.  Losses and final parameter bytes
            must be identical; the kernels' launch counts of the compressed
            run must equal 2 encodes and n_dp decode+reduces per step.
            Then where a compressed step's time goes: forward+backward and
            each wire phase beside its raw twin (host clock, synchronised).
4. times  - each kernel, its plain version, at the main path's shapes
            (CUDA events, median of 20 runs after warm-up), beside the
            card's memory-bandwidth bound.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``kernels`` JSON.  Any failed phase exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH, BATCH, SEQ, STEPS, SEED = "smollm_135m", 8, 512, 3, 0
WIDTHS = (2, 5, 8)
TIMED_RUNS = 20
REPLACES = {
    "encode_fused": "src/repro/kernels/encode_fused.py:45",
    "decode_reduce": "src/repro/kernels/decode_reduce.py:36",
}


def card_bandwidth(name: str) -> float:
    """Published device-memory bandwidth (bytes/s) of the named card."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM


# ---------------------------------------------------------------------------
# inputs with every hard case of the codec
# ---------------------------------------------------------------------------

def hard_input(lay, n: int, seed: int, torch, np):
    """Float tensor (n,) of format ``lay`` (CPU): gradient-like values plus
    an all-zero block, subnormals, +-Inf, NaN payloads, and blocks whose
    exponent range exceeds any width (exception blocks)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 0.02, n).astype(np.float32)).to(lay.dtype)
    bits = x.view(lay.bits_dtype).to(torch.int64) & lay.bits_mask
    m = lay.mant_bits
    exp_all = ((1 << lay.exp_bits) - 1) << m
    bits[512:1024] = 0  # all-zero block
    sub = torch.from_numpy(rng.integers(1, 1 << m, 64))
    bits[1100:1164] = sub  # subnormals: exponent 0, mantissa != 0
    bits[1200:1232] = sub[:32] | (1 << (lay.total_bits - 1))  # negative subnormals
    if lay.name == "float8_e4m3fn":  # no infinities; one NaN pattern per sign
        bits[1300] = exp_all | ((1 << m) - 1)
        bits[1301] = bits[1300] | (1 << 7)
    else:
        bits[1300] = exp_all  # +Inf
        bits[1301] = exp_all | (1 << (lay.total_bits - 1))  # -Inf
        bits[1302:1310] = exp_all | torch.from_numpy(rng.integers(1, 1 << m, 8))
    for j in range(3, n // 512, 7):  # exception blocks: widest exponent range
        bits[j * 512] = 1 << m  # smallest normal
        bits[j * 512 + 1] = ((1 << lay.exp_bits) - 2) << m  # largest finite exponent
    return (bits & lay.bits_mask).to(lay.bits_dtype).view(lay.dtype)


def same_f32(a, b, torch) -> tuple:
    """(bit-identical with NaN as NaN, max abs error over the rest)."""
    nan = torch.isnan(a) & torch.isnan(b)
    same = (a.view(torch.int32) == b.view(torch.int32)) | nan
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return bool(same.all()), float(diff.max()) if diff.numel() else 0.0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(kernels, torch):
    t0 = time.perf_counter()
    secs = kernels.build_kernels()
    wall = time.perf_counter() - t0
    print(f"build: {wall:.1f} s wall " + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return smi


def phase_check(dev, torch, np):
    from repro_torch.core import codec, packing
    from repro_torch.kernels import decode_reduce as dr
    from repro_torch.kernels import encode_fused as ef
    from repro_torch.kernels import ops, ref

    n = 512 * 37 + 123  # ragged: padded to the block multiple by the caller
    worst = {"encode_fused": 0.0, "decode_reduce": 0.0}
    n_exc = 0
    for fi, lay in enumerate(codec.LAYOUTS.values()):
        xc = hard_input(lay, n, 100 + fi, torch, np)
        xp = ops._pad_edge(xc, lay, -(-n // 512) * 512).to(dev)
        for width in WIDTHS:
            got = ef.encode_fused(xp, width, 512)
            want = ref.encode_fused(xp, width, 512)
            names = ("payload", "lo", "bases", "rng")
            for k, g, w in zip(names, got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"encode_fused {lay.name} w={width}: {k} differs")
            n_exc += int((packing._as_u32(got[3]) > (1 << width) - 1).sum())
            pay, lo, bases, _ = got
            gb = bases.repeat_interleave(512 // packing.GROUP)
            acc = torch.from_numpy(np.random.default_rng(fi).normal(
                0, 1, xp.shape[0]).astype(np.float32)).to(dev)
            acc[:16] = torch.tensor([1e-45, -1e-40, 0.0, -0.0, float("inf"),
                                     float("-inf"), float("nan")] + [3e-39] * 9)
            want_acc = ref.decode_reduce(pay, lo, gb, acc, lay.name, width)
            got_acc = dr.decode_reduce(pay, lo, gb, acc.clone(), lay.name, width)
            torch.cuda.synchronize()
            ok, err = same_f32(got_acc, want_acc, torch)
            if not ok:
                raise AssertionError(f"decode_reduce {lay.name} w={width}: "
                                     f"not bit-identical (max abs err {err})")
            # the plain version on the card agrees with itself on the CPU
            cpu = ref.decode_reduce(pay.cpu(), lo.cpu(), gb.cpu(), acc.cpu(),
                                    lay.name, width)
            if not same_f32(cpu, want_acc.cpu(), torch)[0]:
                raise AssertionError(f"plain decode_reduce {lay.name}: card != CPU")
            worst["decode_reduce"] = max(worst["decode_reduce"], err)
    print(f"check: encode_fused and decode_reduce bit-identical to their plain "
          f"versions over {len(codec.LAYOUTS)} formats x widths {WIDTHS}, "
          f"n={n} (ragged), {n_exc} exception blocks")
    return worst


def phase_main(dev, torch):
    from repro_torch import kernels
    from repro_torch.launch import train as launch_train

    runs = {}
    with launch_train.single_process_group(dev) as group:
        n_dp = torch.distributed.get_world_size(group)
        for compress in (True, False):
            kernels.clear_launch_counts()
            runs[compress] = launch_train.train(
                ARCH, steps=STEPS, batch=BATCH, seq=SEQ, compress=compress,
                device=dev, seed=SEED, group=group)
            runs[compress].launches = kernels.launch_counts()
        comp, raw = runs[True], runs[False]
        if comp.losses != raw.losses:
            raise AssertionError(f"loss curves differ: {comp.losses} vs {raw.losses}")
        for a, b in zip(comp.state.model.leaves(), raw.state.model.leaves()):
            if not torch.equal(a.detach().view(torch.int16), b.detach().view(torch.int16)):
                raise AssertionError("final parameters differ between the twins")
        for s in comp.losses:
            if s != s or s in (float("inf"), float("-inf")):
                raise AssertionError(f"non-finite loss {comp.losses}")
        n_buckets = len(comp.state.meta.dtype_names)
        expect = {"encode_fused": 2 * STEPS * n_buckets,
                  "decode_reduce": STEPS * n_buckets * n_dp}
        if comp.launches != expect or any(raw.launches.values()):
            raise AssertionError(f"launch counts {comp.launches} (raw twin "
                                 f"{raw.launches}), expected {expect}")
        rs = [r for r in comp.wire_reports if r.name == "reduce_scatter"]
        ag = [r for r in comp.wire_reports if r.name == "all_gather"]
        ratio = lambda rr: sum(r.wire_bytes for r in rr) / sum(r.raw_bytes for r in rr)  # noqa: E731
        print(f"main: {ARCH} full width, ZeRO-1 n_dp={n_dp}, batch {BATCH} x seq {SEQ}, "
              f"bucket n={comp.state.meta.padded[0]}")
        print(f"  compressed losses {comp.losses} step_ms "
              f"{[round(t, 1) for t in comp.step_ms]} retries {comp.retries}")
        print(f"  raw twin   losses {raw.losses} step_ms {[round(t, 1) for t in raw.step_ms]}")
        print(f"  wire ratio RS {ratio(rs):.4f} AG {ratio(ag):.4f}; launches {comp.launches}; "
              f"losses and final parameter bytes identical")
        phase_breakdown(comp, group, dev, torch)
    return comp, expect


def _wall_ms(fn, torch, runs=5):
    """Median host-clock ms of ``fn`` up to a device synchronise, after one
    warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def phase_breakdown(run, group, dev, torch):
    """Where a compressed step's time goes: forward+backward, then each
    wire phase of the ZeRO-1 step, compressed beside its raw twin, on the
    main path's bucket; the all-gather split into encode and (plain) decode."""
    from repro_torch.core import compressed_collectives as cc
    from repro_torch.core.policy import capture_wire_reports
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import zero1
    from repro_torch.train import step as step_lib

    state, tcfg = run.state, run.tcfg
    leaves = state.model.leaves()
    batch = DataPipeline(DataConfig(vocab=state.model.cfg.vocab, global_batch=BATCH,
                                    seq_len=SEQ, seed=SEED)).tensors_at(0, dev)
    n_dp = torch.distributed.get_world_size(group)
    pol, prof = tcfg.policy, tcfg.policy.profile
    w_rs = pol.width_for("gradient")
    w_ag = min(pol.width_for("weight") + prof.ag_extra_bits, 8)
    kw = {"block": prof.block, "exc_frac": prof.exc_frac}

    def fwd_bwd():
        for p in leaves:
            p.grad = None
        step_lib.loss_fn(state.model, batch, tcfg).backward()

    with launch_train.deterministic(), capture_wire_reports():
        ms = {"forward+backward": _wall_ms(fwd_bwd, torch)}
        (gb,) = zero1.flatten_buckets(state.meta, [p.grad for p in leaves])
        for p in leaves:
            p.grad = None
        shard = state.opt["buckets"][0]["master"].to(gb.dtype)
        wire = cc._encode_chunks(shard[None], width=w_ag, **kw)
        ms.update({
            "RS compressed": _wall_ms(
                lambda: cc.reduce_scatter_compressed(gb, group, width=w_rs, **kw), torch),
            "RS raw": _wall_ms(lambda: zero1._raw_reduce_scatter(gb, group, n_dp), torch),
            "AG compressed": _wall_ms(
                lambda: cc.all_gather_compressed(shard, group, width=w_ag, **kw), torch),
            "AG raw": _wall_ms(lambda: zero1._raw_all_gather(shard, group), torch),
            "AG encode": _wall_ms(
                lambda: cc._encode_chunks(shard[None], width=w_ag, **kw), torch),
            "AG decode (plain)": _wall_ms(lambda: cc._decode_chunks(
                wire, dtype=shard.dtype, n=shard.shape[0], width=w_ag,
                block=prof.block), torch),
        })
    print("  breakdown, ms (median of 5): "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    return ms


def _time(fn, torch, runs=TIMED_RUNS):
    """Median ms of ``runs`` launches of ``fn`` after two warm-ups."""
    fn(), fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def phase_times(comp, dev, torch, np, expect, worst, bw):
    from repro_torch.core import codec, packing
    from repro_torch.core.calibrate import CompressionProfile
    from repro_torch.kernels import decode_reduce as dr
    from repro_torch.kernels import encode_fused as ef
    from repro_torch.kernels import ref
    from repro_torch.optim import zero1

    # the main path's AG input: the trained bf16 parameter bucket, width 5
    meta = comp.state.meta
    x = zero1.flatten_buckets(meta, comp.state.model.leaves())[0].contiguous()
    n, block = x.shape[0], meta.block
    width = CompressionProfile.default().width_for("weight")
    lo_bits = codec.layout_of(x.dtype).lo_bits
    got = ef.encode_fused(x, width, block)
    want = ref.encode_fused(x, width, block)
    enc_err = max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
    if enc_err:
        raise AssertionError("encode_fused differs from plain at the main path shape")
    del want
    pay, lo, bases, _ = got
    gb = bases.repeat_interleave(block // packing.GROUP)
    acc = torch.from_numpy(np.random.default_rng(1).normal(0, 1e-3, n).astype(
        np.float32)).to(dev)
    ok, dec_err = same_f32(dr.decode_reduce(pay, lo, gb, acc.clone(), "bfloat16", width),
                           ref.decode_reduce(pay, lo, gb, acc, "bfloat16", width), torch)
    if not ok:
        raise AssertionError("decode_reduce differs from plain at the main path shape")
    work = acc.clone()
    rows = []
    specs = {
        "encode_fused": (lambda: ef.encode_fused(x, width, block),
                         lambda: ref.encode_fused(x, width, block),
                         n * 2 + n // 32 * (width + lo_bits) * 4 + n // block * 8,
                         0, enc_err),
        "decode_reduce": (lambda: dr.decode_reduce(pay, lo, gb, work, "bfloat16", width),
                          lambda: ref.decode_reduce(pay, lo, gb, acc, "bfloat16", width),
                          n // 32 * (width + lo_bits + 1) * 4 + n * 8,
                          n, max(dec_err, worst["decode_reduce"])),
    }
    for name, (kern, plain, nbytes, flops, err) in specs.items():
        ms = _time(kern, torch)
        plain_ms = _time(plain, torch)
        bytes_ms = nbytes / bw * 1e3
        ops_ms = flops / 67e12 * 1e3  # f32 adds at the card's non-tensor f32 peak
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": comp.launches[name],
            "launches_per_step": expect[name] // STEPS,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "n": n, "width": width, "dtype": "bfloat16",
        })
        print(f"times: {name} n={n} w={width}: {ms:.4f} ms (plain {plain_ms:.3f} ms), "
              f"bound {max(bytes_ms, ops_ms):.4f} ms = {nbytes / 1e6:.1f} MB at "
              f"{bw / 1e12:.2f} TB/s")
    return rows


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA GPU", file=sys.stderr)
        return 1
    try:
        from repro_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "repository root", file=sys.stderr)
        return 1
    dev = kernels.resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = phase_build(kernels, torch)
    worst = phase_check(dev, torch, np)
    comp, expect = phase_main(dev, torch)
    rows = phase_times(comp, dev, torch, np, expect, worst, card_bandwidth(name))
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
