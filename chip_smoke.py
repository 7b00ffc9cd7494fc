#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper, sm_90a) and the CUDA toolkit.  Phases, one
result line each:

1. build  - compile every kernel source in ``src/repro_torch/kernels/csrc``
            (one nvcc each, all at once); print the build time and the
            card's name and power limit.
2. check  - each CUDA kernel against its plain PyTorch version on the card:
            encode_fused and decode_reduce over 5 formats x widths {2, 5, 8}
            (ragged n, all-zero blocks, subnormals, +-Inf, NaN payloads,
            exception blocks; decode_reduce's f32 output with NaN as NaN);
            encode_fused and the unpack of its two planes at the tile edges
            of their persistent kernels: 5 formats x widths 1, 2, 5, 8, 9,
            31, 32 (both template routes) x blocks 32, 512, 1024 x block
            counts 1, T - 1, T, T + 1 and (grid + 1) T + 1 (T blocks a
            tile, grid thread blocks resident), with all-zero blocks, a
            block of one nonzero exponent, exception blocks, +-Inf, NaN
            payloads and subnormals;
            decode_reduce at the tile edges of its persistent kernel: 5
            formats x widths 1, 2, 5, 8, 9, 31, 32 x the group counts
            below, on edge_input encoded in blocks of 32 (exception groups
            whose clamped codes decode to `& 0xFF` garbage) into an
            accumulator holding subnormals, +-0, +-inf and NaN;
            the entry points on views one element and 8 bytes off a 16-byte
            boundary (ops.encode_fused, packing.encode_message,
            packing.bitplane_unpack, packing.bitplane_pack,
            ops.decode_reduce with every tensor off): each launches its
            kernel once and matches the plain version;
            pack and unpack at widths 1-32 on ragged group counts, all-zero
            and all-ones groups and int32 values with the sign bit set;
            unpack, and pack over uint8, int32 (sign bit set) and int64
            (above 2**32) input, also at the edges of their own tiles at
            every width (32 groups for small counts, T once each resident
            thread block takes two: 1, 31, 32, 33, 2 R T - 1, 2 R T + 1,
            (2 R + 1) T + 1 groups, R thread blocks resident);
            rANS encode and decode on skewed, uniform and one-symbol streams,
            a table whose top frequency is M - 255, n_valid < per * lanes,
            and the compacted-stream decode of an ``ans.encode`` stream, at
            per in {1, R - 1, R, R + 1, 3R + 17} (R = 248, the kernels'
            tile rows) x 128 lanes and at per R + 1 x 256 lanes;
            plane_split over 5 formats on the same hard inputs as
            encode_fused.  All bit for bit.
3. serve  - smollm_135m at full width and depth, random weights from seed 0:
            8 greedy requests of 512 prompt tokens (numpy seed 0), 32 new
            tokens each, 4 slots, max_len 1024, prefill_chunk 512, first
            colocated, then PD-disaggregated (CompressionPolicy(min_bytes=0),
            a fresh PlanCache).  The tokens must be identical and the plan
            cache must show 1 miss and 7 hits.  Launches of the PD run: each
            admission ships one cache whose two bf16 leaves (k, v) each pack
            twice (the lo plane, the exponent residuals) and unpack twice on
            the decode side, so pack = unpack = 4 per admission, 32 in all;
            no other kernel launches (the colocated run launches none).  Then
            the first 2 requests, colocated and PD-disaggregated with the
            engine's rANS codec (kv_codec="rans", a fresh PlanCache: 1 miss,
            1 hit): identical tokens; each admission's two leaves each pack
            and unpack their lo plane once and run rans_encode and
            rans_decode once on their exponent plane, so every one of the
            four kernels launches 2 x 2 = 4 times.  Then one admitted
            request's prefilled cache crosses the host wire with each codec
            (pack_cache, unpack_cache): every leaf bit-identical and a
            32-token greedy decode from it identical.  Prints tokens/s of
            each run, pack and unpack ms per shipment, each codec's wire
            ratio, and the ms of one admission's prefill and of one batched
            decode step.
4. main   - smollm_135m at full width, ZeRO-1 on a single-rank NCCL group,
            batch 8 x seq 512: 3 compressed steps, then 3 steps of the raw
            twin from the same weights, each run replaying its zero1 plan
            (1 miss, then 2 hits in the run's plan cache; one consolidated
            plan:zero1 WireReport a compressed step, of the plan's bytes).
            Losses and final parameter bytes must be identical; per
            compressed step the launches must be 2 encodes, n_dp
            decode+reduces and n_dp + 2 unpacks (the reduce-scatter's
            exception patch per received chunk, the all-gather decode's
            payload and lo planes); the raw twin launches nothing.  Each
            run goes through the launcher's StepRunner; the compressed one
            writes a heartbeat a step and one asynchronous checkpoint of
            the ZeRO-1 state after its last step, which try_resume restores
            on the card bit-identical, and one more step from it gives the
            loss and bits of the same step from a copy of the live state
            (save and restore ms).  Then
            where a compressed step's time goes: forward+backward and each
            wire phase beside its raw twin (host clock, synchronised).
   psum   - on the same group, the gradient pytree of one forward+backward
            of the trained model at batch 8 x 512 through psum_with_plan
            with the default policy (its one bf16 bucket on the two-shot,
            fused both ways), with fused_encode=False, with
            fused_decode_reduce=False and with CompressionPolicy.disabled()
            (the raw two-shot), then the first again: each result
            bit-identical to the gradients (the sum of one rank), flag 0;
            one plan compiled a policy, the repeat a hit; one consolidated
            plan:psum report a compressed run, the same bytes in each.
            Launches a compressed run (two_shot_launches): encode_fused 2,
            decode_reduce 1, unpack 3; unfused encode: pack 4 (the lo plane
            and the exponent residuals of the RS row and of the AG row)
            and no encode_fused; unfused decode: unpack 4 and no
            decode_reduce; the raw twin none.  Then at one rank
            psum_compressed_hierarchical of the bucket (the group as both
            levels: encode_fused 4, decode_reduce 2, unpack 6),
            all_to_all_compressed of the final hidden states as (1, 8 x
            512 x 576) bf16 and ppermute_compressed of the embedding
            (49152 x 576 bf16; each encode_fused 1, unpack 2): each
            bit-identical to its input.  The ring makes no hop at one rank.
            The unfused encode's wire must equal the fused one's field by
            field at the plan's widths.  Prints each policy's ms (host
            clock to a device sync, median of 5), the wire ratio, and the
            card's name and power limit.
5. sync   - RL weight sync of smollm_135m at full width and depth
            (``launch/rl_weight_sync.run``): the ZeRO-1 trainer of the main
            phase (compressed, lr 1e-5, warm-up 3), 3 warm-up steps,
            delta-width calibration on one 2-step cadence, then 3
            iterations of 2 steps, a publish and one update per replica
            from a WeightSyncEngine with a fresh PlanCache; "rollout-0" is
            a ServeEngine (4 slots, max_len 1024) that ingests every update,
            "rollout-1" a plain tree that joins at iteration 1; then the
            epoch fence and one more publish.  Every reconstruction must be
            bit-identical to the trainer's weights, the update modes full,
            delta, delta (rollout-0) and full, delta (rollout-1), then full
            after the fence, the plan cache 1 miss and 4 hits, and
            rollout-0's greedy tokens for 2 requests (512 + 32 tokens) those
            of a fresh engine on the trainer's weights.  Launches of the
            sync sections: a full update runs encode_fused once and its
            apply unpack twice (lo plane, exponent payload); a delta runs
            pack twice (exponent-delta residuals, lo-delta plane) and its
            apply unpack twice; the iteration-2 delta is encoded once for
            both replicas (same base).  So encode_fused 3, pack 4, unpack
            12 over 4 publishes, and the whole run's counts are those plus
            11 compressed train steps.  Prints each update's mode, wire
            bytes, ratio and widths, and the ms of each part of a delta and
            of a full update (encode on the card, device-to-host copy,
            update_checksum, verify_update, apply = host-to-device copy and
            decode, in-place copy into the serve engine's model).
6. fleet  - the weight-sync fleet (sync/fleet.SyncFleet) at full width:
            the sync phase's retained versions (v1-v4; one bf16 bucket of
            134 515 200 values) published to 6 replicas r0-r5 whose weights
            live on the card, each fleet a fresh WeightSyncEngine with the
            sync run's policy over one shared PlanCache.  (a) star, tree
            (fanout 2) and pipeline: each version published, then settle():
            bit-exact in one round, one encode a publish, trainer egress
            root_degree x the update's wire bytes (6, 2 and 1 copies),
            forwards n_edges - root_degree and hop depth the schedule's (1,
            2 and 6); one plan compile a schedule triple (3 misses: the
            plan without schedule, tree and pipeline).  (b) the tree under
            FaultPlan.generate (seed 7, 10 rounds, drop, corrupt and delay
            rates 0.1, delays up to 2 rounds, a kill, a join and a trainer
            restart from a checkpoint in a temporary directory), a version
            published at every third round, then settle(max_rounds=80):
            bit-exact, no silent corruption, injected == seen + lost, no
            quarantine, max_link_failures <= max_retries.  (c)
            execute_wsync_broadcast and broadcast_weights of a pipeline of
            3 over ranks (0, 0, 0, 0) on a one-rank NCCL group (each level a
            self-send), full and as a delta against the previous version:
            bit-identical with flag 0, the twins equal.  Launches derived in
            fleet_launches from what the fleet did (a full encode
            encode_fused 1, a delta tried pack 2, an applied bucket unpack
            2, a raw one none) plus p2p_launches of each in-mesh level.
            Prints each wave's mode, wire and egress bytes, rounds and
            settle ms (host clock to a device sync), the chaos run's rounds,
            ms, ledger, stats and trace events, and the in-mesh ms.
7. p2p    - Uzip-P2P in the mesh (core/split_send and the p2p, kv and
            wsync plans), on a one-rank NCCL group with perm [(0, 0)]: the
            serve phase's prefilled cache (two (30, 1, 1024, 3, 64) bf16
            leaves, one bucket of 11 796 480, and the 0-d position leaf,
            raw) through transfer_cache_with_plan under split_send,
            encode_send and chunked (CompressionPolicy(), one PlanCache: 3
            misses, then only hits on the timing repeats) and gated off;
            every leaf bit-identical to the cache, one plan:kv report a run
            whose bytes and ratio are the plan's.  The psum phase's gradient
            bucket (134 515 008 bf16, padded to 134 515 200) through
            p2p_send_with_plan under each strategy and gated off,
            bit-identical; then as a reducing receiver into a seeded f32
            accumulator, fused and unfused, each bit-identical to
            acc + grad.float().  The sync phase's last two weight versions
            through sync_weights_with_plan at its calibrated delta widths:
            full, then a delta against the older one (a set flag takes the
            full retry), each bit-identical to the newer version.  Launches
            of each run as derived in p2p_launches: split_send pack 2 and
            unpack 2 (a fused reducing receiver: decode_reduce 1 and unpack
            1), encode_send encode_fused 1 and unpack 2, chunked that a
            chunk (4 chunks at both buckets), a delta pack 2 and unpack 2;
            gated off none.  Prints each strategy's ms beside its raw twin
            (host clock to a device sync, median of 5; at one rank the wire
            is NCCL's copy to itself, so the times are the codec's
            schedule, not a network's).
8. obs    - one observability window at full width (obs.reset() inside
            one capture_wire_reports()): a compressed train step through a
            new launcher's StepRunner, psum_with_plan of the psum phase's
            gradient bucket, a weight-sync publish and delta update of the
            sync phase's last two versions, one PD serve admission (a packed
            KV shipment) on the trained model, a tree wave (fanout 2) to 6
            replicas; each result checked, the launches derived (encode_fused
            5, decode_reduce 2, pack 6, unpack 24 for a delta update),
            check_ledger_exactness ok, the plan totals equal to
            summarize_wire_reports, the Chrome trace exported and parsed
            back; then the cost of observability: the train step and the
            weight-sync update with obs off and on, alternating, median of 3,
            and the calls alone.  Prints one {"obs": ...} line.
9. times  - each kernel and its plain version at the shapes its path
            gives it: encode_fused, decode_reduce and plane_split at the
            AG bucket, pack and unpack at one KV leaf (the row's ms), and
            encode_fused, decode_reduce, pack and unpack also at every
            shape any run of phases 3-8 launched them at (``shapes``): each
            run's first input of each shape, which recorded_inputs keeps,
            is held against the plain version, and every launch a run
            tallied must be at a recorded shape; each shape is timed once,
            with its launches by run; rANS at one KV leaf's exponent
            plane.  CUDA events, median of 20 runs after
            warm-up; the plain rANS versions, one torch step per row, once), beside the
            least time the card could take (bytes over its memory bandwidth
            or operations over its peak rate, the larger).  The two rANS
            kernels also get floor_ms, the least time their fixed 128 lanes
            allow: per x the SM cycles of one step of one lane's chain
            alone (rans.chain, the kernel's own step in one thread, first
            held to its plain version; cycles counted on the card by
            clock64 over per steps, median of 5) at the SM clock nvidia-smi
            reads while the kernels run; and tables_ms, the wrapper's table
            ops, which ms includes.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``kernels`` JSON.  Any failed phase exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH, BATCH, SEQ, STEPS, SEED = "smollm_135m", 8, 512, 3, 0
# serve phase: requests, prompt tokens, new tokens, slots, cache length;
# requests of the PD run with the rANS codec
N_REQ, PROMPT, MAX_NEW, SLOTS, MAX_LEN = 8, 512, 32, 4, 1024
N_RANS = 2
WIDTHS = (2, 5, 8)
TIMED_RUNS = 20
REPLACES = {
    "encode_fused": "src/repro/kernels/encode_fused.py:45",
    "decode_reduce": "src/repro/kernels/decode_reduce.py:36",
    "pack": "src/repro/kernels/bitpack.py:28",
    "unpack": "src/repro/kernels/bitpack.py:40",
    "rans_encode": "src/repro/kernels/rans.py:43",
    "rans_decode": "src/repro/kernels/rans.py:68",
    "plane_split": "src/repro/kernels/plane_split.py:34",
}
N_SYNC_REQ = 2  # requests rollout-0 serves after its last delta


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


def edge_input(lay, nb: int, block: int, seed: int, torch, np):
    """Float tensor (nb * block,) of format ``lay`` (CPU) for the kernels'
    tile edges, at any block count: gradient-like values; block 0 an
    exception block (the smallest normal beside the largest finite
    exponent) that also holds +-Inf, NaN payloads and subnormals; block 1
    all zero; block 2 one nonzero exponent; every 7th block from 3 an
    exception block."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 0.02, nb * block).astype(np.float32)).to(lay.dtype)
    bits = x.view(lay.bits_dtype).to(torch.int64) & lay.bits_mask
    m, sign = lay.mant_bits, 1 << (lay.total_bits - 1)
    exp_all = ((1 << lay.exp_bits) - 1) << m
    widest = ((1 << lay.exp_bits) - 2) << m
    bits[0], bits[1] = 1 << m, widest
    if lay.name == "float8_e4m3fn":  # no infinities; one NaN pattern per sign
        bits[2] = exp_all | ((1 << m) - 1)
        bits[3] = bits[2] | sign
    else:
        bits[2], bits[3] = exp_all, exp_all | sign  # +-Inf
        bits[4], bits[5] = exp_all | 1, exp_all | sign | ((1 << m) - 1)  # NaN payloads
    bits[6], bits[7] = 1, sign | ((1 << m) - 1)  # subnormals
    bits[block:3 * block] = 0  # all-zero block 1; block 2 gets one nonzero exponent
    if nb > 2:
        bits[2 * block + 5] = (3 << m) | 1
    bits[3 * block::7 * block] = 1 << m
    bits[3 * block + 1::7 * block] = widest
    return (bits & lay.bits_mask).to(lay.bits_dtype).view(lay.dtype)


EDGE_WIDTHS = (1, 2, 5, 8, 9, 31, 32)  # both routes of csrc/encode_fused.cu
EDGE_BLOCKS = (32, 512, 1024)


def edge_counts(tile: int, full: int) -> tuple:
    """Counts (blocks or groups) on both sides of a tile of ``tile`` and
    past a persistent grid of ``full`` thread blocks, one tile each."""
    return (1, tile - 1, tile, tile + 1, (full + 1) * tile + 1)


def tile_edge_counts(big, threads: int, sms: int) -> tuple:
    """Group counts at the tile edges of a persistent bit-plane kernel
    (unpack, pack, decode_reduce) whose geometry at a huge count is ``big``:
    its tiles are 32 groups for small counts and grow to ``T = big.tile``
    (its largest) once each of the ``full`` resident thread blocks gets two;
    so 1, 31, 32, 33, then 2 full T - 1 (smaller tiles, ragged), 2 full T + 1
    and (2 full + 1) T + 1 (tiles of T, past the grid)."""
    from repro_torch import kernels

    t, full = big.tile, sms * kernels.resident_blocks(threads, big.smem)
    return (1, 31, 32, 33, 2 * full * t - 1, 2 * full * t + 1, (2 * full + 1) * t + 1)


def unpack_edge_counts(width: int, sms: int) -> tuple:
    from repro_torch.kernels import bitpack

    return tile_edge_counts(bitpack.unpack_geometry(1 << 40, width, sms),
                            bitpack.UNPACK_THREADS, sms)


def pack_edge_counts(width: int, itemsize: int, sms: int) -> tuple:
    from repro_torch.kernels import bitpack

    return tile_edge_counts(bitpack.pack_geometry(1 << 40, width, itemsize, sms),
                            bitpack.PACK_THREADS, sms)


def decode_reduce_edge_counts(width: int, lo_bits: int, sms: int) -> tuple:
    from repro_torch.kernels import decode_reduce as dr

    return tile_edge_counts(dr.geometry(1 << 40, width, lo_bits, sms), dr.THREADS, sms)


# f32 accumulator values the decode_reduce checks plant: subnormals, +-0,
# +-inf, NaN
ACC_SPECIALS = (1e-45, -1e-40, 0.0, -0.0, float("inf"), float("-inf"), float("nan"), 3e-39)


def special_acc(n: int, seed: int, torch, np):
    """f32 (n,) accumulator (CPU): normal values with ACC_SPECIALS at the
    start, at the end and every 997th element."""
    acc = torch.from_numpy(np.random.default_rng(seed).normal(0, 1, n).astype(np.float32))
    sp = torch.tensor(ACC_SPECIALS, dtype=torch.float32)
    k = len(ACC_SPECIALS)
    acc[:min(k, n)] = sp[:min(k, n)]
    acc[-min(k, n):] = sp[:min(k, n)]
    idx = torch.arange(0, n, 997)
    acc[idx] = sp[idx % k]
    return acc


def check_decode_reduce_edges(dev, torch, np) -> dict:
    """decode_reduce against its plain version, bit for bit with NaN as NaN,
    over 5 formats x widths EDGE_WIDTHS x group counts at its own tile edges
    and past its grid (``decode_reduce_edge_counts``); the wire is
    ``edge_input`` encoded in blocks of 32 (one group a block: all-zero
    groups, exception blocks whose clamped codes decode to `& 0xFF`
    garbage, +-Inf, NaN payloads, subnormals), the accumulator
    ``special_acc``."""
    from repro_torch import kernels
    from repro_torch.core import codec, packing
    from repro_torch.kernels import decode_reduce as dr
    from repro_torch.kernels import ref

    sms = kernels.sm_count(dev)
    before = kernels.launch_counts()["decode_reduce"]
    n_cases = n_exc = 0
    for fi, lay in enumerate(codec.LAYOUTS.values()):
        for width in EDGE_WIDTHS:
            counts = decode_reduce_edge_counts(width, lay.lo_bits, sms)
            x = edge_input(lay, max(counts), packing.GROUP, 400 + fi, torch, np).to(dev)
            pay_all, lo_all, gb_all, rng = ref.encode_fused(x, width, packing.GROUP)
            acc_all = special_acc(x.shape[0], 500 + fi, torch, np).to(dev)
            for n_g in counts:
                pay, lo, gb = pay_all[:n_g], lo_all[:n_g], gb_all[:n_g]
                acc = acc_all[:packing.GROUP * n_g]
                want = ref.decode_reduce(pay, lo, gb, acc, lay.name, width)
                got = dr.decode_reduce(pay, lo, gb, acc.clone(), lay.name, width)
                ok, err = same_f32(got, want, torch)
                if not ok:
                    raise AssertionError(
                        f"decode_reduce {lay.name} w={width} n_g={n_g}: not bit-identical "
                        f"(max abs err {err}; {dr.geometry(n_g, width, lay.lo_bits, sms)})")
                n_exc += int((packing._as_u32(rng[:n_g]) > (1 << width) - 1).sum())
                n_cases += 1
    if kernels.launch_counts()["decode_reduce"] - before != n_cases:
        raise AssertionError("decode_reduce edge check: one launch a case expected")
    return {"cases": n_cases, "exception_groups": n_exc}


def pack_edge_values(n: int, seed: int, torch, np) -> dict:
    """(n,) pack inputs of each kind the kernel takes (CPU), from the same
    random 64-bit values: int64 (negative and above 2**32), int32 (sign bit
    set) and uint8 (their low bits); group 1 all zero, group 2 all ones."""
    v = np.random.default_rng(seed).integers(0, 1 << 64, n, dtype=np.uint64)
    v[32:64], v[64:96] = 0, (1 << 64) - 1
    return {torch.int64: torch.from_numpy(v.view(np.int64)),
            torch.int32: torch.from_numpy(v.astype(np.uint32).view(np.int32)),
            torch.uint8: torch.from_numpy(v.astype(np.uint8))}


def check_pack_edges(dev, torch, np) -> int:
    """pack against its plain version, bit for bit, over uint8, int32 and
    int64 input x widths 1-32 x group counts at its own tile edges and past
    its grid (``pack_edge_counts``), with all-zero and all-ones groups."""
    from repro_torch import kernels
    from repro_torch.kernels import bitpack, ref

    sms = kernels.sm_count(dev)
    counts = {(dt, w): pack_edge_counts(w, dt.itemsize, sms)
              for dt in (torch.uint8, torch.int32, torch.int64) for w in range(1, 33)}
    most = max(max(c) for c in counts.values())
    inputs = pack_edge_values(32 * most, 12, torch, np)
    before = kernels.launch_counts()["pack"]
    n_cases = 0
    for dt, vals_cpu in inputs.items():
        vals_all = vals_cpu[:32 * max(max(counts[(dt, w)]) for w in range(1, 33))].to(dev)
        for width in range(1, 33):
            for n_g in counts[(dt, width)]:
                vals = vals_all[:32 * n_g]
                if not torch.equal(bitpack.pack(vals, width), ref.pack(vals, width)):
                    raise AssertionError(f"pack {dt} w={width} n_g={n_g} differs "
                                         f"({bitpack.pack_geometry(n_g, width, dt.itemsize, sms)})")
                n_cases += 1
    if kernels.launch_counts()["pack"] - before != n_cases:
        raise AssertionError("pack edge check: one launch a case expected")
    return n_cases


def offset_view(src, off_bytes: int, dev, torch):
    """A copy of ``src`` on ``dev``, as a view that starts ``off_bytes`` past
    a 16-byte boundary of a larger buffer; returns (view, buffer)."""
    off = off_bytes // src.element_size()
    buf = torch.zeros(src.numel() + 16, dtype=src.dtype, device=dev)
    view = buf[off:off + src.numel()].view(src.shape)
    view.copy_(src)
    if view.data_ptr() % 16 != off_bytes % 16:
        raise AssertionError(f"offset view at {view.data_ptr():#x}, not {off_bytes} B off")
    return view, buf


def check_offset_views(dev, torch, np) -> int:
    """The entry points above the kernel wrappers take contiguous views that
    start one element, and 8 bytes, off a 16-byte boundary (every tensor
    argument, decode_reduce's accumulator too): ops.encode_fused,
    packing.encode_message, packing.bitplane_unpack, packing.bitplane_pack
    (uint8 and int32) and ops.decode_reduce.  Each result is bit-identical
    to the plain version on the same values, each call launches its kernel
    once, and decode_reduce updates the caller's accumulator in place."""
    from repro_torch import kernels
    from repro_torch.core import codec, packing
    from repro_torch.kernels import ops, ref

    lay = codec.LAYOUTS["bfloat16"]
    width, n = 5, 2048
    x = edge_input(lay, n // 512, 512, 300, torch, np)
    rng = np.random.default_rng(301)
    words = torch.from_numpy(rng.integers(0, 1 << 32, (n // 32, width), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    vals = pack_edge_values(n, 302, torch, np)
    ref_wire = ref.encode_fused(x, width, 512)
    gb = ref_wire[2].repeat_interleave(512 // packing.GROUP)
    acc0 = special_acc(n, 303, torch, np)
    want_acc = ref.decode_reduce(ref_wire[0], ref_wire[1], gb, acc0, lay.name, width)
    calls = []

    def launched(name, fn):  # one entry-point call: its kernel launches once
        before = kernels.launch_counts()[name]
        out = fn()
        if kernels.launch_counts()[name] - before != 1:
            raise AssertionError(f"{name}: an offset view must launch the kernel once")
        calls.append(name)
        return out

    for off_name in ("one element", "8 bytes"):
        def view(t, whole=False):
            v, buf = offset_view(t, t.element_size() if off_name == "one element" else 8,
                                 dev, torch)
            return (v, buf) if whole else v

        xv = view(x)
        got = launched("encode_fused", lambda: ops.encode_fused(xv, width))
        want = ops.encode_fused(x, width)
        m = launched("encode_fused", lambda: packing.encode_message(xv, width=width))
        mc = packing.encode_message(x, width=width)
        fields = {**{k: (got[k], want[k]) for k in want},
                  "message lo": (m.lo, mc.lo), "message payload": (m.exp.payload, mc.exp.payload),
                  "message bases": (m.exp.bases, mc.exp.bases),
                  "message exc_raw": (m.exp.exc_raw, mc.exp.exc_raw)}
        wv = view(words)
        fields["bitplane_unpack"] = (
            launched("unpack", lambda: packing.bitplane_unpack(wv, width)), ref.unpack(words, width))
        for dt in (torch.uint8, torch.int32):
            vv = view(vals[dt])
            fields[f"bitplane_pack {dt}"] = (
                launched("pack", lambda: packing.bitplane_pack(vv, width)), ref.pack(vals[dt], width))
        for k, (g, w) in fields.items():
            if not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f"{k} of a view {off_name} off a 16-byte boundary "
                                     f"differs from the plain version")
        planes = [view(t) for t in (*ref_wire[:2], gb)]
        acc, buf = view(acc0, whole=True)
        outside = buf.clone()
        out = launched("decode_reduce", lambda: ops.decode_reduce(*planes, acc, lay.name, width))
        if out is not acc or not same_f32(acc.cpu(), want_acc, torch)[0]:
            raise AssertionError(f"ops.decode_reduce of views {off_name} off: the accumulator "
                                 f"is not updated in place as the plain version")
        off = acc.storage_offset()
        outside[off:off + n] = acc
        if not torch.equal(buf.view(torch.int32), outside.view(torch.int32)):
            raise AssertionError("ops.decode_reduce wrote outside the accumulator's view")
    return len(calls)


def check_encode_edges(dev, torch, np) -> dict:
    """encode_fused (and unpack of its payload and lo planes) against the
    plain versions, bit for bit, over 5 formats x widths EDGE_WIDTHS x
    blocks EDGE_BLOCKS at the tile edges of each geometry."""
    from repro_torch import kernels
    from repro_torch.core import codec, packing
    from repro_torch.kernels import bitpack, ref
    from repro_torch.kernels import encode_fused as ef

    sms = kernels.sm_count(dev)
    before = kernels.launch_counts()
    n_cases = n_exc = 0
    for fi, lay in enumerate(codec.LAYOUTS.values()):
        for block in EDGE_BLOCKS:
            geos = {w: ef.geometry(1, block, w, lay.total_bits // 8, lay.lo_bits, sms)
                    for w in EDGE_WIDTHS}
            counts = {w: edge_counts(g.tile, sms * kernels.resident_blocks(
                g.threads, g.smem)) for w, g in geos.items()}
            x_all = edge_input(lay, max(max(c) for c in counts.values()), block,
                               200 + fi, torch, np).to(dev)
            for width in EDGE_WIDTHS:
                for nb in counts[width]:
                    x = x_all[:nb * block]
                    got = ef.encode_fused(x, width, block)
                    want = ref.encode_fused(x, width, block)
                    for k, g, w in zip(("payload", "lo", "bases", "rng"), got, want):
                        if not torch.equal(g, w):
                            raise AssertionError(f"encode_fused {lay.name} w={width} "
                                                 f"block={block} n_blocks={nb}: {k} differs "
                                                 f"({geos[width]})")
                    for words, w in ((got[0], width), (got[1], lay.lo_bits)):
                        if not torch.equal(bitpack.unpack(words, w), ref.unpack(words, w)):
                            raise AssertionError(f"unpack of encode_fused {lay.name} "
                                                 f"w={w} block={block} n_blocks={nb} differs")
                    n_exc += int((packing._as_u32(got[3]) > (1 << width) - 1).sum())
                    n_cases += 1
    launched = {k: kernels.launch_counts()[k] - before[k] for k in ("encode_fused", "unpack")}
    if launched != {"encode_fused": n_cases, "unpack": 2 * n_cases}:
        raise AssertionError(f"edge check launches {launched}, expected {n_cases} encodes "
                             f"and {2 * n_cases} unpacks")
    return {"cases": n_cases, "exception_blocks": n_exc}


def check_unpack_edges(dev, torch, np) -> int:
    """unpack against its plain version, bit for bit, at widths 1-32 and
    group counts on both sides of its tile and past its persistent grid;
    random words with an all-zero and an all-ones group."""
    from repro_torch import kernels
    from repro_torch.kernels import bitpack, ref

    sms = kernels.sm_count(dev)
    counts = {w: unpack_edge_counts(w, sms) for w in range(1, 33)}
    most = max(max(c) * w for w, c in counts.items())
    rng = np.random.default_rng(11)
    words_all = torch.from_numpy(rng.integers(0, 1 << 32, most, dtype=np.uint64)
                                 .astype(np.uint32).view(np.int32)).to(dev)
    before = kernels.launch_counts()["unpack"]
    n_cases = 0
    for width, cs in counts.items():
        for n_g in cs:
            words = words_all[:n_g * width].view(n_g, width)
            if n_g > 2:
                words[1], words[2] = 0, -1  # all-zero and all-ones groups
            if not torch.equal(bitpack.unpack(words, width), ref.unpack(words, width)):
                raise AssertionError(f"unpack w={width} n_g={n_g} differs "
                                     f"({bitpack.unpack_geometry(n_g, width, sms)})")
            n_cases += 1
    if kernels.launch_counts()["unpack"] - before != n_cases:
        raise AssertionError("unpack edge check: one launch a case expected")
    return n_cases


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
    smi = run_card()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return smi


def phase_check(dev, torch, np):
    from repro_torch.core import codec, packing
    from repro_torch.kernels import decode_reduce as dr
    from repro_torch.kernels import encode_fused as ef
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import plane_split as ps

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
        got = ps.split_with_stats(xp, 512)
        want = ref.split_with_stats(xp, 512)
        for k, g, w in zip(("exp", "lo", "base", "rng"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"plane_split {lay.name}: {k} differs")
    print(f"check: encode_fused and decode_reduce bit-identical to their plain "
          f"versions over {len(codec.LAYOUTS)} formats x widths {WIDTHS}, "
          f"n={n} (ragged), {n_exc} exception blocks; plane_split bit-identical "
          f"over {len(codec.LAYOUTS)} formats at n={xp.shape[0]}")
    edges = check_encode_edges(dev, torch, np)
    print(f"check: encode_fused and the unpack of its planes bit-identical to their "
          f"plain versions at the tile edges: {edges['cases']} cases ({len(codec.LAYOUTS)} "
          f"formats x widths {EDGE_WIDTHS} x blocks {EDGE_BLOCKS} x block counts 1, "
          f"T-1, T, T+1, (grid+1)T+1), {edges['exception_blocks']} exception blocks")
    edges = check_decode_reduce_edges(dev, torch, np)
    print(f"check: decode_reduce bit-identical to its plain version (NaN as NaN) at its "
          f"tile edges: {edges['cases']} cases ({len(codec.LAYOUTS)} formats x widths "
          f"{EDGE_WIDTHS} x group counts 1, 31, 32, 33, 2RT-1, 2RT+1, (2R+1)T+1), "
          f"{edges['exception_groups']} exception groups, accumulator with "
          f"{ACC_SPECIALS}")
    calls = check_offset_views(dev, torch, np)
    print(f"check: {calls} entry-point calls on views one element and 8 bytes off a "
          f"16-byte boundary (ops.encode_fused, packing.encode_message, "
          f"packing.bitplane_unpack, packing.bitplane_pack uint8/int32, ops.decode_reduce "
          f"with every tensor off): each launched its kernel once, bit-identical to the "
          f"plain version")
    return worst


def phase_check_wire(dev, torch, np):
    """The host wire's kernels against their plain versions, bit for bit."""
    from repro_torch.kernels import bitpack, rans, ref

    rng = np.random.default_rng(7)
    n_cases = 0
    for n_g in (1, 37, 4099):
        vals = rng.integers(0, 1 << 32, 32 * n_g, dtype=np.uint64)
        vals[:32], vals[-32:] = 0, 0xFFFFFFFF  # all-zero and all-ones groups
        inputs = {"int32": vals.astype(np.uint32).view(np.int32),  # sign bit set
                  "int64": vals.astype(np.int64), "uint8": vals.astype(np.uint8)}
        for name, a in inputs.items():
            t = torch.from_numpy(a).to(dev)
            for width in range(1, 33):
                got = bitpack.pack(t, width)
                if not torch.equal(got, ref.pack(t, width)):
                    raise AssertionError(f"pack {name} n_g={n_g} w={width} differs")
                if not torch.equal(bitpack.unpack(got, width), ref.unpack(got, width)):
                    raise AssertionError(f"unpack {name} n_g={n_g} w={width} differs")
                n_cases += 1
    n_edge = check_unpack_edges(dev, torch, np)
    n_pack_edge = check_pack_edges(dev, torch, np)
    cases = rans_cases(rans.ROWS)
    for per, lanes in cases:
        check_rans(per, lanes, rng, dev, torch, np)
    torch.cuda.synchronize()
    print(f"check: pack and unpack bit-identical to their plain versions over "
          f"{n_cases} cases (widths 1-32, 1/37/4099 groups, int32/int64/uint8); "
          f"unpack over {n_edge} more (widths 1-32 x group counts at its tile "
          f"edges and past its grid); pack over {n_pack_edge} more (uint8/int32/int64 x "
          f"widths 1-32 x group counts at its tile edges and past its grid); "
          f"rans_encode and rans_decode (dense and compacted stream) over "
          f"skewed, uniform and single streams, an M-255 table and "
          f"n_valid < per*lanes at (per, lanes) {cases}")


def rans_cases(rows: int) -> list:
    """(per, lanes) on both sides of the rANS kernels' tile edges (``rows``
    rows a tile), and one grid of two thread blocks."""
    return [(per, 128) for per in (1, rows - 1, rows, rows + 1, 3 * rows + 17)] + [
        (rows + 1, 256)]


def check_rans(per, lanes, rng, dev, torch, np):
    """rANS encode, dense decode and compacted-stream decode against their
    plain versions, bit for bit, at one (per, lanes)."""
    from repro_torch.core import ans
    from repro_torch.kernels import rans, ref

    n = per * lanes
    streams = {"skewed": np.clip(rng.normal(120, 2.5, n), 0, 255),
               "uniform": rng.integers(0, 256, n),  # emits in nearly every row
               "single": np.full(n, 7)}
    top = np.ones(256, np.int64)
    top[7] = ans.M - 255
    for name, a in streams.items():
        syms = torch.from_numpy(a.astype(np.uint8)).reshape(per, lanes).to(dev)
        tables = [ans.build_freq_table(syms)]
        if name == "single":  # the top frequency M - 255
            tables.append(ans.table_from_freq(torch.from_numpy(top).to(dev)))
        for t in tables:
            s2s = ans._slot_to_symbol(t)
            for n_valid in (n, n - 77):
                got = rans.encode(syms, t.freq, t.cum, n_valid)
                want = ref.rans_encode(syms, t.freq, t.cum, n_valid)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"rans_encode {name} per={per} lanes={lanes} "
                                         f"n_valid={n_valid} differs")
                dec = rans.decode(got[0], got[2], t.freq, t.cum, s2s, n_valid)
                if not torch.equal(dec, ref.rans_decode(got[0], got[2], t.freq, t.cum,
                                                        s2s, n_valid)):
                    raise AssertionError(f"rans_decode {name} per={per} lanes={lanes} "
                                         f"n_valid={n_valid} differs")
                if not torch.equal(dec.reshape(-1)[:n_valid], syms.reshape(-1)[:n_valid]):
                    raise AssertionError(f"rans {name} per={per} does not round-trip")
        flat = syms.reshape(-1)[: n - 77]
        stream = ans.encode(flat, tables[0], lanes=lanes)
        s2s = ans._slot_to_symbol(tables[0])
        got = rans.decode_stream(stream.words, stream.lens, tables[0].freq,
                                 tables[0].cum, s2s, per, flat.shape[0])
        want = ref.rans_decode_stream(stream.words, stream.lens, tables[0].freq,
                                      tables[0].cum, s2s, per, flat.shape[0])
        if not torch.equal(got, want) or not torch.equal(ans.decode(stream), flat):
            raise AssertionError(f"compacted-stream rans_decode {name} per={per} "
                                 f"lanes={lanes} differs")


# the kernels whose wrappers tally each launch under its shape, by the
# module (under repro_torch.kernels) and the name of the wrapper
SHAPED = {"encode_fused": ("encode_fused", "encode_fused"),
          "decode_reduce": ("decode_reduce", "decode_reduce"),
          "pack": ("bitpack", "pack"), "unpack": ("bitpack", "unpack")}


@contextlib.contextmanager
def recorded_inputs(torch):
    """While active, the wrappers of SHAPED keep a copy of the arguments of
    their first launch at each shape, under the shape the launch was
    tallied at (``kernels.launch_shapes``): ``{kernel: {shape: args}}``, the
    inputs the path gives each kernel.  A launch that does not go through
    the wrapper's module attribute is tallied and not recorded, which the
    caller's comparison of the two shows."""
    from repro_torch import kernels

    inputs = {name: {} for name in SHAPED}
    seen, saved = set(), []
    for name, (module, attr) in SHAPED.items():
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        saved.append((mod, attr, getattr(mod, attr)))

        def rec(*args, _name=name, _fn=getattr(mod, attr)):
            sig = (_name, *((a.dtype, tuple(a.shape)) if isinstance(a, torch.Tensor) else a
                            for a in args))
            copy = None if sig in seen else tuple(
                a.clone() if isinstance(a, torch.Tensor) else a for a in args)
            seen.add(sig)
            before = kernels.launch_shapes(_name)
            out = _fn(*args)
            for shape, n in kernels.launch_shapes(_name).items():
                if n != before.get(shape, 0) and copy is not None:
                    inputs[_name].setdefault(shape, copy)
            return out

        setattr(mod, attr, rec)
    try:
        yield inputs
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def shape_tallies() -> dict:
    """``{kernel: {shape: launches}}`` of SHAPED since the counts were cleared."""
    from repro_torch import kernels

    return {k: kernels.launch_shapes(k) for k in SHAPED}


def phase_serve(dev, torch, np):
    """Colocated, then PD-disaggregated serving of smollm_135m at full width
    and depth; then one prefilled cache over the host wire with each codec.
    The launch counts it holds are derived in the module docstring."""
    from repro_torch import configs, kernels
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    from repro_torch.p2p.engine import Compressor
    from repro_torch.sched.cache import PlanCache
    from repro_torch.serve import kv_transfer
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
    from repro_torch.tree_util import bits_equal, tree_flatten, tree_unflatten

    cfg = configs.get(ARCH)
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(SEED),
                             device=dev)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, PROMPT).astype(np.int32)
               for _ in range(N_REQ)]

    def serve(pd, reqs, max_new, plan_cache=None, kv_codec="packed"):
        scfg = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, prefill_chunk=PROMPT,
                           pd_disaggregated=pd)
        eng = ServeEngine(cfg, model, scfg, kv_plan_cache=plan_cache,
                          kv_policy=CompressionPolicy(min_bytes=0) if pd else None,
                          kv_codec=kv_codec)
        for i, p in enumerate(reqs):
            eng.submit(Request(rid=i, prompt=p, max_new=max_new))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        return sorted((r.rid, tuple(r.out)) for r in done), time.perf_counter() - t0

    with launch_train.deterministic():
        serve(False, prompts[:1], 2)  # warm-up, neither counted nor timed
        serve(True, prompts[:1], 2, PlanCache())
        kernels.clear_launch_counts()
        colocated, t_col = serve(False, prompts, MAX_NEW)
        col_launches = kernels.launch_counts()
        pc = PlanCache()
        with recorded_inputs(torch) as inputs:
            kernels.clear_launch_counts()
            pd, t_pd = serve(True, prompts, MAX_NEW, pc)
            pd_launches = kernels.launch_counts()
        recorded = {"serve_pd": (inputs, shape_tallies())}
        col2, t_col2 = serve(False, prompts[:N_RANS], MAX_NEW)
        pc_rans = PlanCache()
        with recorded_inputs(torch) as inputs:
            kernels.clear_launch_counts()
            pd_rans, t_rans = serve(True, prompts[:N_RANS], MAX_NEW, pc_rans, "rans")
            rans_launches = kernels.launch_counts()
        recorded["serve_pd_rans"] = (inputs, shape_tallies())
    if pd != colocated:
        raise AssertionError(f"PD tokens differ from colocated: {pd} vs {colocated}")
    if len(pd) != N_REQ or any(len(o) != MAX_NEW or not all(0 <= t < cfg.vocab for t in o)
                               for _, o in pd):
        raise AssertionError(f"unexpected serve output {pd}")
    if (pc.stats.misses, pc.stats.hits) != (1, N_REQ - 1):
        raise AssertionError(f"plan cache {pc.cache_info()}, expected 1 miss and "
                             f"{N_REQ - 1} hits")
    expect = dict.fromkeys(kernels.KERNELS, 0)
    expect.update(pack=4 * N_REQ, unpack=4 * N_REQ)
    if pd_launches != expect or any(col_launches.values()):
        raise AssertionError(f"serve launch counts {pd_launches} (colocated "
                             f"{col_launches}), expected {expect}")
    if pd_rans != col2:
        raise AssertionError(f"PD rANS tokens {pd_rans} differ from colocated {col2}")
    if (pc_rans.stats.misses, pc_rans.stats.hits) != (1, N_RANS - 1):
        raise AssertionError(f"rANS plan cache {pc_rans.cache_info()}")
    want_rans = dict.fromkeys(kernels.KERNELS, 0)
    want_rans.update(pack=2 * N_RANS, unpack=2 * N_RANS, rans_encode=2 * N_RANS,
                     rans_decode=2 * N_RANS)
    if rans_launches != want_rans:
        raise AssertionError(f"PD rANS serve launches {rans_launches}, expected "
                             f"{want_rans}")
    (plan,) = pc._plans.values()
    n_tok, n_tok2 = N_REQ * MAX_NEW, N_RANS * MAX_NEW
    print(f"serve: {ARCH} full width, {N_REQ} requests x {PROMPT} prompt + {MAX_NEW} "
          f"new tokens, {SLOTS} slots, max_len {MAX_LEN}; PD tokens identical to "
          f"colocated; plan cache {pc.stats.misses} miss {pc.stats.hits} hits "
          f"(width {plan.width_for_dtype('bfloat16')}); launches {pd_launches}")
    print(f"  tokens/s colocated {n_tok / t_col:.1f} ({t_col * 1e3:.1f} ms), "
          f"PD {n_tok / t_pd:.1f} ({t_pd * 1e3:.1f} ms)")
    print(f"  {N_RANS} requests, PD with the rANS codec: tokens identical to colocated; "
          f"plan cache {pc_rans.stats.misses} miss {pc_rans.stats.hits} hit; launches "
          f"{rans_launches}; tokens/s colocated {n_tok2 / t_col2:.1f} "
          f"({t_col2 * 1e3:.1f} ms), PD rANS {n_tok2 / t_rans:.1f} ({t_rans * 1e3:.1f} ms)")

    # one admitted request's prefilled cache over the host wire, each codec
    toks = torch.from_numpy(prompts[0][None].astype(np.int64)).to(dev)
    logits, cache = transformer.prefill(model, toks,
                                        transformer.init_cache(cfg, 1, MAX_LEN, dev))
    leaves, treedef = tree_flatten(cache)

    def greedy(c):
        c = tree_unflatten(treedef, [t.clone() for t in tree_flatten(c)[0]])
        out = [int(torch.argmax(logits[0, -1]))]
        for _ in range(MAX_NEW - 1):
            cur = torch.tensor([[out[-1]]], device=dev)
            lg, c = transformer.decode_step(model, cur, c)
            out.append(int(torch.argmax(lg[0, -1])))
        return out

    want = greedy(cache)
    ship = {}
    for codec_name in ("packed", "rans"):
        eng = Compressor(codec_name=codec_name, device=dev)
        wire = kv_transfer.pack_cache(cache, eng, plan=plan)
        back = kv_transfer.unpack_cache(wire, eng)
        if not bits_equal(back, cache):
            raise AssertionError(f"{codec_name} shipment is not bit-identical")
        if greedy(back) != want:
            raise AssertionError(f"{codec_name} shipment decodes other tokens")
        msgs = [m for m in wire["messages"] if hasattr(m, "wire_bytes")]
        pack_ms = _wall_ms(lambda: kv_transfer.pack_cache(cache, eng, plan=plan),
                           torch, runs=3)
        unpack_ms = _wall_ms(lambda: kv_transfer.unpack_cache(wire, eng), torch, runs=3)
        ship[codec_name] = {
            "pack_ms": pack_ms, "unpack_ms": unpack_ms,
            "ratio": sum(m.wire_bytes() for m in msgs) / sum(m.raw_bytes for m in msgs)}
    for name, r in ship.items():
        print(f"  {name} shipment of one cache ({len(leaves) - 1} leaves of "
              f"{tuple(leaves[0].shape)} bf16): bit-identical, {MAX_NEW}-token "
              f"greedy decode identical; pack {r['pack_ms']:.2f} ms, unpack "
              f"{r['unpack_ms']:.2f} ms (median of 3), wire ratio {r['ratio']:.4f}")
    # where a serve run's time goes: one admission's prefill, one batched
    # decode step (the run is PROMPT-token prefills, decode steps and, in PD,
    # one packed shipment per admission)
    batched = transformer.init_cache(cfg, SLOTS, MAX_LEN, dev)
    batched["pos"] = torch.tensor(PROMPT, dtype=torch.int32, device=dev)
    cur = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
    with launch_train.deterministic():
        parts = {
            f"prefill 1 x {PROMPT}": _wall_ms(lambda: transformer.prefill(
                model, toks, transformer.init_cache(cfg, 1, MAX_LEN, dev)), torch, runs=3),
            f"decode step {SLOTS} slots": _wall_ms(
                lambda: transformer.decode_step(model, cur, batched), torch),
        }
    print("  serve breakdown, ms (host clock to a device sync, median): "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    return {"pd_launches": pd_launches, "rans_launches": rans_launches,
            "recorded": recorded, "leaf": leaves[0],
            "width": plan.width_for_dtype("bfloat16"), "cache": cache,
            "tok_s": {"colocated": n_tok / t_col, "pd": n_tok / t_pd,
                      "pd_rans": n_tok2 / t_rans}, "ship": ship}


@contextlib.contextmanager
def checkpoint_writes():
    """While active, the ms of every checkpoint write (``CheckpointManager``'s
    ``_write``: the .npy files, their sha256 and the manifest, on the async
    save's thread) are appended to the yielded list."""
    from repro_torch.checkpoint.manager import CheckpointManager

    write, times = CheckpointManager._write, []

    def timed(self, *args):
        t0 = time.perf_counter()
        out = write(self, *args)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    CheckpointManager._write = timed
    try:
        yield times
    finally:
        CheckpointManager._write = write


def phase_main(dev, torch):
    import tempfile

    from repro_torch import kernels
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.fault_tolerance import RunnerConfig
    from repro_torch.train import step as step_lib

    runs = {}
    tmp = tempfile.TemporaryDirectory(prefix="main_ckpt_")
    hb = os.path.join(tmp.name, "heartbeat.json")
    # the compressed run checkpoints the state after its last step, once
    rcfg = RunnerConfig(ckpt_dir=tmp.name, ckpt_every=STEPS - 1, heartbeat_path=hb)
    with launch_train.single_process_group(dev) as group, tmp:
        n_dp = torch.distributed.get_world_size(group)
        for compress in (True, False):
            with recorded_inputs(torch) as inputs, checkpoint_writes() as writes:
                kernels.clear_launch_counts()
                runs[compress] = launch_train.train(
                    ARCH, steps=STEPS, batch=BATCH, seq=SEQ, compress=compress,
                    device=dev, seed=SEED, group=group, rcfg=rcfg if compress else None)
                runs[compress].launches = kernels.launch_counts()
            runs[compress].recorded = (inputs, shape_tallies())
            runs[compress].ckpt_write_ms = writes
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
        expect = dict.fromkeys(kernels.KERNELS, 0)
        expect.update({k: STEPS * n_buckets * v
                       for k, v in two_shot_launches(True, True, n_dp).items()})
        if comp.launches != expect or any(raw.launches.values()):
            raise AssertionError(f"launch counts {comp.launches} (raw twin "
                                 f"{raw.launches}), expected {expect}")
        # each run replays one zero1 plan: compiled on its first step, a
        # plan-cache hit on every later one; a compressed step's wire is one
        # consolidated plan:zero1 report
        # (a step rerun raw replays the disabled policy's plan: one more)
        cached = {}
        for tag, run in (("compressed", comp), ("raw twin", raw)):
            st, r = run.plan_cache.stats, run.retries
            cached[tag] = (st.misses, st.hits)
            if cached[tag] != (1 + bool(r), STEPS - 1 + max(r - 1, 0)):
                raise AssertionError(f"zero1 plan cache {run.plan_cache.cache_info()}")
        plan = step_lib.zero1_plan(comp.state, comp.tcfg, group, cache=comp.plan_cache)
        if [r.name for r in comp.wire_reports] != ["plan:zero1"] * STEPS or any(
                r.wire_bytes != plan.wire_bytes for r in comp.wire_reports):
            raise AssertionError(f"wire reports {comp.wire_reports} of plan {plan.summary()}")
        (pair,) = plan.buckets
        print(f"main: {ARCH} full width, ZeRO-1 n_dp={n_dp}, batch {BATCH} x seq {SEQ}, "
              f"bucket n={comp.state.meta.padded[0]}")
        print(f"  compressed losses {comp.losses} step_ms "
              f"{[round(t, 1) for t in comp.step_ms]} retries {comp.retries}")
        print(f"  raw twin   losses {raw.losses} step_ms {[round(t, 1) for t in raw.step_ms]}")
        print("  zero1 plan cache (misses, hits): " + ", ".join(
            f"{tag} {mh}" for tag, mh in cached.items()))
        print(f"  wire ratio RS {pair.rs.ratio:.4f} AG {pair.ag.ratio:.4f} (plan:zero1 "
              f"{comp.wire_reports[0].ratio:.4f}); launches {comp.launches}; "
              f"losses and final parameter bytes identical")
        phase_checkpoint(comp, group, hb, dev, torch)
        phase_breakdown(comp, group, dev, torch)
        psum = phase_psum(comp, group, dev, torch)
    return comp, psum


def phase_checkpoint(comp, group, hb, dev, torch):
    """The compressed run's StepRunner wrote a heartbeat each step and one
    asynchronous checkpoint of the ZeRO-1 train state after its last step:
    ``try_resume`` restores it on the card bit-identical to the live state,
    and one more step from the restored state gives the loss and the bits of
    the same step from (a copy of) the live state.  Prints the save's ms (the
    train loop's host copy, from its ``train:checkpoint`` span, and the
    background write) and the restore's."""
    from repro_torch import obs
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.fault_tolerance import heartbeat_age
    from repro_torch.train import step as step_lib
    from repro_torch.tree_util import bits_equal, tree_flatten, tree_unflatten

    runner, state = comp.runner, comp.state
    with open(hb) as f:
        beat = json.load(f)
    age = heartbeat_age(hb)
    if beat["step"] != STEPS - 1 or age is None or age > 600:
        raise AssertionError(f"heartbeat {beat} (age {age})")
    submits = [s.dur * 1e3 for s in obs.spans() if s.name == "train:checkpoint"]
    if runner.ckpt.available_steps() != (STEPS - 1,) or len(comp.ckpt_write_ms) != 1 \
            or len(submits) != 1:
        raise AssertionError(f"checkpoints {runner.ckpt.available_steps()}, writes "
                             f"{comp.ckpt_write_ms}, train:checkpoint spans {submits}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, start = runner.try_resume(state, device=dev)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if restored is None or start != STEPS or restored.step != state.step \
            or not bits_equal(restored.tree(), state.tree()):
        raise AssertionError(f"try_resume gave step {start} (state step "
                             f"{getattr(restored, 'step', None)}), bit-identical "
                             f"{restored is not None and bits_equal(restored.tree(), state.tree())}")
    leaves, treedef = tree_flatten(state.tree())
    live = state.from_tree(tree_unflatten(treedef, [t.clone() for t in leaves]))
    batch = DataPipeline(DataConfig(vocab=state.model.cfg.vocab, global_batch=BATCH,
                                    seq_len=SEQ, seed=SEED)).tensors_at(STEPS, dev)
    with launch_train.deterministic():
        m_live = step_lib.train_step(live, batch, comp.tcfg, group=group)
        m_rest = step_lib.train_step(restored, batch, comp.tcfg, group=group)
    losses = (float(m_live["loss"]), float(m_rest["loss"]))
    if losses[0] != losses[1] or not bits_equal(live.tree(), restored.tree()):
        raise AssertionError(f"step {STEPS} from the restored state: losses {losses}, "
                             f"bit-identical {bits_equal(live.tree(), restored.tree())}")
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"checkpoint: ZeRO-1 train state after step {STEPS - 1} ({len(leaves)} leaves, "
          f"{nbytes} B) saved asynchronously by the StepRunner: host copy "
          f"{submits[0]:.1f} ms (train:checkpoint span), background write "
          f"{comp.ckpt_write_ms[0]:.1f} ms (.npy files, sha256, manifest); try_resume on "
          f"the card {restore_ms:.1f} ms (sha256 verify, load, host-to-device), "
          f"bit-identical; step {STEPS} from it: loss {losses[1]!r} = the live state's, "
          f"bits identical; heartbeat step {beat['step']}, age {age:.2f} s; card {run_card()}")
    del live, restored


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
    main path's bucket; the all-gather split into encode and decode (the
    unpack kernel, then plain PyTorch for the zero-escape decode and merge)."""
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
            "AG decode": _wall_ms(lambda: cc._decode_chunks(
                wire, dtype=shard.dtype, n=shard.shape[0], width=w_ag,
                block=prof.block), torch),
        })
    print("  breakdown, ms (median of 5): "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    return ms


def two_shot_launches(fused_encode: bool, fused_decode: bool, n_dev: int) -> dict:
    """Kernel launches of one compressed two-shot bucket over n_dev ranks:
    the RS encodes n_dev rows and the AG one (encode_fused once a phase, or
    pack twice a row: the lo plane and the exponent residuals); the RS
    receive runs decode_reduce and an exception-patch unpack a chunk, or,
    unfused, unpacks the payloads and the lo planes; the AG decode unpacks
    both planes."""
    return {"encode_fused": 2 if fused_encode else 0,
            "pack": 0 if fused_encode else 2 * (n_dev + 1),
            "decode_reduce": n_dev if fused_decode else 0,
            "unpack": n_dev + 2 if fused_decode else 4}


def phase_psum(run, group, dev, torch):
    """The compressed all-reduce of one gradient pytree at full width, on the
    main phase's one-rank NCCL group; its checks and launch counts are
    derived in the module docstring."""
    import dataclasses

    from repro_torch import kernels, sched
    from repro_torch.core import compressed_collectives as cc
    from repro_torch.core.policy import CompressionPolicy, capture_wire_reports
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.sched import compile as sched_compile
    from repro_torch.sched.cache import PlanCache
    from repro_torch.train import step as step_lib
    from repro_torch.tree_util import bits_equal

    model, tcfg = run.state.model, run.tcfg
    leaves = model.leaves()
    batch = DataPipeline(DataConfig(vocab=model.cfg.vocab, global_batch=BATCH, seq_len=SEQ,
                                    seed=SEED)).tensors_at(0, dev)
    with launch_train.deterministic():
        for p in leaves:
            p.grad = None
        step_lib.loss_fn(model, batch, tcfg).backward()
        grads = [p.grad.detach().clone() for p in leaves]
        for p in leaves:
            p.grad = None
        with torch.no_grad():
            act = model(batch["tokens"]).reshape(1, -1)  # (1, 8 * 512 * 576) bf16
    embed = model.params["embed"].detach()
    n_dp = torch.distributed.get_world_size(group)
    base = CompressionPolicy()
    policies = {"two_shot": base, "unfused_encode": dataclasses.replace(base, fused_encode=False),
                "unfused_decode": dataclasses.replace(base, fused_decode_reduce=False),
                "raw": CompressionPolicy.disabled()}
    plan = sched_compile.compile_psum_plan(grads, "data", policy=base, n_dev=n_dp)
    if plan.summary()["paths"] != ("two_shot",) * len(plan.buckets) or plan.raw_leaf_ix:
        raise AssertionError(f"psum plan {plan.summary()}")

    def derived(pol) -> dict:
        want = dict.fromkeys(kernels.KERNELS, 0)
        if pol.enabled:
            for k, v in two_shot_launches(pol.fused_encode, pol.fused_decode_reduce,
                                          n_dp).items():
                want[k] = v * len(plan.buckets)
        return want

    def counted(fn):
        before = kernels.launch_counts()
        out = fn()
        after = kernels.launch_counts()
        return out, {k: after[k] - before[k] for k in after}

    # -- the phase's own runs: these launches are the kernels line's "psum" --
    with recorded_inputs(torch) as inputs:
        kernels.clear_launch_counts()
        cache, outs, reports = PlanCache(), {}, {}
        for name, pol in [*policies.items(), ("two_shot again", base)]:
            with capture_wire_reports() as reports[name]:
                (out, flag), got = counted(
                    lambda: sched.psum_with_plan(grads, group, policy=pol, cache=cache))
            if got != derived(pol) or int(flag) or not bits_equal(out, grads):
                raise AssertionError(f"psum_with_plan {name}: flag {int(flag)}, launches {got} "
                                     f"(expected {derived(pol)}), identical to the gradients "
                                     f"{bits_equal(out, grads)}")
            outs[name] = out
        if (cache.stats.misses, cache.stats.hits) != (len(policies), 1):
            raise AssertionError(f"psum plan cache {cache.cache_info()}")
        plan_reports = {k: r for k, (r,) in ((k, v) for k, v in reports.items() if v)}
        if set(plan_reports) != set(reports) - {"raw"} or len(
                {(r.raw_bytes, r.wire_bytes) for r in plan_reports.values()}) != 1 or [
                r.encode_fused for r in plan_reports.values()] != [True, False, True, True] or (
                plan_reports["two_shot"].wire_bytes != plan.wire_bytes):
            raise AssertionError(f"psum reports {reports}, plan {plan.summary()}")
        bucket = torch.cat([g.reshape(-1) for g in grads])
        others = {
            "hierarchical": (lambda: cc.psum_compressed_hierarchical(
                bucket, group, group, policy=base, group=group), bucket,
                {"encode_fused": 4, "decode_reduce": 2, "unpack": 6}),
            "all_to_all": (lambda: cc.all_to_all_compressed(act, group, policy=base), act,
                           {"encode_fused": 1, "unpack": 2}),
            "ppermute": (lambda: cc.ppermute_compressed(embed, [(0, 0)], group, policy=base),
                         embed, {"encode_fused": 1, "unpack": 2})}
        for name, (fn, x, want) in others.items():
            (out, flag), got = counted(fn)
            want = {**dict.fromkeys(kernels.KERNELS, 0), **want}
            if got != want or int(flag) or not bits_equal(out, x):
                raise AssertionError(f"{name}: flag {int(flag)}, launches {got} (expected "
                                     f"{want}), identical {bits_equal(out, x)}")
        launches = kernels.launch_counts()
    recorded = (inputs, shape_tallies())

    # -- the wires: the unfused encode's equal the fused one's, field by field
    (b,) = plan.buckets
    rows = cc._pad_flat(bucket, n_dp * b.block).reshape(n_dp, -1)
    widths = sorted({b.width, b.ag_width})
    for w in widths:
        kw = dict(width=w, block=b.block, exc_frac=b.exc_frac)
        fused, unfused = cc._encode_chunks(rows, **kw), cc._encode_chunks(rows, fused=False, **kw)
        if any(not torch.equal(fused[k], unfused[k]) for k in fused):
            raise AssertionError(f"the unfused encode's wire differs at width {w}")

    ms = {name: _wall_ms(lambda: sched.psum_with_plan(grads, group, policy=pol, cache=cache),
                         torch) for name, pol in policies.items()}
    print(f"psum: {ARCH} full width, gradients of one step at batch {BATCH} x seq {SEQ} "
          f"({len(grads)} leaves, bucket n={bucket.numel()}), one-rank NCCL group; "
          f"psum_with_plan two_shot, unfused encode, unfused decode and the raw twin each "
          f"bit-identical to the gradients; wires of the unfused encode identical at "
          f"widths {widths}; plan cache {len(policies)} misses 1 hit; hierarchical, "
          f"all_to_all {tuple(act.shape)} and ppermute {tuple(embed.shape)} bit-identical; "
          f"launches {launches}")
    print(f"  ms (host clock to a device sync, median of 5): "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f"; wire ratio {plan_reports['two_shot'].ratio:.4f}; card {run_card()}")
    return {"launches": launches, "recorded": recorded, "ms": ms,
            "ratio": plan_reports["two_shot"].ratio, "bucket": bucket}


def run_card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_sync(dev, torch):
    """RL weight sync at full width and depth; the launch counts it holds are
    derived in the module docstring."""
    from repro_torch import kernels
    from repro_torch.core import codec, packing
    from repro_torch.launch import rl_weight_sync
    from repro_torch.launch import train as launch_train
    from repro_torch.sync import engine as sync_engine
    from repro_torch.tree_util import tree_flatten

    with launch_train.single_process_group(dev) as group, launch_train.deterministic(), \
            recorded_inputs(torch) as inputs:
        kernels.clear_launch_counts()
        run = rl_weight_sync.run(ARCH, device=dev, batch=BATCH, seq=SEQ, seed=SEED,
                                 slots=SLOTS, max_len=MAX_LEN, requests=N_SYNC_REQ,
                                 prompt_len=PROMPT, max_new=MAX_NEW, group=group,
                                 log=lambda line: print(f"  {line}"))
        total = kernels.launch_counts()
    recs = run.records
    modes = [(r["replica"], r["mode"]) for r in recs]
    want_modes = [("rollout-0", "full"), ("rollout-0", "delta"), ("rollout-1", "full"),
                  ("rollout-0", "delta"), ("rollout-1", "delta"), ("rollout-0", "full")]
    if modes != want_modes or not all(r["exact"] for r in recs):
        raise AssertionError(f"weight sync modes {modes} (exact "
                             f"{[r['exact'] for r in recs]}), expected {want_modes}")
    if (run.plan_cache.stats.misses, run.plan_cache.stats.hits) != (1, 4):
        raise AssertionError(f"wsync plan cache {run.plan_cache.cache_info()}")
    if run.tokens != run.fresh_tokens or len(run.tokens) != N_SYNC_REQ or any(
            len(o) != MAX_NEW for _, o in run.tokens):
        raise AssertionError(f"rollout-0 tokens {run.tokens} vs fresh {run.fresh_tokens}")
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(encode_fused=3, pack=4, unpack=12)
    n_steps = len(run.losses)  # each compressed step: 2 encodes, 1 decode+reduce, 3 unpacks
    train_counts = {"encode_fused": 2 * n_steps, "decode_reduce": n_steps,
                    "unpack": 3 * n_steps}
    whole = {k: v + train_counts.get(k, 0) for k, v in want.items()}
    if run.sync_launches != want or total != whole:
        raise AssertionError(f"weight sync launches {run.sync_launches} (whole run "
                             f"{total}), expected {want} (whole run {whole})")
    for r in recs:
        widths = (f", delta widths exp={run.widths[0]} lo={run.widths[1]}"
                  if r["mode"] == "delta" else ", width 5")
        print(f"  update v{r['version']} -> {r['replica']}: {r['mode']}, wire "
              f"{r['wire_bytes']} B of {r['raw_bytes']} B, ratio {r['ratio']:.4f}{widths}")
    print(f"sync: {ARCH} full width, {run.n_publishes} publishes, every reconstruction "
          f"bit-identical; modes as expected; plan cache 1 miss 4 hits; rollout-0's "
          f"tokens identical to a fresh engine's; launches {run.sync_launches} (whole "
          f"run {total}, {n_steps} train steps)")

    # where an update's time goes: the last delta (v3 against v2, rollout-0's)
    # and the fence's full update, part by part
    store, plan = run.engine.store, run.engine.plan_for(run.engine.store.latest()[0])
    (b,) = plan.buckets
    delta_upd, full_upd = recs[3]["update"], recs[5]["update"]
    v3, v2 = store.get(delta_upd.version), store.get(delta_upd.base_version)

    def leaves(t):
        return tree_flatten(t)[0]

    def bucket(t):
        return codec.pad_flat_bits(codec.concat_members(leaves(t), b.members), b.block)

    enc = {
        "delta": lambda: packing.encode_delta(
            bucket(v3), bucket(v2), width=b.delta_width, lo_width=b.delta_lo_width,
            block=b.block, exc_frac=b.exc_frac),
        "full": lambda: packing.encode_message(bucket(v3), width=b.width, block=b.block,
                                               exc_frac=b.exc_frac)}
    model = run.rollout0.model
    parts = {}
    with torch.no_grad():
        for kind, upd, base in (("delta", delta_upd, v2), ("full", full_upd, None)):
            m = enc[kind]()
            new = sync_engine.apply_update(upd, base_params=base, device=dev)
            parts[kind] = {
                "encode on the card": _wall_ms(enc[kind], torch, runs=3),
                "device-to-host copy": _wall_ms(lambda: sync_engine.host_message(m), torch,
                                                runs=3),
                "update_checksum": _wall_ms(lambda: sync_engine.update_checksum(upd), torch,
                                            runs=3),
                "verify_update": _wall_ms(lambda: sync_engine.verify_update(upd), torch,
                                          runs=3),
                "apply (host-to-device copy + decode)": _wall_ms(
                    lambda: sync_engine.apply_update(upd, base_params=base, device=dev),
                    torch, runs=3),
                "in-place copy into the serve model": _wall_ms(
                    lambda: [p.copy_(g) for p, g in zip(model.leaves(), leaves(new))],
                    torch, runs=3),
            }
            print(f"  {kind} update v{upd.version} ({upd.wire_bytes} B, ratio "
                  f"{upd.ratio:.4f}), ms (host clock to a device sync, median of 3): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in parts[kind].items()))
    # the sync sections' launches by shape (the window's inputs also hold
    # the train steps')
    recorded = (inputs, {k: run.sync_shapes[k] for k in SHAPED})
    return {"launches": run.sync_launches, "n_publishes": run.n_publishes, "parts": parts,
            "recorded": recorded, "versions": (v2, v3), "policy": run.engine.policy,
            "retained": [store.get(v) for v in store.retained()]}


# fleet phase: replicas (benchmarks/fig_tree.py runs 64 for the topologies
# and 8 under chaos; 6 hold the weights of all three topologies and the chaos
# run inside the time limit), the topologies as (kind, fanout), and the
# chaos run's settings (fig_tree.run_chaos_tree's, plus one trainer restart)
N_FLEET = 6
FLEET_KINDS = (("star", 2), ("tree", 2), ("pipeline", 1))
CHAOS = dict(seed=7, rounds=10, drop_rate=0.1, corrupt_rate=0.1, delay_rate=0.1,
             max_delay=2, kills=1, joins=1, trainer_restarts=1)
CHAOS_FLEET = dict(broadcast="tree", fanout=2, max_retries=30, backoff_cap=2)


def fleet_launches(encodes, applies) -> dict:
    """Kernel launches of a fleet run, from what it did (the sync phase's
    counts): of each compressed bucket an encode handled, a delta tried
    packs its two planes (pack 2) and a full encode runs encode_fused once
    (also after a delta that overflowed, and before a full wire whose
    exceptions overflowed ships raw); a bucket forced raw launches nothing.
    Each compressed bucket a replica applies unpacks its two planes (unpack
    2); a raw one nothing.  ``encodes`` holds (delta tried, mode shipped,
    forced raw) a compressed bucket, ``applies`` each applied bucket's mode."""
    out = {"encode_fused": 0, "pack": 0, "unpack": 0}
    for tried_delta, mode, forced_raw in encodes:
        if forced_raw:
            continue
        out["pack"] += 2 * tried_delta
        out["encode_fused"] += mode != "delta"
    out["unpack"] = 2 * sum(mode != "raw" for mode in applies)
    return out


@contextlib.contextmanager
def fleet_record(plan):
    """While active, every ``WeightSyncEngine`` encode and every replica's
    apply is recorded for :func:`fleet_launches`: ``(encodes, applies,
    updates)``, the compressed buckets of ``plan`` (the weights' wsync plan)
    telling which bucket could run a kernel."""
    from repro_torch.sync import engine as engine_mod
    from repro_torch.sync import fleet as fleet_mod

    encodes, applies, updates = [], [], []
    encode, apply = engine_mod.WeightSyncEngine._encode_update, fleet_mod.apply_update

    def rec_encode(self, params, version, base_version, force):
        update = encode(self, params, version, base_version, force)
        for b, (_, _, mode, _) in zip(plan.buckets, update.buckets, strict=True):
            if b.compressed:
                encodes.append((base_version is not None and b.delta_width > 0, mode,
                                force == "raw"))
        updates.append(update)
        return update

    def rec_apply(update, *args, **kw):
        applies.extend(m for b, (_, _, m, _) in zip(plan.buckets, update.buckets, strict=True)
                       if b.compressed)
        return apply(update, *args, **kw)

    engine_mod.WeightSyncEngine._encode_update, fleet_mod.apply_update = rec_encode, rec_apply
    try:
        yield encodes, applies, updates
    finally:
        engine_mod.WeightSyncEngine._encode_update, fleet_mod.apply_update = encode, apply


def phase_fleet(sync, dev, torch):
    """The weight-sync fleet at full width: the sync phase's retained
    versions to N_FLEET replicas on the card over each topology, then the
    tree under seeded chaos, then the in-mesh pipeline; checks and launch
    counts are derived in the module docstring and ``fleet_launches``."""
    import tempfile

    from repro_torch import kernels, sched
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.faults import FaultConfig, FaultPlan
    from repro_torch.sched.cache import PlanCache
    from repro_torch.sync import FleetConfig, SyncFleet, WeightSyncEngine, broadcast_weights
    from repro_torch.tree_util import bits_equal

    versions, policy = sync["retained"], sync["policy"]
    v_prev, v_new = sync["versions"]
    names = tuple(f"r{i}" for i in range(N_FLEET))
    plan = sched.compile_wsync_plan(v_new, "data", policy=policy, n_dev=1)
    n_ws = sum(b.compressed for b in plan.buckets)
    cache = PlanCache()  # one for every fleet: a plan a schedule triple

    def engine():
        return WeightSyncEngine(policy=policy, plan_cache=cache)

    def synced_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    topo = {}
    mesh_plan = sched.compile_wsync_plan(v_new, "data", policy=policy, n_dev=1,
                                         broadcast="pipeline", n_receivers=3)
    ranks = (0, 0, 0, 0)
    with launch_train.single_process_group(dev) as group, fleet_record(plan) as (
            encodes, applies, updates), recorded_inputs(torch) as inputs:
        runs = {"execute_wsync_broadcast": lambda b: sched.execute_wsync_broadcast(
                    mesh_plan, v_new, group, ranks, base=b),
                "broadcast_weights": lambda b: broadcast_weights(
                    v_new, group, mesh_plan.broadcast, ranks, policy=policy, base=b)}
        kernels.clear_launch_counts()
        # -- (a) each topology: every retained version, then settle
        for kind, fanout in FLEET_KINDS:
            fleet = SyncFleet(engine(), names, device=dev, cfg=FleetConfig(
                broadcast=kind, fanout=fanout, ckpt_every_publishes=10 ** 9))
            schedule = sched.compile_broadcast_schedule(N_FLEET, kind=kind, fanout=fanout)
            waves = []
            for params in versions:
                before, n_enc = dict(fleet.stats), len(updates)
                fleet.publish(params)
                rounds, ms = synced_ms(fleet.settle)
                if len(updates) != n_enc + 1:
                    raise AssertionError(f"fleet {kind}: {len(updates) - n_enc} encodes of "
                                         f"one publish")
                upd = updates[-1]
                w = upd.wire_bytes
                got = {k: fleet.stats[k] - before[k]
                       for k in ("trainer_egress_bytes", "forwards", "forward_bytes")}
                want = {"trainer_egress_bytes": schedule.root_degree * w,
                        "forwards": schedule.n_edges - schedule.root_degree,
                        "forward_bytes": (schedule.n_edges - schedule.root_degree) * w}
                if (not fleet.verify_bitexact() or got != want or rounds != 1
                        or fleet.stats["max_hop_depth"] != schedule.depth):
                    raise AssertionError(
                        f"fleet {kind}: v{upd.version} bit-exact {fleet.verify_bitexact()}, "
                        f"rounds {rounds}, {got} (expected {want}), hop depth "
                        f"{fleet.stats['max_hop_depth']} (schedule {schedule.depth})")
                waves.append({"version": upd.version, "mode": upd.mode, "wire_bytes": w,
                              "egress": got["trainer_egress_bytes"], "rounds": rounds,
                              "settle_ms": ms})
            topo[kind] = {"waves": waves, "forwards": fleet.stats["forwards"],
                          "depth": fleet.stats["max_hop_depth"],
                          "root_degree": schedule.root_degree}
            del fleet
        if cache.stats.misses != 1 + sum(kind != "star" for kind, _ in FLEET_KINDS):
            raise AssertionError(f"fleet plan cache {cache.cache_info()}: one compile a "
                                 f"schedule triple and one without")
        topo_cache = cache.cache_info()

        # -- (b) the tree under seeded chaos: publish at every third round
        with tempfile.TemporaryDirectory(prefix="fleet_ckpt_") as ckpt_dir:
            fault_plan = FaultPlan.generate(FaultConfig(**CHAOS, replicas=names))
            fleet = SyncFleet(engine(), names, device=dev, fault_plan=fault_plan,
                              cfg=FleetConfig(**CHAOS_FLEET, ckpt_dir=ckpt_dir))

            def chaos_run():
                pending = list(versions)
                for r in range(CHAOS["rounds"]):
                    if r % 3 == 0 and pending:
                        fleet.publish(pending.pop(0))
                    fleet.round()
                return fleet.settle(max_rounds=80)

            rounds, ms = synced_ms(chaos_run)
            led, st = fleet.integrity_ledger(), fleet.stats
            if (not fleet.verify_bitexact() or led["silent"] or st["quarantines"]
                    or led["injected"] != led["seen"] + led["lost"]
                    or st["max_link_failures"] > CHAOS_FLEET["max_retries"]
                    or st["trainer_restarts"] != 1):
                raise AssertionError(f"fleet chaos: bit-exact {fleet.verify_bitexact()}, "
                                     f"ledger {led}, stats {st}")
            chaos = {"settle_rounds": rounds, "rounds": CHAOS["rounds"] + rounds, "ms": ms,
                     "ledger": led,
                     "stats": dict(st), "trace_events": len(fleet.trace),
                     "live": fleet.live_replicas(), "counts": dict(fleet.wire.counts)}
            del fleet

        # -- (c) in the mesh: a pipeline of 3 self-sends at one rank
        outs = {}
        for tag, fn in runs.items():
            for btag, b in (("full", None), ("delta", v_prev)):
                out, flag = fn(b)
                if int(flag) or not bits_equal(out, v_new):
                    raise AssertionError(f"fleet in-mesh {tag} {btag}: flag {int(flag)}, "
                                         f"bit-identical {bits_equal(out, v_new)}")
                outs[tag, btag] = out
        if not all(bits_equal(outs["execute_wsync_broadcast", t], outs["broadcast_weights", t])
                   for t in ("full", "delta")):
            raise AssertionError("fleet in-mesh: the two twins disagree")
        del outs
        launches = kernels.launch_counts()
        recorded = (inputs, shape_tallies())
    with launch_train.single_process_group(dev) as group:  # times, not counted
        mesh_ms = {f"{tag} {btag}": _wall_ms(lambda: fn(b), torch)
                   for tag, fn in runs.items() for btag, b in (("full", None), ("delta", v_prev))}

    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(fleet_launches(encodes, applies))
    levels = len(mesh_plan.broadcast.levels())
    for mode in ("split_send", "delta"):
        for k, v in p2p_launches(mode).items():
            want[k] += len(runs) * levels * n_ws * v
    if launches != want:
        raise AssertionError(f"fleet launches {launches}, derived {want}")

    print(f"fleet: {ARCH} full width, {len(versions)} retained versions to {N_FLEET} "
          f"replicas on the card; plan cache after the topologies {topo_cache}; launches "
          f"{launches} (derived from {len(updates)} encodes and {len(applies)} applied "
          f"buckets, and the in-mesh runs)")
    for kind, t in topo.items():
        print(f"  {kind}: root degree {t['root_degree']}, forwards {t['forwards']}, hop "
              f"depth {t['depth']}, every settle bit-exact; waves " + "; ".join(
                  f"v{w['version']} {w['mode']} {w['wire_bytes']} B, egress {w['egress']} B, "
                  f"{w['rounds']} round, settle {w['settle_ms']:.1f} ms" for w in t["waves"]))
    print(f"  chaos (tree, fanout 2, FaultPlan.generate seed {CHAOS['seed']}, "
          f"{CHAOS['rounds']} rounds, publishes at r % 3 == 0, then settle): "
          f"{chaos['rounds']} rounds ({chaos['settle_rounds']} to settle), "
          f"{chaos['ms']:.1f} ms, bit-exact, ledger {chaos['ledger']}, faults "
          f"{chaos['counts']}, {chaos['trace_events']} trace events, live {chaos['live']}, "
          f"stats {chaos['stats']}")
    print("  in-mesh pipeline of 3 over ranks (0, 0, 0, 0), bit-identical, flag 0; ms (host "
          "clock to a device sync, median of 5): " + ", ".join(
              f"{k} {v:.2f}" for k, v in mesh_ms.items()) + f"; card {run_card()}")
    return {"launches": launches, "recorded": recorded}


def p2p_launches(strategy: str, *, n_chunks: int = 1, reduce: str = "") -> dict:
    """Kernel launches of one compressed P2P send of one bucket at one rank
    (core/split_send): split_send packs its lo plane and its exponent
    residuals (pack 2; delta_send packs its two delta planes alike) and the
    receive unpacks the payload and the lo plane (unpack 2), or, as a fused
    reducing receiver, runs decode_reduce and the exception patch's unpack
    of the lo rows; encode_send encodes in one pass (encode_fused 1) and
    unpacks both planes; the chunked pipeline is one encode_send a chunk."""
    if strategy in ("split_send", "delta"):
        recv = {"decode_reduce": 1, "unpack": 1} if reduce == "fused" else {"unpack": 2}
        return {"pack": 2, **recv}
    return {"encode_fused": n_chunks, "unpack": 2 * n_chunks}


def phase_p2p(serve, psum, sync, dev, torch):
    """Uzip-P2P in the mesh at full width, on a one-rank NCCL group with
    perm [(0, 0)] (the wire is NCCL's copy to itself): the serve phase's
    prefilled cache through transfer_cache_with_plan under each strategy and
    gated off; the psum phase's gradient bucket through p2p_send_with_plan
    under each strategy, gated off, and as a reducing receiver fused and
    unfused; the sync phase's last two weight versions through
    sync_weights_with_plan, full, then as a delta.  Checks and launch counts
    are derived in the module docstring and ``p2p_launches``."""
    import dataclasses

    from repro_torch import kernels, sched
    from repro_torch.core.policy import CompressionPolicy, capture_wire_reports
    from repro_torch.core.split_send import chunk_grid
    from repro_torch.launch import train as launch_train
    from repro_torch.sched import compile as sched_compile
    from repro_torch.sched.cache import PlanCache
    from repro_torch.tree_util import bits_equal, tree_flatten

    cache, bucket = serve["cache"], psum["bucket"]
    v_prev, v_new = sync["versions"]
    perm, base = [(0, 0)], CompressionPolicy()
    off = CompressionPolicy.disabled()
    strategies = sched_compile.P2P_STRATEGIES
    kv_plans = {s: sched_compile.compile_kv_plan(cache, "data", policy=base, n_dev=1,
                                                 strategy=s) for s in strategies}
    (kv_b,) = kv_plans["split_send"].buckets
    ws_plan = sched_compile.compile_wsync_plan(v_new, "data", policy=sync["policy"], n_dev=1)

    def derived(strategy, n, buckets=1, **kw) -> dict:
        want = dict.fromkeys(kernels.KERNELS, 0)
        n_chunks = (chunk_grid(n, sched_compile._P2P_PIPELINE_CHUNKS, 512)[1]
                    if strategy == "chunked" else 1)
        for k, v in p2p_launches(strategy, n_chunks=n_chunks, **kw).items():
            want[k] += buckets * v
        return want

    def counted(fn):
        before = kernels.launch_counts()
        out = fn()
        after = kernels.launch_counts()
        return out, {k: after[k] - before[k] for k in after}

    def check(name, out, flag, got, want, same):
        if got != want or int(flag) or not same:
            raise AssertionError(f"p2p {name}: flag {int(flag)}, launches {got} (expected "
                                 f"{want}), bit-identical {same}")

    acc = torch.empty(bucket.numel(), dtype=torch.float32, device=dev).normal_(
        0, 1e-3, generator=torch.Generator(device=dev).manual_seed(SEED))
    reduced = acc + bucket.float()
    pols = {"fused": base, "unfused": dataclasses.replace(base, fused_decode_reduce=False)}
    n_ws = sum(b.compressed for b in ws_plan.buckets)
    with launch_train.single_process_group(dev) as group:
        kv_cache, grad_cache, ws_cache = PlanCache(), PlanCache(), PlanCache()

        def kv(strategy, pol=base, pc=kv_cache):
            return sched.transfer_cache_with_plan(cache, group, perm, policy=pol,
                                                  strategy=strategy, plan_cache=pc)

        def grad(strategy, pol=base, reduce_into=None):
            return sched.p2p_send_with_plan(bucket, group, perm, policy=pol,
                                            tensor_class="gradient", strategy=strategy,
                                            reduce_into=reduce_into, cache=grad_cache)

        def wsync(base_tree=None):
            return sched.sync_weights_with_plan(v_new, group, perm, policy=sync["policy"],
                                                base=base_tree, cache=ws_cache)

        # -- the phase's own runs: these launches are the kernels line's "p2p"
        with recorded_inputs(torch) as inputs:
            kernels.clear_launch_counts()
            ratios = {}
            for strat in strategies:
                with capture_wire_reports() as reps:
                    (out, flag), got = counted(lambda: kv(strat))
                check(f"kv {strat}", out, flag, got, derived(strat, kv_b.length),
                      bits_equal(out, cache))
                plan = kv_plans[strat]
                if [r.name for r in reps] != ["plan:kv"] or (
                        reps[0].wire_bytes, reps[0].raw_bytes, reps[0].ratio) != (
                        plan.wire_bytes, plan.raw_bytes, plan.ratio):
                    raise AssertionError(f"p2p kv {strat}: reports {reps}, plan {plan.summary()}")
                ratios[strat] = plan.ratio
            if (kv_cache.stats.misses, kv_cache.stats.hits) != (len(strategies), 0):
                raise AssertionError(f"kv plan cache {kv_cache.cache_info()}")
            (out, flag), got = counted(lambda: kv("split_send", off, PlanCache()))
            check("kv raw", out, flag, got, dict.fromkeys(kernels.KERNELS, 0),
                  bits_equal(out, cache))
            for strat in strategies:
                (out, flag), got = counted(lambda: grad(strat))
                check(f"gradient bucket {strat}", out, flag, got, derived(strat, bucket.numel()),
                      bits_equal(out, bucket))
            (out, flag), got = counted(lambda: grad("split_send", off))
            check("gradient bucket raw", out, flag, got, dict.fromkeys(kernels.KERNELS, 0),
                  bits_equal(out, bucket))
            for tag, pol in pols.items():
                (out, flag), got = counted(lambda: grad("split_send", pol, acc))
                check(f"reducing receiver {tag}", out, flag, got,
                      derived("split_send", bucket.numel(), reduce=tag),
                      same_f32(out, reduced, torch)[0])
            (out, flag), got = counted(lambda: wsync())
            check("weight sync full", out, flag, got,
                  derived("split_send", bucket.numel(), n_ws), bits_equal(out, v_new))
            (out, flag), got = counted(lambda: wsync(v_prev))
            want = derived("delta", bucket.numel(), n_ws)
            retried = bool(int(flag))
            if retried:  # the delta overflowed its widths: the escalation sends in full
                (out, flag), more = counted(lambda: wsync())
                got = {k: got[k] + more[k] for k in got}
                want = {k: want[k] + v for k, v in derived("split_send", bucket.numel(),
                                                           n_ws).items()}
            check("weight sync delta", out, flag, got, want, bits_equal(out, v_new))
            launches = kernels.launch_counts()
        recorded = (inputs, shape_tallies())

        # -- times: host clock to a device sync, median of 5 (not counted)
        ms = {"kv": {s: _wall_ms(lambda: kv(s), torch) for s in strategies},
              "gradient": {s: _wall_ms(lambda: grad(s), torch) for s in strategies}}
        ms["kv"]["raw"] = _wall_ms(lambda: kv("split_send", off, PlanCache()), torch)
        ms["gradient"]["raw"] = _wall_ms(lambda: grad("split_send", off), torch)
        ms["reducing receiver"] = {t: _wall_ms(lambda: grad("split_send", p, acc), torch)
                                   for t, p in pols.items()}
        ms["reducing receiver"]["raw + f32 add"] = _wall_ms(
            lambda: grad("split_send", off, acc), torch)
        ms["weight sync"] = {"full": _wall_ms(wsync, torch),
                             "delta": _wall_ms(lambda: wsync(v_prev), torch),
                             "raw": _wall_ms(lambda: sched.sync_weights_with_plan(
                                 v_new, group, perm, policy=off, cache=PlanCache()), torch)}
    if kv_cache.stats.misses != len(strategies) or kv_cache.stats.hits != 6 * len(strategies):
        raise AssertionError(f"kv plan cache after the repeats {kv_cache.cache_info()}")

    print(f"p2p: {ARCH} full width, one-rank NCCL group, perm [(0, 0)]; KV cache "
          f"({len(tree_flatten(cache)[0]) - 1} bf16 leaves of "
          f"{tuple(tree_flatten(cache)[0][0].shape)}, one bucket n={kv_b.length}) through "
          f"transfer_cache_with_plan under {', '.join(strategies)} and gated off, each "
          f"bit-identical, plan:kv ratio = plan ratio "
          f"({', '.join(f'{k} {v:.4f}' for k, v in ratios.items())}), "
          f"plan cache {len(strategies)} misses then hits; gradient bucket n={bucket.numel()} "
          f"through p2p_send_with_plan under each strategy and gated off, bit-identical; "
          f"reducing receiver fused and unfused bit-identical to acc + grad.float(); "
          f"weight sync full and delta (widths exp={ws_plan.buckets[0].delta_width} "
          f"lo={ws_plan.buckets[0].delta_lo_width}) bit-identical"
          f"{' after a full retry' if retried else ', delta flag 0'}; launches {launches}")
    print("  ms (host clock to a device sync, median of 5; at one rank the wire is NCCL's "
          "copy to itself, so the early lo-plane send can hide only that copy and these "
          "are the codec's schedule, not a network's): " + "; ".join(
              f"{part}: " + ", ".join(f"{k} {v:.2f}" for k, v in d.items())
              for part, d in ms.items()) + f"; card {run_card()}")
    return {"launches": launches, "recorded": recorded, "ms": ms, "ratios": ratios,
            "retried": retried}


OBS_COST_RUNS = 3  # on/off rounds of the observability cost (median of 3 each)
OBS_CALLS = 1000  # span and metric calls timed alone
OBS_SPANS = ("train:step", "plan:zero1", "plan:psum", "plan_cache:compile", "sync:publish",
             "sync:update", "sync:encode", "serve:admit", "serve:prefill", "serve:kv_ship",
             "serve:decode_step", "p2p:encode", "p2p:pack", "p2p:decode", "fleet:round")


def phase_obs(comp, psum, sync, dev, torch, np):
    """The observability layer over the port's paths at full width, in one
    fresh window (``obs.reset()`` inside one ``capture_wire_reports()``):
    one compressed train step through a new launcher's StepRunner, one
    psum_with_plan of the psum phase's gradient bucket, a weight-sync
    publish and a delta update of the sync phase's last two versions to a
    replica holding the older, one PD serve request (one packed KV
    shipment) on the trained model, one fleet wave (tree, fanout 2) of the
    newer version to N_FLEET replicas.  Checks each result, the launches
    (derived as in the earlier phases), the ledger against the window's
    reports (``check_ledger_exactness``), the plan totals against
    ``summarize_wire_reports`` and the Chrome trace parsed back; prints one
    ``{"obs": ...}`` line.  Then the cost of observability on the card: the
    train step and the weight-sync update with obs off and on, alternating,
    median of OBS_COST_RUNS each (host clock to a device sync), with the
    spans and metric observations each records; and, since the host's
    noise between runs exceeds that cost, the calls alone: a span's and a
    metric observation's host time (OBS_CALLS of each) and the sample
    store's on the weight-sync bucket (strided on the card; median of 3),
    from which each part's cost is estimated."""
    import collections
    import statistics
    import tempfile

    from repro_torch import kernels, obs, sched
    from repro_torch.core import codec
    from repro_torch.core.policy import CompressionPolicy, capture_wire_reports
    from repro_torch.launch import train as launch_train
    from repro_torch.obs import regret
    from repro_torch.roofline.analysis import summarize_wire_reports
    from repro_torch.runtime.fault_tolerance import RunnerConfig
    from repro_torch.sched.cache import PlanCache
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
    from repro_torch.sync import FleetConfig, SyncFleet, WeightSyncEngine, apply_update
    from repro_torch.tree_util import bits_equal, tree_flatten

    v_prev, v_new = sync["versions"]
    policy, bucket, model = sync["policy"], psum["bucket"], comp.state.model
    names = tuple(f"r{i}" for i in range(N_FLEET))
    ws_plan = sched.compile_wsync_plan(v_new, "data", policy=policy, n_dev=1)
    prompt = np.random.default_rng(SEED).integers(0, model.cfg.vocab, PROMPT).astype(np.int32)
    obs.set_enabled(True)
    with tempfile.TemporaryDirectory(prefix="obs_ckpt_") as tmp, \
            launch_train.single_process_group(dev) as group, launch_train.deterministic():
        state, _, runner, _ = launch_train.build(ARCH, batch=BATCH, seq=SEQ,
                                                 rcfg=RunnerConfig(ckpt_dir=tmp), device=dev,
                                                 seed=SEED, group=group)
        with capture_wire_reports() as captured, recorded_inputs(torch) as inputs, \
                fleet_record(ws_plan) as (encodes, applies, _):
            obs.reset()
            kernels.clear_launch_counts()
            state, losses = runner.train(state, num_steps=1, log_every=0)
            red, flag = sched.psum_with_plan({"g": bucket}, group, policy=CompressionPolicy(),
                                             cache=PlanCache())
            eng = WeightSyncEngine(policy=policy, plan_cache=PlanCache())
            eng.publish(v_prev)
            eng.ack("rollout", 1)  # the replica holds the older version
            eng.publish(v_new)
            upd = eng.update_for("rollout")
            held = apply_update(upd, base_params=v_prev, device=dev)
            srv = ServeEngine(model.cfg, model, ServeConfig(
                batch_slots=1, max_len=MAX_LEN, prefill_chunk=PROMPT, pd_disaggregated=True),
                kv_policy=CompressionPolicy(min_bytes=0), kv_plan_cache=PlanCache())
            srv.submit(Request(rid=0, prompt=prompt, max_new=4))
            (req,) = srv.run()
            fleet = SyncFleet(WeightSyncEngine(policy=policy, plan_cache=PlanCache()), names,
                              device=dev, cfg=FleetConfig(broadcast="tree", fanout=2,
                                                          ckpt_every_publishes=10 ** 9))
            fleet.publish(v_new)
            rounds = fleet.settle()
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
        recorded = (inputs, shape_tallies())
        if (losses[0] != losses[0] or int(flag) or not bits_equal(red["g"], bucket)
                or not bits_equal(held, v_new) or len(req.out) != 4
                or not all(0 <= t < model.cfg.vocab for t in req.out)
                or not fleet.verify_bitexact() or rounds != 1):
            raise AssertionError(f"obs window: loss {losses}, psum flag {int(flag)} "
                                 f"identical {bits_equal(red['g'], bucket)}, update "
                                 f"{upd.mode} identical {bits_equal(held, v_new)}, serve "
                                 f"{req.out}, fleet bit-exact {fleet.verify_bitexact()} in "
                                 f"{rounds} rounds")
        want = dict.fromkeys(kernels.KERNELS, 0)
        for k, v in two_shot_launches(True, True, 1).items():  # the step, the psum
            want[k] += 2 * v
        for k, v in fleet_launches(encodes, [*applies, upd.mode]).items():
            want[k] += v
        want["pack"] += 4  # the PD admission's shipment: k and v, two planes each
        want["unpack"] += 4
        if launches != want:
            raise AssertionError(f"obs window launches {launches}, derived {want}")

        exact = regret.check_ledger_exactness(captured)
        if not exact["ok"]:
            raise AssertionError(f"obs ledger != the window's reports: {exact['diffs']}")
        snap = obs.snapshot()
        summ = summarize_wire_reports([r for r in captured if r.name.startswith("plan:")])
        counters = snap["counters"]
        plan_totals = {k.split("=", 1)[1]: {
            "exec": n, "raw_bytes": counters["plan_wire_raw_bytes_total"].get(k, 0),
            "wire_bytes": counters["plan_wire_bytes_total"].get(k, 0)}
            for k, n in counters["plan_exec_total"].items()}
        summary = {name.split(":", 1)[1]: {"exec": d["n"], "raw_bytes": d["raw_bytes"],
                                            "wire_bytes": d["wire_bytes"]}
                   for name, d in summ["by_name"].items()}
        if plan_totals != summary or set(plan_totals) != {"zero1", "psum"}:
            raise AssertionError(f"plan totals {plan_totals} != summarize_wire_reports "
                                 f"{summary}")
        spans = collections.Counter(s.name for s in obs.spans())
        if not set(OBS_SPANS) <= set(spans) or spans["train:step"] != 1:
            raise AssertionError(f"obs spans {dict(spans)}, expected each of {OBS_SPANS}")
        path = obs.export_chrome_trace(os.path.join(obs.trace_dir(),
                                                    "trace_chip_smoke_obs.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        if len(events) != sum(spans.values()) or collections.Counter(
                e["name"] for e in events) != spans:
            raise AssertionError(f"the Chrome trace {path} holds {len(events)} events, the "
                                 f"span buffer {sum(spans.values())}")
        line = {
            "spans": dict(sorted(spans.items())), "ledger_exact": exact["ok"],
            "plan_totals": plan_totals, "summarize_wire_reports": summary,
            "ledger_by_kind": regret.ledger_totals()["by_kind"],
            "drift": obs.drift.detector().report().to_dict(),
            "regret_top3": [r.to_dict() for r in regret.width_regret()[:3]],
            "recorder_series": len(obs.recorder().series()),
            "trace": {"path": path, "bytes": os.path.getsize(path), "events": len(events)},
            "launches": launches, "update_mode": upd.mode}

        # -- the cost of observability: off and on, alternating, not counted
        batch = {k: torch.from_numpy(v) for k, v in runner.pipeline.batch_at(1).items()}

        def train_step_ms():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.run_step(state, batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        def update_ms():
            e = WeightSyncEngine(policy=policy, plan_cache=eng.plan_cache)
            e.publish(v_prev)
            e.ack("rollout", 1)
            e.publish(v_new)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.update_for("rollout")
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        def n_recorded():
            """(spans, metric observations) in the buffers so far."""
            rec = obs.recorder()
            return len(obs.spans()), sum(
                len(rec.samples(k.partition("|")[0], labels_key=k.partition("|")[2]))
                for k in rec.series())

        obs.reset()
        cost = {}
        for name, fn in (("train_step", train_step_ms), ("weight_sync_update", update_ms)):
            times = {False: [], True: []}
            for enabled in (False, True):  # a warm-up each
                obs.set_enabled(enabled)
                fn()
            for _ in range(OBS_COST_RUNS):
                for enabled in (False, True):
                    obs.set_enabled(enabled)
                    before = n_recorded()
                    times[enabled].append(fn())
                    calls = [b - a for a, b in zip(before, n_recorded())]
            obs.set_enabled(True)
            cost[name] = {"off_ms": statistics.median(times[False]),
                          "on_ms": statistics.median(times[True]),
                          "off_runs_ms": times[False], "on_runs_ms": times[True],
                          "spans": calls[0], "metric_observations": calls[1]}

        # -- the calls alone: host time of a span and of a metric observation,
        # and the sample store on the weight-sync bucket (a stride on the card,
        # then at most SAMPLE_MAX_ELEMS values to the host)
        t0 = time.perf_counter()
        for _ in range(OBS_CALLS):
            with obs.span("train:step"):
                pass
        span_us = (time.perf_counter() - t0) / OBS_CALLS * 1e6
        t0 = time.perf_counter()
        for _ in range(OBS_CALLS):
            obs.metric("plan_exec_total").inc(kind="zero1")
        metric_us = (time.perf_counter() - t0) / OBS_CALLS * 1e6
        ws_bucket = codec.pad_flat_bits(codec.concat_members(
            tree_flatten(v_new)[0], ws_plan.buckets[0].members), ws_plan.buckets[0].block)

        def sample_ms():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            regret.record_sample("wsync_host", "bfloat16", ws_bucket)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        sample_ms()
        sample = statistics.median(sample_ms() for _ in range(3))
        for name, c in cost.items():
            c["estimate_ms"] = (c["spans"] * span_us + c["metric_observations"] * metric_us) \
                / 1e3 + (sample if name == "weight_sync_update" else 0.0)
        line["cost"] = cost
        line["cost_parts"] = {"span_us": span_us, "metric_observation_us": metric_us,
                              "sample_store_ms": sample, "sample_of": ws_bucket.numel()}
        line["card"] = run_card()
        obs.reset()
    print(f"obs: one window at full width (a StepRunner train step, psum_with_plan of the "
          f"gradient bucket, a weight-sync {upd.mode} update, one PD KV shipment, a tree "
          f"wave to {N_FLEET} replicas): ledger exact, plan totals = summarize_wire_reports, "
          f"{len(events)} trace events; launches {launches}; obs cost, ms (median of "
          f"{OBS_COST_RUNS}, off -> on; the calls alone): " + ", ".join(
              f"{k} {v['off_ms']:.2f} -> {v['on_ms']:.2f} ({v['spans']} spans, "
              f"{v['metric_observations']} metric observations: {v['estimate_ms']:.3f})"
              for k, v in cost.items()))
    print(json.dumps({"obs": line}))
    return {"launches": launches, "recorded": recorded, "cost": cost}


def _time(fn, torch, runs=TIMED_RUNS, reps=1):
    """Median ms of one call of ``fn`` over ``runs`` windows of ``reps``
    calls (CUDA events around each window), after two warm-ups.  With one
    call a window (as the ``kernels`` line is timed) a call's host time
    before its launch counts; back-to-back calls hide it."""
    fn(), fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return sorted(times)[len(times) // 2]


def _time_once(fn, torch):
    """(ms, result) of ONE run of ``fn`` (CUDA events, no warm-up): for the
    plain rANS versions, one torch step per row, which take seconds."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


# Peak rates for the bound: f32 outside the tensor cores; the integer
# operations of the rANS kernels are counted at the same rate, which the
# card's int32 rate does not exceed, so the bound stays a lower bound.
PEAK_OPS = 67e12


def phase_times(comp, serve, sync, psum, p2p, fleet, obs_run, dev, torch, np, worst, bw):
    """Each kernel and its plain version at the shapes its path gives it:
    encode_fused, decode_reduce and plane_split at the main path's AG
    bucket; pack and unpack at one KV leaf's exponent residuals at the plan's
    width; encode_fused, decode_reduce, pack and unpack also at every shape
    the runs launched them at, on the runs' recorded inputs; rANS encode
    and the compacted-stream decode at one KV leaf's exponent plane.  Each
    kernel is checked against its plain version on these inputs first."""
    from repro_torch import kernels
    from repro_torch.core import ans, codec, packing
    from repro_torch.core.calibrate import CompressionProfile
    from repro_torch.kernels import bitpack, rans, ref
    from repro_torch.kernels import decode_reduce as dr
    from repro_torch.kernels import encode_fused as ef
    from repro_torch.kernels import plane_split as ps
    from repro_torch.optim import zero1

    # launches of each main-path run (counts set to 0 just before each)
    runs = {"serve_pd": serve["pd_launches"], "serve_pd_rans": serve["rans_launches"],
            "train": comp.launches, "psum": psum["launches"], "weight_sync": sync["launches"],
            "p2p": p2p["launches"], "fleet": fleet["launches"], "obs": obs_run["launches"]}
    per_unit = {"serve_pd": ("pd_admission", N_REQ),
                "serve_pd_rans": ("pd_rans_admission", N_RANS),
                "train": ("train_step", STEPS), "psum": ("psum_phase", 1),
                "weight_sync": ("publish", sync["n_publishes"]), "p2p": ("p2p_phase", 1),
                "fleet": ("fleet_phase", 1), "obs": ("obs_phase", 1)}
    rows = []

    def row(name, *, ms, plain_ms, nbytes, ops, err, **extra):
        by_run = {r: c[name] for r, c in runs.items() if c[name]}
        bytes_ms, ops_ms = nbytes / bw * 1e3, ops / PEAK_OPS * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kernels.SOURCES[kernels.KERNELS[name]]}",
            "replaces": REPLACES[name], "launches": sum(by_run.values()),
            "launches_by_run": by_run,
            "launches_per": {per_unit[r][0]: c / per_unit[r][1] for r, c in by_run.items()},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, **extra})
        shown = {k: v for k, v in extra.items() if k != "shapes"}
        print(f"times: {name} {shown}: {ms:.4f} ms (plain {plain_ms:.3f} ms), bound "
              f"{max(bytes_ms, ops_ms):.4f} ms = {nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s")

    def same(name, got, want):
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version at the path's shape")

    # -- encode_fused, decode_reduce, pack and unpack at each shape a run
    # launched them at, held against the plain version on each run's first
    # input of the shape (recorded_inputs) and timed once a shape; every
    # launch a run tallied must be at a recorded shape
    recorded = {**serve["recorded"], "train": comp.recorded, "psum": psum["recorded"],
                "weight_sync": sync["recorded"], "p2p": p2p["recorded"],
                "fleet": fleet["recorded"], "obs": obs_run["recorded"]}

    def encode_cost(x, w, blk):
        n, lo_w = x.numel(), codec.layout_of(x.dtype).lo_bits
        return n * x.element_size() + n // 32 * (w + lo_w) * 4 + n // blk * 8, 0

    per_shape = {  # kernel: (wrapper, plain version, (bytes, operations) of its args)
        "encode_fused": (ef.encode_fused, ref.encode_fused, encode_cost),
        "decode_reduce": (dr.decode_reduce, ref.decode_reduce, lambda pay, lo, gb, a, dt, w: (
            pay.shape[0] * (w + lo.shape[1] + 1) * 4 + a.numel() * 8, a.numel())),
        "pack": (bitpack.pack, ref.pack, lambda vals, w: (
            vals.numel() * vals.element_size() + vals.numel() // 32 * w * 4, 0)),
        "unpack": (bitpack.unpack, ref.unpack, lambda words, w: (
            words.shape[0] * w * 4 + words.shape[0] * 32 * 4, 0))}

    def held(name, kernel, plain, args):
        """Check the kernel on ``args``; returns a call of it to time."""
        if name == "decode_reduce":  # in place: each call on its own accumulator
            pay_, lo_, gb_, acc_, dt_, w_ = args
            if not same_f32(kernel(pay_, lo_, gb_, acc_.clone(), dt_, w_), plain(*args),
                            torch)[0]:
                raise AssertionError(f"decode_reduce differs from plain at {args[-2:]}")
            work_ = acc_.clone()
            return lambda: kernel(pay_, lo_, gb_, work_, dt_, w_)
        got_, want_ = kernel(*args), plain(*args)
        same(name, got_ if name == "encode_fused" else [got_],
             want_ if name == "encode_fused" else [want_])
        return lambda: kernel(*args)

    path_shapes = {}
    for name, (kernel, plain, cost) in per_shape.items():
        by_shape = {}  # shape -> (the first run's input, {run: launches})
        for r, (inputs, tallies) in recorded.items():
            tally = tallies[name]
            if not set(tally) <= set(inputs[name]) or sum(tally.values()) != runs[r][name]:
                raise AssertionError(f"{r} {name}: launches tallied at {tally}, inputs "
                                     f"recorded at {list(inputs[name])}, {runs[r][name]} "
                                     f"launches")
            for shape, count in tally.items():
                call = held(name, kernel, plain, inputs[name][shape])
                by_shape.setdefault(shape, (inputs[name][shape], call, {}))[2][r] = count
        path_shapes[name] = {}
        for shape, (args, call, by) in by_shape.items():
            nbytes, ops = cost(*args)
            bytes_ms, ops_ms = nbytes / bw * 1e3, ops / PEAK_OPS * 1e3
            key = "_".join(str(v).removeprefix("torch.") for v in shape)
            path_shapes[name][key] = entry = {
                "launches": sum(by.values()), "launches_by_run": by,
                "ms": _time(call, torch), "plain_ms": _time(lambda a=args: plain(*a), torch),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            print(f"times: {name} at {key}: {entry}")

    # -- the main path's AG input: the trained bf16 parameter bucket ---------
    meta = comp.state.meta
    x = zero1.flatten_buckets(meta, comp.state.model.leaves())[0].contiguous()
    n, block = x.shape[0], meta.block
    width = CompressionProfile.default().width_for("weight")
    lo_bits = codec.layout_of(x.dtype).lo_bits
    got = ef.encode_fused(x, width, block)
    same("encode_fused", got, ref.encode_fused(x, width, block))
    pay, lo, bases, _ = got
    gb = bases.repeat_interleave(block // packing.GROUP)
    acc = torch.from_numpy(np.random.default_rng(1).normal(0, 1e-3, n).astype(
        np.float32)).to(dev)
    ok, dec_err = same_f32(dr.decode_reduce(pay, lo, gb, acc.clone(), "bfloat16", width),
                           ref.decode_reduce(pay, lo, gb, acc, "bfloat16", width), torch)
    if not ok:
        raise AssertionError("decode_reduce differs from plain at the main path shape")
    work = acc.clone()
    ag = {"n": n, "width": width, "dtype": "bfloat16"}
    row("encode_fused", ms=_time(lambda: ef.encode_fused(x, width, block), torch),
        plain_ms=_time(lambda: ref.encode_fused(x, width, block), torch),
        nbytes=n * 2 + n // 32 * (width + lo_bits) * 4 + n // block * 8, ops=0,
        err=0.0, **ag, shapes=path_shapes["encode_fused"])
    row("decode_reduce",
        ms=_time(lambda: dr.decode_reduce(pay, lo, gb, work, "bfloat16", width), torch),
        plain_ms=_time(lambda: ref.decode_reduce(pay, lo, gb, acc, "bfloat16", width), torch),
        nbytes=n // 32 * (width + lo_bits + 1) * 4 + n * 8, ops=n,
        err=max(dec_err, worst["decode_reduce"]), **ag, shapes=path_shapes["decode_reduce"])
    # plane_split at the same bucket: no path of the reference runs it
    same("plane_split", ps.split_with_stats(x, block), ref.split_with_stats(x, block))
    row("plane_split", ms=_time(lambda: ps.split_with_stats(x, block), torch),
        plain_ms=_time(lambda: ref.split_with_stats(x, block), torch),
        nbytes=n * 2 + n * 8 + n // block * 8, ops=0, err=0.0, n=n, dtype="bfloat16")

    # -- one shipped KV leaf: exponent residuals at the plan's width ---------
    leaf, kv_w = serve["leaf"], serve["width"]
    exp, _ = codec.split_planes(leaf.reshape(-1))
    resid = packing.block_residuals(exp, width=kv_w, block=512)[3]
    n_kv = resid.shape[0]
    kv_pay = bitpack.pack(resid, kv_w)
    same("pack", [kv_pay], [ref.pack(resid, kv_w)])
    same("unpack", [bitpack.unpack(kv_pay, kv_w)], [ref.unpack(kv_pay, kv_w)])
    row("pack", ms=_time(lambda: bitpack.pack(resid, kv_w), torch),
        plain_ms=_time(lambda: ref.pack(resid, kv_w), torch),
        nbytes=n_kv * resid.element_size() + n_kv // 32 * kv_w * 4, ops=0, err=0.0,
        n=n_kv, width=kv_w, input="uint8 residuals of one KV leaf",
        shapes=path_shapes["pack"])
    row("unpack", ms=_time(lambda: bitpack.unpack(kv_pay, kv_w), torch),
        plain_ms=_time(lambda: ref.unpack(kv_pay, kv_w), torch),
        nbytes=n_kv // 32 * kv_w * 4 + n_kv * 4, ops=0, err=0.0,
        n=n_kv, width=kv_w, input="payload of one KV leaf", shapes=path_shapes["unpack"])

    # -- rANS: the exponent plane of one KV leaf, 128 lanes ------------------
    n_e, lanes = exp.shape[0], 128
    per = -(-n_e // lanes)
    syms = torch.zeros(per * lanes, dtype=torch.uint8, device=dev)
    syms[:n_e] = exp
    syms = syms.reshape(per, lanes)
    table = ans.build_freq_table(exp)
    s2s = ans._slot_to_symbol(table)
    enc_plain_ms, want = _time_once(lambda: ref.rans_encode(syms, table.freq, table.cum, n_e),
                                    torch)
    same("rans_encode", rans.encode(syms, table.freq, table.cum, n_e), want)
    stream = ans.encode(exp, table)
    dec_plain_ms, want = _time_once(lambda: ref.rans_decode_stream(
        stream.words, stream.lens, table.freq, table.cum, s2s, per, n_e), torch)
    got = rans.decode_stream(stream.words, stream.lens, table.freq, table.cum, s2s, per, n_e)
    same("rans_decode", [got, got.reshape(-1)[:n_e]], [want, exp])
    used = int(stream.lens.sum())
    rx = {"n": n_e, "per": per, "lanes": lanes, "plain_runs": 1}
    tables = 2 * 256 * 4
    enc = lambda: rans.encode(syms, table.freq, table.cum, n_e)  # noqa: E731
    dec = lambda: rans.decode_stream(  # noqa: E731
        stream.words, stream.lens, table.freq, table.cum, s2s, per, n_e)
    mhz = sm_clock_under(lambda: (enc(), dec()), torch)
    floor = chain_floors(table, s2s, syms, stream, per, mhz, torch)
    row("rans_encode", ms=_time(enc, torch), plain_ms=enc_plain_ms,
        nbytes=per * lanes * (1 + 4 + 4) + lanes * 4 + tables, ops=10 * n_e, err=0.0,
        tables_ms=_time(lambda: rans.encode_table(table.freq, table.cum), torch),
        **floor["encode"], **rx)
    row("rans_decode", ms=_time(dec, torch), plain_ms=dec_plain_ms,
        nbytes=used * 2 + lanes * 4 + tables + ans.M + per * lanes, ops=8 * n_e, err=0.0,
        tables_ms=_time(lambda: rans.slot_table(table.freq, table.cum, s2s), torch),
        stream_words=used, **floor["decode"], **rx)
    for r in rows[-2:]:
        if not 0 < r["floor_ms"] <= r["ms"]:
            raise AssertionError(f"{r['name']}: floor {r['floor_ms']:.4f} ms outside "
                                 f"(0, {r['ms']:.4f} ms]: the chain probe is wrong")
    return rows


def chain_floors(table, s2s, syms, stream, per, mhz, torch) -> dict:
    """floor_ms of each rANS kernel at ``per`` steps a lane: ``per`` times
    the SM cycles of one step of one lane's chain alone (``rans.chain``: the
    kernel's own step in one thread, with the symbols of lane 0's first rows
    or the first words of its stream in registers; clock64 over ``per``
    steps, median of 5) at ``mhz``.  The lane count (128) is the wire
    format, so the lanes cannot be cut shorter: with this build's step, no
    kernel of this format takes less."""
    from repro_torch.kernels import rans

    w0 = stream.words[0].view(torch.int16).to(torch.int64) & 0xFFFF
    n0 = int(stream.lens[0])
    args = (table.freq, table.cum, s2s, syms[:8, 0].contiguous(), stream.words[0, :8],
            int(w0[n0 - 2]) | int(w0[n0 - 1]) << 16)
    steps = -(-per // 8) * 8
    out = {}
    for kind in ("encode", "decode"):
        got, _ = rans.chain(kind, *args, steps)
        if not torch.equal(got.cpu(), rans.plain_chain(kind, *args, steps)):
            raise AssertionError(f"rans chain {kind} differs from its plain version")
        runs = sorted(rans.chain(kind, *args, steps)[1] / steps for _ in range(5))
        cycles = runs[2]
        out[kind] = {"floor_ms": per * cycles / (mhz * 1e3), "floor_by": "chain", "floor": {
            "measured": "rans.chain: clock64 over per steps of one lane's chain "
                        "in one thread, median of 5",
            "cycles_per_step": cycles, "cycles_per_step_runs": runs, "sm_clock_mhz": mhz}}
    return out


def sm_clock_under(fn, torch, runs=200):
    """The SM clock (MHz) that nvidia-smi reads while ``runs`` calls of
    ``fn``, queued on the card, run."""
    for _ in range(runs):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    torch.cuda.synchronize()
    return float(out.split()[0])


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
    phase_check_wire(dev, torch, np)
    serve = phase_serve(dev, torch, np)
    comp, psum = phase_main(dev, torch)
    sync = phase_sync(dev, torch)
    fleet = phase_fleet(sync, dev, torch)
    p2p = phase_p2p(serve, psum, sync, dev, torch)
    obs_run = phase_obs(comp, psum, sync, dev, torch, np)
    rows = phase_times(comp, serve, sync, psum, p2p, fleet, obs_run, dev, torch, np, worst,
                       card_bandwidth(name))
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
