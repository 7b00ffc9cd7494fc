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
3b. serve_sampled - the same requests sampled at temperature 0.8
            (ServeConfig.temperature; each engine's generator on the card,
            seeded 0): colocated, PD-disaggregated, colocated again, then
            colocated reseeded 1.  PD and both seed-0 runs give identical
            tokens, seed 1 others; the first admission round's tokens equal
            a plain Gumbel-max draw over their prefill logits, and 16 384
            draws from one request's logits give softmax's mean logit
            within 5 standard errors; the PD run launches pack and unpack
            4 a request.
4. main   - smollm_135m at full width, ZeRO-1 on a single-rank NCCL group
            through the launcher's (pod, data, model) = (1, 1, 1) mesh,
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
            (save and restore ms).  The run's plans are saved beside the
            checkpoint (CheckpointManager.save_plans) and restored into a
            fresh PlanCache; the resumed step replays its zero1 plan from
            it: 0 misses, 1 hit.  The mesh part (phase_mesh, no launches):
            the spec-derived per-device bytes of smollm's parameters and
            ZeRO-1 state on the mesh equal the card's; the checkpoint
            (the reference's global layout) restored onto a new (1, 1, 1)
            mesh through ElasticController.rescale bit-identical; one
            `mesh_layouts:` line of the 11 archs' per-device parameter
            (training and serving specs), ZeRO-1 state and KV cache (8 x
            4096) bytes at (16, 16) and (2, 16, 16).  Then
            where a compressed step's time goes: forward+backward and each
            wire phase beside its raw twin (host clock, synchronised).
            Forward+backward is timed with each layer rematerialised (the
            launcher's TrainConfig.remat default) and without.
   train_file - on the same group, a token file of 2**20 seed-0 tokens
            (uint16; written under a temporary directory) feeds a compressed
            and a raw twin of 2 steps at 8 x 512 through the launcher's
            ZeRO-1 path (the pipeline's file backend): every batch equals
            numpy's reading of the file; losses and final parameters
            identical; two_shot_launches a compressed step.
   roofline - one ZeRO-1 step of the main run (a copy of its state, its
            plan): its FLOPs counted by FlopCounterMode (remat replays
            included), its collective bytes from a torch.profiler trace
            (roofline.analysis.collective_bytes: the traced all-to-all and
            all-gather bytes equal the plan:zero1 wire), its WireReports
            from the module ledger (clear_wire_reports, one step,
            wire_reports) and its time (median of 5); a cell JSON and its
            trace read back by roofline.report.collect.  Prints the markdown
            row and the step's share of the card's bf16 peak.  One more
            step gives the arguments' bytes (state and batch) and the peak
            the card allocates above what was allocated before it.
   dryrun - the dry run (launch/dryrun) on the CPU, no card involved:
            tinyllama_1_1b train_4k at (16, 16) as rank 0 of a fake world
            of 256 on fake tensors, through its CLI in a process of its own
            started after the build (no card visible to it) and run beside
            the phases before this one; its JSON and trace read by
            roofline.report.collect (arguments and temp a device, FLOPs,
            wire ratio, collective bytes, the row).  Then, after the main
            phase's group is gone, the roofline phase's step (its TrainConfig, 8 x 512, (1,
            1, 1)) once on fake tensors by the same tracker and counter:
            its arguments' bytes equal the card's state and batch, its
            FLOPs the roofline phase's count, its all-to-all and all-gather
            bytes the plan:zero1 wire, and the card's peaks of a forward
            and backward and of the step lie within DRYRUN_PEAK_* of the
            tracked ones (all printed).
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
4b. fsdp  - smollm_135m at full width, compressed FSDP (partition="fsdp", 2
            microbatches, remat) on a new single-rank NCCL group through a
            (1, 1, 1) mesh, batch 8 x
            seq 512: 2 compressed steps, then 2 of the raw twin from the same
            weights, through the launcher's StepRunner.  The 7 stacked
            projections and the embedding are sharded (fsdp_min_bytes 1
            MiB; the norms stay replicated), each gathered on a cached
            fsdp_gather plan: 4 signatures ((576, 576), (192, 576), (1536,
            576), (49152, 576), the sharded dim moved last), so each run's
            plan cache holds 4 misses and every other gather hits.  A step
            (fsdp_work): per microbatch 7 x 30 + 1 = 211 forward gathers,
            210 more in the rematerialised backward and 211 reduce-scatters;
            launches (fsdp_launches) an all-gather encode_fused 1 and unpack
            2, a reduce-scatter encode_fused 1, decode_reduce 1 and unpack 1;
            the raw twin none.  Losses and the final train state (shards and
            moments) identical.  Prints the step ms of both twins beside the
            main phase's ZeRO-1 steps, the AG and RS wire ratios, and the
            all-gather decodes' ms a step (each signature's decode, median
            of 5, times its gathers) and its share of the compressed step.
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
5b. sync_strategies - the sync run's last two versions through a
            WeightSyncEngine under split_send and under encode_send: a full
            update, an ack, a delta, each applied bit-identical on the card;
            each plan records its strategy; the updates' bytes and checksums
            identical; encode_fused 1, pack 2, unpack 4 an engine.
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
            and the calls alone.  Prints one {"obs": ...} line.  Then
            obs.dump.run on the card (the twin of the reference's
            benchmarks/run.py key "obs": 3 smoke train steps and 3
            weight-sync publishes) with REPRO_TRACE_DIR at a temporary
            directory: its three lines, its five files, a Chrome trace with
            train:step, plan:* and sync:* spans, metrics and report JSON that
            parse; its launches count as the run "obs_dump".
9. times  - each kernel and its plain version at the shapes its path
            gives it: encode_fused, decode_reduce and plane_split at the
            AG bucket, pack and unpack at one KV leaf (the row's ms), and
            encode_fused, decode_reduce, pack and unpack also at every
            shape any run of phases 3-8 (fsdp included) launched them at
            (``shapes``): each
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
10. zoo   - then every earlier phase's state is freed (only the kernels
            rows stay) and the dense zoo runs at full width, each model
            drawn on the card by a CUDA generator seeded 0, run, and freed
            before the next, its peak memory printed: glm4-9b at full depth
            (40 layers, 9.40 B parameters) and gemma3-27b (2 prefix
            layers, then 10 x (5 local layers, window 1024, and 1 global),
            tied, 27.0 B, at full depth; a model whose bf16 weights pass
            the free memory fails the phase) each serve greedy requests
            (glm4 4 x 512 + 32 tokens on 4 slots, max_len 1024; gemma3 2 x 1536 + 16 on
            2 slots, max_len 2048: the prompts pass the window) colocated,
            then PD over the packed host KV wire (a fresh PlanCache: 1
            miss, then hits): identical tokens; each admission packs and
            unpacks each cache leaf twice (glm4 2 leaves, gemma3 16 of two
            shapes); one prefilled cache shipped bit-identical (pack and
            unpack ms, wire ratio); tokens/s of each mode.  qwen2-vl-72b at
            full width, its repeats cut to 2 (80 layers to 2): one prefill
            of 2 x 512 tokens whose first 128 positions are
            registry.make_batch's vision_embeds, its cache over the host
            wire bit-identical (pack and unpack 4 each), 8 greedy decode
            steps from the shipped and the original cache identical.
            tinyllama-1.1b at full width and depth through the launcher's
            ZeRO-1 path (batch 8 x 512, remat): 2 compressed steps, then 2
            raw; loss bits and final parameters identical; one bf16 bucket
            of ~1.1 G values; launches two_shot_launches a step.  Each
            run's launches are counted from 0 and its kernels held bit for
            bit against their plain versions on its recorded inputs and
            timed at each new shape (time_path_shapes), inside the phase;
            merge_zoo adds both to the kernels rows.

tp - ZeRO-1 and FSDP with tensor and expert parallelism over 'model'
            (TP_JOBS):
            the card has one H100 and NCCL refuses two ranks on one device,
            so each job's ranks are processes of their own on cuda:0 over a
            gloo group (a FileStore in a temporary directory), each capped
            by torch.cuda.set_per_process_memory_fraction; the kernels are
            built by this process first and the ranks only load them.
            tinyllama-1.1b at full width, 3 of its 22 layers, on (data,
            model) = (2, 2), 8 x 512 global, and
            deepseek-v2-lite at full width cut to
            its dense prefix and one MoE layer on (1, 2), 32 of its 64
            experts a rank: each rank runs the launcher's ZeRO-1 path,
            compressed then raw; every rank's twins bit-identical (losses,
            grad norms, a sha256 of every local leaf), launches
            two_shot_launches a step and bucket; each job's first loss
            within its loss_rel (tinyllama 2e-4, deepseek 1e-3) and its
            first grad norm within its gnorm_rel (1e-2, 2e-2) of its model
            at model = 1 in this process (the same seed and batch; the norm counting each leaf
            'model' replicates once a model rank).  Rank 0's kernel inputs come back, are held
            against the plain versions and timed at every shape any rank
            tallied; the jobs' launches join the kernels line (merge_zoo).
            Step times cross the host through gloo and say nothing about
            NVLink.  Two more jobs: jamba-v0.1-52b at full width, cut to
            its pattern positions 3-4, (Mamba, MoE) then (attention,
            SwiGLU) (3.67 B parameters), trained FSDP at (2, 2) on
            Adafactor (AdamW's moments do not fit a quarter of the card),
            4 x 512, 2 + 2 steps (Mamba over its inner channels, 8 of 16 experts a
            model rank, each rank's gathers of its model-local blocks over
            'data'; launches fsdp_launches of the plan's fsdp_work a step;
            the grad norm against model = 1 counting each leaf once); and
            xlstm-350m at full width, one period (7 mLSTM + 1 sLSTM), ZeRO-1
            at (1, 2), 2 of its 4 heads a rank, 8 x 128, 2 + 2 steps.  Their
            bounds (TP_JAMBA_*, TP_XLSTM_*) come from tools/rehearse_tp.py,
            the phase rehearsed on the CPU at SMOKE size.  The serve jobs
            (tp_serve_*): ServeEngine at (1, 2), colocated then PD, held
            against the model at model = 1.  tp_serve_deepseek also ingests:
            this process makes a full update of the job's weights at model
            = 1 and, after a seeded change (TP_INGEST_CHANGE), a delta
            (WeightSyncEngine.update_for); after their serve runs both ranks
            ingest each (ServeEngine.ingest_weights at model > 1); every
            rank's blocks have the sha256 of its blocks of the decoded whole
            leaves, every rank holds the same version and epoch, a corrupted
            copy is refused with the blocks untouched, and PD tokens on the
            new weights equal the colocated ones on both ranks; unpack
            twice a piece of a compressed bucket (a rank decodes a bucket
            2**24 values at a time), rank 0's inputs timed, the
            launches in the kernels line (tp_serve_deepseek_ingest).  Prints
            each update's ratio and apply ms a rank.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``kernels`` JSON.  Any failed phase exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time
import types

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
TEMPERATURE = 0.8  # the sampled serve run's temperature
# draws of the sampler's distribution check, in chunks of SAMPLE_CHUNK rows
SAMPLE_DRAWS, SAMPLE_CHUNK = 16384, 4096
FILE_STEPS, FILE_TOKENS = 2, 1 << 20  # the file-fed twins' steps and token file
ROOFLINE_STEPS = 5  # timed steps of the roofline phase (median), after one untimed
SYNC_STRATEGIES = ("split_send", "encode_send")


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
def recorded_inputs(torch, host: bool = False):
    """While active, the wrappers of SHAPED keep a copy of the arguments of
    their first launch at each shape, under the shape the launch was
    tallied at (``kernels.launch_shapes``): ``{kernel: {shape: args}}``, the
    inputs the path gives each kernel (``host``: the copies in host memory,
    for a run that needs the card's; ``time_path_shapes`` moves them back).
    A launch that does not go through the wrapper's module attribute is
    tallied and not recorded, which the caller's comparison of the two
    shows."""
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
                (a.to("cpu", copy=True) if host else a.clone())
                if isinstance(a, torch.Tensor) else a for a in args)
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


def phase_serve_sampled(dev, torch, np):
    """smollm_135m at full width and depth sampling at TEMPERATURE: the serve
    phase's requests colocated, then PD-disaggregated, then colocated again,
    each engine's generator as the engine seeds it (0), then colocated with
    it reseeded to 1.  PD and both seed-0 runs give identical tokens; seed 1
    others.  The first admission round's tokens (one prefill draw each, no
    decode step between them) are held against a plain Gumbel-max draw over
    the same prefill logits with a fresh generator seeded 0.  The
    distribution: SAMPLE_DRAWS draws of ``sample`` on the card from the first
    request's prefill logits z (scaled by 1/TEMPERATURE); the mean z of the
    drawn tokens is within 5 standard errors of its expectation under
    ``softmax(z)``, and that expectation is more than 5 from the plain mean
    of z, which a sampler ignoring the logits would give.  The PD run
    launches pack and unpack 4 a request, as the greedy one."""
    from repro_torch import configs, kernels
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    from repro_torch.sched.cache import PlanCache
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine, sample

    cfg = configs.get(ARCH)
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(SEED),
                             device=dev)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, PROMPT).astype(np.int32)
               for _ in range(N_REQ)]

    def serve(pd, reseed=None):
        scfg = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, prefill_chunk=PROMPT,
                           temperature=TEMPERATURE, pd_disaggregated=pd)
        eng = ServeEngine(cfg, model, scfg, kv_plan_cache=PlanCache() if pd else None,
                          kv_policy=CompressionPolicy(min_bytes=0) if pd else None)
        if reseed is not None:
            eng.generator.manual_seed(reseed)
        if eng.generator.device.type != dev.type:
            raise AssertionError(f"the sampler's generator is on {eng.generator.device}")
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=MAX_NEW))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        return sorted((r.rid, tuple(r.out)) for r in done), time.perf_counter() - t0

    with launch_train.deterministic():
        kernels.clear_launch_counts()
        col, t_col = serve(False)
        col_launches = kernels.launch_counts()
        with recorded_inputs(torch) as inputs:
            kernels.clear_launch_counts()
            pd, t_pd = serve(True)
            pd_launches = kernels.launch_counts()
        recorded = (inputs, shape_tallies())
        again, _ = serve(False)
        other, _ = serve(False, reseed=1)
        # the plain draw: the first SLOTS requests are admitted in order, one
        # (1, vocab) draw each from the fresh generator, before any decode step
        gen = torch.Generator(dev).manual_seed(0)
        tiny = torch.finfo(torch.float32).tiny
        plain, last = [], []
        for p in prompts[:SLOTS]:
            logits, _ = transformer.prefill(
                model, torch.from_numpy(p[None].astype(np.int64)).to(dev),
                transformer.init_cache(cfg, 1, MAX_LEN, dev))
            last.append(logits[:, -1])
            scaled = logits[:, -1].float() / TEMPERATURE
            u = torch.rand(scaled.shape, generator=gen, device=dev, dtype=torch.float32)
            gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
            plain.append(int(torch.argmax(scaled + gumbel, dim=-1)[0]))
    firsts = [o[0] for _, o in col[:SLOTS]]
    if firsts != plain:
        raise AssertionError(f"first sampled tokens {firsts} differ from the plain "
                             f"Gumbel-max draw over the prefill logits {plain}")
    z = last[0][0].float() / TEMPERATURE
    p = torch.softmax(z, -1)
    want_z = float((p * z).sum())
    se = float(((p * z * z).sum() - want_z ** 2).sqrt()) / SAMPLE_DRAWS ** 0.5
    gen = torch.Generator(dev).manual_seed(SEED)
    drawn = torch.cat([sample(last[0].expand(SAMPLE_CHUNK, -1), TEMPERATURE, gen)
                       for _ in range(SAMPLE_DRAWS // SAMPLE_CHUNK)])
    if drawn.device.type != dev.type or drawn.dtype != torch.int32 \
            or drawn.shape != (SAMPLE_DRAWS,):
        raise AssertionError(f"draws {drawn.device} {drawn.dtype} {tuple(drawn.shape)}")
    mean, flat = float(z[drawn.long()].mean()), float(z.mean())
    if abs(mean - want_z) > 5 * se or want_z - flat <= 5 * se:
        raise AssertionError(f"mean drawn z {mean} against softmax's {want_z} (plain mean "
                             f"{flat}, standard error {se})")
    if pd != col or again != col:
        raise AssertionError(f"sampled tokens differ at one seed: colocated {col}, PD {pd}, "
                             f"again {again}")
    if other == col:
        raise AssertionError("seeds 0 and 1 sampled the same tokens")
    if len(col) != N_REQ or any(len(o) != MAX_NEW or not all(0 <= t < cfg.vocab for t in o)
                                for _, o in col):
        raise AssertionError(f"unexpected sampled output {col}")
    expect = dict.fromkeys(kernels.KERNELS, 0)
    expect.update(pack=4 * N_REQ, unpack=4 * N_REQ)
    if pd_launches != expect or any(col_launches.values()):
        raise AssertionError(f"sampled serve launch counts {pd_launches} (colocated "
                             f"{col_launches}), expected {expect}")
    n_tok = N_REQ * MAX_NEW
    differ = sum(a != b for (_, x), (_, y) in zip(col, other) for a, b in zip(x, y))
    print(f"serve_sampled: {ARCH} full width, {N_REQ} requests x {PROMPT} + {MAX_NEW} "
          f"tokens at temperature {TEMPERATURE}, {SLOTS} slots; PD tokens identical to "
          f"colocated, a second seed-0 run identical, seed 1 differs in {differ} of "
          f"{n_tok} tokens; the first {SLOTS} requests' first tokens equal the plain "
          f"draw over their prefill logits; {SAMPLE_DRAWS} draws from the first request's "
          f"logits: mean z {mean:.5f} against softmax's {want_z:.5f} "
          f"({(mean - want_z) / se:+.2f} standard errors; the plain mean {flat:.5f} is "
          f"{(want_z - flat) / se:.1f} away); launches {pd_launches}; tokens/s colocated "
          f"{n_tok / t_col:.1f}, PD {n_tok / t_pd:.1f}")
    return {"launches": pd_launches, "recorded": recorded,
            "tok_s": {"colocated": n_tok / t_col, "pd": n_tok / t_pd}}


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
    from repro_torch.core import codec, packing
    from repro_torch.optim import zero1
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.fault_tolerance import RunnerConfig
    from repro_torch.train import step as step_lib

    from repro_torch.launch import mesh as mesh_lib

    runs = {}
    tmp = tempfile.TemporaryDirectory(prefix="main_ckpt_")
    hb = os.path.join(tmp.name, "heartbeat.json")
    # the compressed run checkpoints the state after its last step, once
    rcfg = RunnerConfig(ckpt_dir=tmp.name, ckpt_every=STEPS - 1, heartbeat_path=hb)
    with launch_train.single_process_group(dev) as group, tmp:
        # the launcher's mesh: (pod, data, model) = (1, 1, 1) over the world
        mesh = mesh_lib.make_mesh((1, 1, 1), ("pod", "data", "model"), device=dev)
        n_dp = torch.distributed.get_world_size(group)
        for compress in (True, False):
            with recorded_inputs(torch) as inputs, checkpoint_writes() as writes:
                kernels.clear_launch_counts()
                runs[compress] = launch_train.train(
                    ARCH, steps=STEPS, batch=BATCH, seq=SEQ, compress=compress,
                    device=dev, seed=SEED, mesh=mesh, rcfg=rcfg if compress else None)
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
        # the AG bucket's exponent plane as the last step's all-gather sent it
        ag = pair.ag
        bucket = zero1.flatten_buckets(comp.state.meta, comp.state.model.leaves())[0]
        ag_bits = packing.pack_exponents(codec.split_planes(bucket)[0], width=ag.width,
                                         block=ag.block, exc_frac=ag.exc_frac
                                         ).wire_bits_per_element()
        del bucket
        print(f"main: {ARCH} full width, ZeRO-1 n_dp={n_dp} over the mesh "
              f"{mesh_lib.axis_sizes(mesh)} (sync axes {comp.state.axes}), batch {BATCH} x "
              f"seq {SEQ}, bucket n={comp.state.meta.padded[0]}")
        print(f"  compressed losses {comp.losses} step_ms "
              f"{[round(t, 1) for t in comp.step_ms]} retries {comp.retries}")
        print(f"  raw twin   losses {raw.losses} step_ms {[round(t, 1) for t in raw.step_ms]}")
        print("  zero1 plan cache (misses, hits): " + ", ".join(
            f"{tag} {mh}" for tag, mh in cached.items()))
        print(f"  wire ratio RS {pair.rs.ratio:.4f} AG {pair.ag.ratio:.4f} (exponent plane "
              f"{ag_bits:.4f} bits/element at width {ag.width}; plan:zero1 "
              f"{comp.wire_reports[0].ratio:.4f}); launches {comp.launches}; "
              f"losses and final parameter bytes identical")
        phase_checkpoint(comp, group, hb, dev, torch)
        phase_mesh(comp, mesh, dev, torch)
        phase_breakdown(comp, group, dev, torch)
        psum = phase_psum(comp, group, dev, torch)
        file_twins = phase_file_twins(group, dev, torch)
        roofline = phase_roofline(comp, group, dev, torch)
    return comp, psum, file_twins, roofline


def phase_file_twins(group, dev, torch):
    """A token file of FILE_TOKENS seed-0 tokens (uint16: smollm's vocabulary
    is 49 152) written under a temporary directory feeds a compressed and a
    raw twin of FILE_STEPS steps at BATCH x SEQ through the launcher's ZeRO-1
    path (``data_path``, the pipeline's ``file`` backend).  Each step's batch
    equals numpy's reading of the file at the starts the step's seed draws;
    the twins' losses and final parameters are identical; the compressed
    twin launches two_shot_launches a step, the raw one nothing."""
    import tempfile

    import numpy as np

    from repro_torch import configs, kernels
    from repro_torch.launch import train as launch_train

    vocab = configs.get(ARCH).vocab
    runs = {}
    with tempfile.TemporaryDirectory(prefix="tokens_") as tmp:
        path = os.path.join(tmp, "tokens.bin")
        np.random.default_rng(SEED).integers(0, vocab, FILE_TOKENS).astype(
            np.uint16).tofile(path)
        for compress in (True, False):
            with recorded_inputs(torch) as inputs:
                kernels.clear_launch_counts()
                runs[compress] = launch_train.train(
                    ARCH, steps=FILE_STEPS, batch=BATCH, seq=SEQ, compress=compress,
                    device=dev, seed=SEED, group=group, data_path=path)
                runs[compress].launches = kernels.launch_counts()
            runs[compress].recorded = (inputs, shape_tallies())
        toks = np.fromfile(path, np.uint16)
    comp, raw = runs[True], runs[False]
    for step in range(FILE_STEPS):
        rng = np.random.default_rng(np.random.SeedSequence(entropy=SEED,
                                                           spawn_key=(step, 0)))
        starts = rng.integers(0, toks.shape[0] - SEQ - 1, size=BATCH)
        want = np.stack([toks[s:s + SEQ + 1] for s in starts]).astype(np.int32)
        got = comp.runner.pipeline.batch_at(step)
        if not (np.array_equal(got["tokens"], want[:, :SEQ])
                and np.array_equal(got["labels"], want[:, 1:])):
            raise AssertionError(f"step {step}'s batch is not the file's windows")
    if comp.runner.pipeline.cfg.kind != "file" or comp.losses != raw.losses:
        raise AssertionError(f"file-fed loss curves {comp.losses} vs {raw.losses}")
    for a, b in zip(comp.state.model.leaves(), raw.state.model.leaves()):
        if not torch.equal(a.detach().view(torch.int16), b.detach().view(torch.int16)):
            raise AssertionError("file-fed twins' final parameters differ")
    expect = dict.fromkeys(kernels.KERNELS, 0)
    expect.update({k: FILE_STEPS * v for k, v in two_shot_launches(True, True, 1).items()})
    if comp.launches != expect or any(raw.launches.values()):
        raise AssertionError(f"file-fed launch counts {comp.launches} (raw twin "
                             f"{raw.launches}), expected {expect}")
    print(f"train_file: {ARCH} full width, ZeRO-1, batch {BATCH} x seq {SEQ} from a token "
          f"file of {FILE_TOKENS} uint16 tokens (seed {SEED}); batches equal numpy's reading "
          f"of the file; compressed losses {comp.losses} = raw twin's, final parameters "
          f"identical; step_ms {[round(t, 1) for t in comp.step_ms]} vs raw "
          f"{[round(t, 1) for t in raw.step_ms]}; launches {comp.launches}")
    return {"launches": comp.launches, "recorded": comp.recorded}


def device_kernels(events) -> int:
    """Kernels on the card in a Chrome trace's events."""
    return sum(e.get("ph") == "X" and e.get("cat") == "kernel" for e in events)


def phase_roofline(comp, group, dev, torch):
    """One ZeRO-1 step of the main phase's compressed run (on a copy of its
    state, the next batch, its zero1 plan) against the card's roofline: the
    step's FLOPs counted by FlopCounterMode (forward and backward, remat
    replays included), its collective bytes from a torch.profiler trace of
    one step (``roofline.analysis.collective_bytes``), its WireReports from
    the module ledger (cleared, one step, read), and its time (host clock to
    a device sync, median of ROOFLINE_STEPS after an untimed one, counts from
    0: two_shot_launches a step).  The traced all-to-all and all-gather bytes equal the step's
    plan:zero1 wire bytes.  Writes a cell JSON and its trace to a temporary
    directory, and ``roofline.report.collect`` reads them back: prints the
    markdown row and the step's share of the card's bf16 peak,
    ``model_flops / (step_s x PEAK_FLOPS_BF16)``.  The cell's HBM bytes are
    ``roofline.model.analytic_cost``'s for one card (the profiler does not
    count them)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels
    from repro_torch.core import policy
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch import cells, dryrun
    from repro_torch.launch import train as launch_train
    from repro_torch.roofline import analysis, report
    from repro_torch.roofline import model as roof_model
    from repro_torch.train import step as step_lib
    from repro_torch.tree_util import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(comp.state.tree())
    state = comp.state.from_tree(tree_unflatten(treedef, [t.clone() for t in leaves]))
    batch = DataPipeline(DataConfig(vocab=state.model.cfg.vocab, global_batch=BATCH,
                                    seq_len=SEQ, seed=SEED)).tensors_at(STEPS + 1, dev)
    plan = step_lib.zero1_plan(state, comp.tcfg, group, cache=comp.plan_cache)

    def step():
        step_lib.train_step(state, batch, comp.tcfg, group=group, plan=plan)
        torch.cuda.synchronize()

    shape = cells.Shape(f"train_{BATCH}x{SEQ}", SEQ, BATCH, "train")
    with launch_train.deterministic(), tempfile.TemporaryDirectory(prefix="roofline_") as tmp:
        with FlopCounterMode(display=False) as counter:
            step()
        flops = counter.get_total_flops()
        trace = os.path.join(tmp, f"{ARCH}__{shape.name}.trace.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            step()
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        coll = analysis.collective_bytes(events)
        n_device = device_kernels(events)
        step()  # the first step after a trace ran 4x slower on an H100: not timed
        times = []
        with recorded_inputs(torch) as inputs:
            kernels.clear_launch_counts()
            for _ in range(ROOFLINE_STEPS):
                policy.clear_wire_reports()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                times.append(time.perf_counter() - t0)
            launches = kernels.launch_counts()
        recorded = (inputs, shape_tallies())
        reports = policy.wire_reports()
        policy.clear_wire_reports()
        step_s = sorted(times)[len(times) // 2]
        # for phase_dryrun: the arguments' bytes, and the peaks the card
        # allocates above what is allocated before a forward and backward
        # and before one more step
        args_bytes = dryrun.storage_bytes(dryrun.input_tensors(state)) + dryrun.storage_bytes(
            batch.values())
        peak = {}
        for part, fn in (("forward_backward", lambda: step_lib._microbatch_grads(
                lambda mb: step_lib.loss_fn(state.model, mb, comp.tcfg), batch,
                comp.tcfg.microbatches)), ("step", step)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peak[part] = torch.cuda.max_memory_allocated() - before
            for p in state.model.leaves():
                p.grad = None
        policy.clear_wire_reports()
        model_flops = analysis.model_flops_for(ARCH, shape)
        rec = {"arch": ARCH, "shape": shape.name, "mesh": "h100x1", "n_chips": 1,
               "compressed": True, "ok": True, "model_flops": model_flops,
               "cost": {"flops": flops, "bytes accessed": roof_model.analytic_cost(
                   ARCH, shape, n_chips=1, n_model=1).hbm_bytes_per_device},
               "cost_source": {"flops": "torch.utils.flop_counter.FlopCounterMode",
                               "bytes accessed": "roofline.model.analytic_cost"},
               "wire": analysis.summarize_wire_reports(reports),
               "step_ms": step_s * 1e3, "card": run_card()}
        with open(os.path.join(tmp, f"{ARCH}__{shape.name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        rows = report.collect(tmp, mesh="h100x1")
    if flops <= 0 or n_device == 0:
        raise AssertionError(f"the flop counter gave {flops} FLOPs, the trace {n_device} "
                             f"kernels on the card")
    if [r.name for r in reports] != ["plan:zero1"] or reports[0].wire_bytes != plan.wire_bytes:
        raise AssertionError(f"the ledger holds {reports} after one step of plan "
                             f"{plan.summary()}")
    traced = coll["bytes"]["all-to-all"] + coll["bytes"]["all-gather"]
    if traced != plan.wire_bytes or not coll["counts"]["all-to-all"] \
            or not coll["counts"]["all-gather"]:
        raise AssertionError(f"traced collective bytes {coll}, plan wire {plan.wire_bytes}")
    expect = dict.fromkeys(kernels.KERNELS, 0)
    expect.update({k: ROOFLINE_STEPS * v
                   for k, v in two_shot_launches(True, True, 1).items()})
    if launches != expect:
        raise AssertionError(f"roofline step launches {launches}, expected {expect}")
    (row,) = rows
    share = model_flops / (step_s * analysis.PEAK_FLOPS_BF16)
    print(f"roofline: {ARCH} one ZeRO-1 step at {BATCH} x {SEQ} on one card ({rec['card']}): "
          f"counted {flops:.4e} FLOPs (FlopCounterMode, remat replays included), model "
          f"6ND {model_flops:.4e} (useful {row.useful_flops_fraction:.3f}); traced "
          f"collectives {coll['bytes']} ({coll['counts']} calls) = the plan:zero1 wire "
          f"{plan.wire_bytes} B + {coll['bytes']['all-reduce']} B of all-reduce; wire "
          f"{analysis.wire_report_seconds(reports) * 1e3:.4f} ms at NVLink's 450 GB/s; "
          f"{n_device} kernels in the trace; step {step_s * 1e3:.2f} ms (median of "
          f"{ROOFLINE_STEPS}: {[round(t * 1e3, 2) for t in times]}); launches {launches}")
    print("  " + analysis.MD_HEADER_WIRE.replace("\n", "\n  "))
    print("  " + analysis.markdown_row_wire(row))
    print(f"  share of the card's bf16 peak: model_flops / (step_s x "
          f"{analysis.PEAK_FLOPS_BF16:.4g}) = {share:.4f}; counted FLOPs / step_s = "
          f"{flops / step_s / 1e12:.2f} TFLOP/s; bound {row.t_bound * 1e3:.3f} ms "
          f"({row.bottleneck}), roofline fraction at the bound {row.roofline_fraction:.3f}")
    return {"launches": launches, "recorded": recorded, "share": share,
            "step_ms": step_s * 1e3, "flops": flops, "model_flops": model_flops, "coll": coll,
            "tcfg": comp.tcfg, "plan_wire": plan.wire_bytes, "args_bytes": args_bytes,
            "peak": peak, "batch": {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}}


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
    from repro_torch.sched.cache import PlanCache
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
    # the run's plans beside the checkpoint, restored into a fresh cache
    n_saved = len(comp.plan_cache)
    t0 = time.perf_counter()
    plan_file = runner.ckpt.save_plans(comp.plan_cache)
    save_plans_ms = (time.perf_counter() - t0) * 1e3
    resumed_plans = PlanCache()
    t0 = time.perf_counter()
    n_restored = runner.ckpt.restore_plans(resumed_plans, device=dev)
    restore_plans_ms = (time.perf_counter() - t0) * 1e3
    if n_restored != n_saved or n_saved < 1:
        raise AssertionError(f"restored {n_restored} of {n_saved} plans")
    leaves, treedef = tree_flatten(state.tree())
    live = state.from_tree(tree_unflatten(treedef, [t.clone() for t in leaves]))
    batch = DataPipeline(DataConfig(vocab=state.model.cfg.vocab, global_batch=BATCH,
                                    seq_len=SEQ, seed=SEED)).tensors_at(STEPS, dev)
    with launch_train.deterministic():
        m_live = step_lib.train_step(live, batch, comp.tcfg, group=group)
        plan = step_lib.zero1_plan(restored, comp.tcfg, group, cache=resumed_plans)
        m_rest = step_lib.train_step(restored, batch, comp.tcfg, group=group, plan=plan)
    losses = (float(m_live["loss"]), float(m_rest["loss"]))
    if losses[0] != losses[1] or not bits_equal(live.tree(), restored.tree()):
        raise AssertionError(f"step {STEPS} from the restored state: losses {losses}, "
                             f"bit-identical {bits_equal(live.tree(), restored.tree())}")
    if (resumed_plans.stats.misses, resumed_plans.stats.hits) != (0, 1):
        raise AssertionError(f"the resumed step compiled plans: {resumed_plans.cache_info()}")
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"checkpoint: ZeRO-1 train state after step {STEPS - 1} ({len(leaves)} leaves, "
          f"{nbytes} B) saved asynchronously by the StepRunner: host copy "
          f"{submits[0]:.1f} ms (train:checkpoint span), background write "
          f"{comp.ckpt_write_ms[0]:.1f} ms (.npy files, sha256, manifest); try_resume on "
          f"the card {restore_ms:.1f} ms (sha256 verify, load, host-to-device), "
          f"bit-identical; step {STEPS} from it: loss {losses[1]!r} = the live state's, "
          f"bits identical; heartbeat step {beat['step']}, age {age:.2f} s; card {run_card()}")
    print(f"  plans: {n_saved} saved beside the checkpoint ({os.path.basename(plan_file)}, "
          f"{save_plans_ms:.2f} ms), {n_restored} restored into a fresh PlanCache "
          f"({restore_plans_ms:.2f} ms); the resumed step compiled 0 plans (0 misses, 1 hit) "
          f"and gave the live step's loss and bits")
    del live, restored


DRYRUN_CELL = ("tinyllama_1_1b", "train_4k", "single")
# the card's peaks above the arguments against the dry run's tracked ones
# (PERF.md section 6): a forward and backward (the same plain
# PyTorch ops on the card) within 1% and 64 MiB of the tracked one (the
# allocator's 512-byte rounding of every live block, cuBLAS workspaces);
# the whole step at least the tracked forward and backward less 1%, at
# most the tracked whole step (the sync on the plain route's temporaries,
# which the kernels do without) plus 1% and 64 MiB
DRYRUN_PEAK_LOW, DRYRUN_PEAK_HIGH, DRYRUN_PEAK_SLACK = 0.99, 1.01, 64 << 20
DRYRUN_TIMEOUT = 600  # seconds phase_dryrun waits for dryrun_cell's process


@contextlib.contextmanager
def dryrun_cell():
    """DRYRUN_CELL through the dry run's CLI (``python -m
    repro_torch.launch.dryrun``) in a process of its own, started now and
    run beside the phases that use the card (it takes only the host's
    CPU): no card is visible to it (``CUDA_VISIBLE_DEVICES`` empty).
    Yields ``(process, output directory)``; the process is killed on exit
    if it still runs."""
    import tempfile

    arch, shape, mk = DRYRUN_CELL
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1")
        with open(os.path.join(tmp, "log.txt"), "w") as log:
            proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                                     arch, "--shape", shape, "--mesh", mk, "--out-dir", tmp],
                                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
            try:
                yield proc, tmp
            finally:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()


def phase_dryrun(roofline, cell, dev, torch):
    """The dry run (``launch/dryrun``) on the CPU, no card involved: (a)
    DRYRUN_CELL, rank 0 of a fake world of 256 on fake tensors, run by
    :func:`dryrun_cell` beside the earlier phases; ``roofline.report.
    collect`` reads its JSON and trace.  (b) Its accounting held
    against the card: the roofline phase's ZeRO-1 step of smollm-135m at (1,
    1, 1) (its TrainConfig, its batch's shapes) run once on fake tensors by
    the same tracker and counter: the arguments' bytes equal the real
    state's and batch's, the FLOPs the roofline phase's count, the all-to-all
    and all-gather bytes the plan:zero1 wire, and the card's peak above the
    arguments (a forward and backward, the whole step) lie within
    DRYRUN_PEAK_* of the tracked ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.roofline import analysis, report
    from repro_torch.train import step as step_lib

    t0 = time.perf_counter()
    arch, shape, mk = DRYRUN_CELL
    proc, tmp = cell
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        rc = None
    with open(os.path.join(tmp, "log.txt")) as f:
        log = f.read()
    if rc != 0:
        raise AssertionError(f"the dry run of {DRYRUN_CELL} exited {rc}: {log[-3000:]}")
    with open(os.path.join(tmp, f"{arch}__{shape}__{mk}.json")) as f:
        rec = json.load(f)
    rows = report.collect(tmp, mesh=mk)
    waited = time.perf_counter() - t0
    if len(rows) != 1 or not rec["ok"] or rows[0].flops != rec["cost"]["flops"] or \
            rows[0].coll_bytes != sum(rec["collectives"]["bytes"].values()):
        raise AssertionError(f"report.collect read {rows} of the cell {rec}")
    mem, (row,) = rec["memory"], rows
    print(f"dryrun: {arch} {shape} on (data, model) = (16, 16): rank 0 of a fake world of "
          f"{rec['n_chips']}, fake CPU tensors, no device (a process of its own beside the "
          f"earlier phases, waited for {waited:.1f} s); build {rec['build_s']} s, run "
          f"{rec['run_s']} s; a device's arguments {mem['argument_size_bytes'] / 2**30:.4f} "
          f"GiB (the specs' {mem['spec_argument_size_bytes'] / 2**30:.4f}: a ZeRO-1 row once "
          f"a model shard), temp {mem['temp_size_bytes'] / 2**30:.4f} GiB, outputs "
          f"{mem['output_size_bytes']} B, in place {mem['alias_size_bytes'] / 2**30:.4f} GiB; "
          f"{rec['cost']['flops']:.4e} FLOPs a rank; wire ratio {rec['wire']['ratio']:.4f}; "
          f"collective bytes {sum(rec['collectives']['bytes'].values())} "
          f"{rec['collectives']['bytes']}")
    print("  " + analysis.MD_HEADER_WIRE.replace("\n", "\n  "))
    print("  " + analysis.markdown_row_wire(row))
    cfg, tcfg = configs.get(ARCH), roofline["tcfg"]
    t1 = time.perf_counter()
    with dryrun.fake_world(1):
        mesh = mesh_lib.make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
        dryrun.make_groups(mesh, tcfg)
        with FakeTensorMode(allow_non_fake_inputs=True):
            state = step_lib.build_train_state(cfg, tcfg, generator=torch.Generator().manual_seed(
                SEED), mesh=mesh, device="cpu")
            batch = {k: torch.zeros(sh, dtype=dt) for k, (sh, dt) in roofline["batch"].items()}
            fb = dryrun.measure(lambda st, b: {"loss": step_lib._microbatch_grads(
                lambda mb: step_lib.loss_fn(st.model, mb, tcfg), b, tcfg.microbatches)},
                (state, batch))
            for p in state.model.leaves():
                p.grad = None
            res = dryrun.measure(lambda st, b: step_lib.train_step(st, b, tcfg), (state, batch))
    fake_s = time.perf_counter() - t1
    got = res["collectives"]["bytes"]
    moved = got["all-to-all"] + got["all-gather"]
    tracked = {"forward_backward": fb["memory"]["temp_size_bytes"],
               "step": res["memory"]["temp_size_bytes"]}
    card = roofline["peak"]
    bounds = {"forward_backward": (DRYRUN_PEAK_LOW * tracked["forward_backward"],
                                   DRYRUN_PEAK_HIGH * tracked["forward_backward"]
                                   + DRYRUN_PEAK_SLACK),
              "step": (DRYRUN_PEAK_LOW * tracked["forward_backward"],
                       DRYRUN_PEAK_HIGH * tracked["step"] + DRYRUN_PEAK_SLACK)}
    print(f"  {ARCH} ZeRO-1 step at (1, 1, 1), {BATCH} x {SEQ}, on fake tensors ({fake_s:.1f} s) "
          f"against the roofline phase's step on the card ({run_card()}): arguments "
          f"{res['memory']['argument_size_bytes']} B (card {roofline['args_bytes']}); FLOPs "
          f"{res['flops']} (card {roofline['flops']}); all-to-all + all-gather {moved} B "
          f"(plan:zero1 wire {roofline['plan_wire']}); the peak above the arguments, tracked "
          f"against the card's max_memory_allocated less what was allocated before: " + "; ".join(
              f"{part} {tracked[part]} B, card {card[part]} B ({card[part] / tracked[part]:.4f}; "
              f"bound [{lo:.0f}, {hi:.0f}])" for part, (lo, hi) in bounds.items()))
    if res["memory"]["argument_size_bytes"] != roofline["args_bytes"] or \
            res["flops"] != roofline["flops"] or moved != roofline["plan_wire"]:
        raise AssertionError("the dry run's arguments, FLOPs or collective bytes differ from "
                             "the card's step")
    for part, (lo, hi) in bounds.items():
        if not lo <= card[part] <= hi:
            raise AssertionError(f"the card's {part} peak {card[part]} B is outside [{lo}, {hi}]")
    print(f"  dryrun phase {time.perf_counter() - t0:.1f} s")
    return {"seconds": time.perf_counter() - t0, "cell": rec, "card": card, "tracked": tracked}


def phase_mesh(comp, mesh, dev, torch):
    """The mesh layer on the card, arithmetic and a restore (no kernel
    launches): smollm's spec-derived per-device parameter and ZeRO-1 state
    bytes on the run's (1, 1, 1) mesh equal the bytes of the main run's
    model and optimizer state on the card; the main run's checkpoint (the
    reference's global layout) restored onto the mesh with
    ``restore(shardings=)`` through ``ElasticController.rescale(...,
    n_devices=1)`` gives its train state bit for bit; then each of the 11
    archs' per-device parameter, ZeRO-1 state and KV cache (batch 8 x 4096)
    bytes at (16, 16) and (2, 16, 16), laid out on abstract meshes (no
    allocation; what the dry run checks against)."""
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime.fault_tolerance import ElasticController
    from repro_torch.serve import sharding
    from repro_torch.train import step as step_lib
    from repro_torch.tree_util import bits_equal, tree_leaves

    t0 = time.perf_counter()
    cfg, tcfg, state = configs.get(ARCH), comp.tcfg, comp.state
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    struct, specs = step_lib.abstract_train_state(cfg, tcfg, mesh)
    want = {"params": nbytes(state.model.leaves()), "zero1 state": nbytes(tree_leaves(state.opt))}
    got = {"params": mesh_lib.shard_bytes((struct["params"], specs["params"]), mesh),
           "zero1 state": mesh_lib.shard_bytes((struct["opt"], specs["opt"]), mesh)}
    if got != want:
        raise AssertionError(f"per-device bytes from the specs {got}, on the card {want}")
    ctl = ElasticController(
        lambda n: mesh_lib.make_mesh((1, n, 1), ("pod", "data", "model"), device=dev),
        lambda m: step_lib.make_train_state_specs(cfg, tcfg, m))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    new_mesh, restored, step = ctl.rescale(comp.runner.ckpt, lambda m: state, 1, device=dev)
    torch.cuda.synchronize()
    rescale_ms = (time.perf_counter() - t1) * 1e3
    if step != STEPS - 1 or restored.step != state.step or not bits_equal(
            restored.tree(), state.tree()) or mesh_lib.axis_sizes(new_mesh) != \
            mesh_lib.axis_sizes(mesh):
        raise AssertionError(f"rescale onto {mesh_lib.axis_sizes(new_mesh)} gave step {step}, "
                             f"bit-identical {bits_equal(restored.tree(), state.tree())}")
    del restored
    rows = {}
    for shape, axes in ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")):
        am = mesh_lib.AbstractMesh(shape, axes)
        for arch in configs.ARCHS:
            acfg = configs.get(arch)
            st, sp = step_lib.abstract_train_state(acfg, step_lib.TrainConfig(), am)
            rows.setdefault(arch, {})["x".join(map(str, shape))] = {
                "params": mesh_lib.shard_bytes((st["params"], sp["params"]), am),
                "serve_params": mesh_lib.shard_bytes(sharding.abstract_params_sharded(
                    acfg, am, sharding.serve_param_specs(acfg, am)), am),
                "zero1_state": mesh_lib.shard_bytes((st["opt"], sp["opt"]), am),
                "cache_8x4096": mesh_lib.shard_bytes(
                    sharding.abstract_cache(acfg, am, 8, 4096), am)}
    print(f"mesh: {ARCH} on {mesh_lib.axis_sizes(mesh)}: per-device bytes from the specs "
          f"{got} = the card's; the main checkpoint rescaled onto the mesh through "
          f"ElasticController in {rescale_ms:.1f} ms (sha256 verify, load, blocks, "
          f"host-to-device), bit-identical; {time.perf_counter() - t0:.1f} s; "
          f"card {run_card()}")
    print("mesh_layouts: " + json.dumps(rows))


# zoo phase: serve runs (requests, prompt tokens, new tokens, slots, cache
# length), qwen2-vl's cut depth and prefill, tinyllama's training run
# the zoo's depth, cut to make room for the tp phase's serve jobs
# (chip_smoke.py took 1060-1093 s with them at the depths before) and then
# for the dryrun phase and the tp phase's ingestion: glm4-9b served at 2
# of its 40 layers (20 before), gemma3-27b at 1 of its 10 six-layer
# patterns and its 2 prefix layers (8 of 62; 14 before; full depth took
# ~45 s of the zoo phase, a 1.04 GB shipment a request)
ZOO_SERVE = {"glm4_9b": dict(n_req=4, prompt=512, new=32, slots=4, max_len=1024,
                             repeats=2),
             "gemma3_27b": dict(n_req=2, prompt=1536, new=16, slots=2, max_len=2048,
                                repeats=1)}
QWEN_REPEATS, QWEN_BATCH, QWEN_SEQ, QWEN_DECODE, QWEN_MAX_LEN = 2, 2, 512, 8, 1024
TINY_BATCH, TINY_SEQ, TINY_STEPS = 8, 512, 2
# deepseek-v2-lite: served after the dense models at its dense prefix layer
# and DEEPSEEK_SERVE's repeats of its 26 MoE layers (2 of 27 layers; 7
# before the dryrun phase, full depth before the serve jobs); trained at
# full width with the depth cut to the dense
# prefix layer and REPEATS MoE layers, 8 x 512 = 4096 tokens a step (the
# capacity regime: C = 480)
DEEPSEEK = "deepseek_v2_lite_16b"
DEEPSEEK_SERVE = dict(n_req=4, prompt=512, new=32, slots=4, max_len=1024, repeats=1)
DEEPSEEK_REPEATS, DEEPSEEK_BATCH, DEEPSEEK_SEQ, DEEPSEEK_STEPS = 1, 8, 512, 2
# the remaining mixers: jamba served at full width with its depth cut to
# JAMBA_REPEATS of its 4 eight-layer patterns (7 Mamba and 1 attention
# layer, 4 of them MoE; 2 patterns before the serve jobs), and trained at
# full width with its pattern cut to (Mamba + SwiGLU, attention + SwiGLU)
# once; xlstm-350m served and trained at full width, XLSTM_REPEATS periods;
# whisper-small (encoder-decoder) at full width and depth: a prefill with
# frames, its cache shipped, greedy decode steps, and ZeRO-1 twins on
# registry.make_batch batches.  xlstm's twins run at a cut sequence
# (XLSTM_TRAIN_SEQ): its eager step loop took 48-54 s a step at 8 x 512
# (both twins 202 s on the H100), and the sequence is cut, never a width
JAMBA, XLSTM, WHISPER = "jamba_v0_1_52b", "xlstm_350m", "whisper_small"
JAMBA_REPEATS = 1
# xlstm-350m served (prompts of XLSTM_PROMPT) and trained (8 x 32) at one
# of its 3 periods (8 of 24 layers): at full depth its eager steps took
# ~5.3 s a prefill of 512 and 67 s for the twins at 8 x 128 (H100), and
# the phase's time went to the tp phase's serve jobs; prompts of 128 (256
# before the dryrun phase and ingestion)
XLSTM_REPEATS, XLSTM_PROMPT = 1, 128
MIXER_SERVE = dict(n_req=4, prompt=512, new=32, slots=4, max_len=1024)
WHISPER_BATCH, WHISPER_SEQ, WHISPER_DECODE, WHISPER_MAX_LEN = 2, 512, 8, 1024
JAMBA_TRAIN_SEQ, JAMBA_TRAIN_STEPS = 512, 2
XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ, XLSTM_TRAIN_STEPS = 8, 32, 2
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_STEPS = 8, 512, 2


def _gib(n: float) -> str:
    return f"{n / 2**30:.2f} GiB"


def zoo_model(cfg, dev, torch):
    """A model of ``cfg`` drawn on the card by a CUDA generator seeded SEED
    (a CPU generator would take minutes for billions of weights)."""
    from repro_torch.models import transformer

    return transformer.init(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)


def zoo_serve(tag, cfg, model, sp, dev, torch, np):
    """Greedy serving of ``sp["n_req"]`` requests through ServeEngine,
    colocated, then PD over the compressed host KV wire (a fresh PlanCache:
    1 miss, then hits): identical tokens; each admission packs and unpacks
    every cache leaf twice (lo plane, exponent residuals) and the
    colocated run launches nothing.  Then one admission's prefilled cache
    over the host wire: every leaf bit-identical, pack and unpack ms, wire
    ratio.  Returns the PD run's launches, recorded inputs and numbers."""
    from repro_torch import kernels
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    from repro_torch.p2p.engine import Compressor
    from repro_torch.sched.cache import PlanCache
    from repro_torch.serve import kv_transfer
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
    from repro_torch.tree_util import bits_equal, tree_flatten

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, sp["prompt"]).astype(np.int32)
               for _ in range(sp["n_req"])]

    def serve(pd, reqs, max_new, plan_cache=None):
        scfg = ServeConfig(batch_slots=sp["slots"], max_len=sp["max_len"],
                           prefill_chunk=sp["prompt"], pd_disaggregated=pd)
        eng = ServeEngine(cfg, model, scfg, kv_plan_cache=plan_cache,
                          kv_policy=CompressionPolicy(min_bytes=0) if pd else None)
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
        colocated, t_col = serve(False, prompts, sp["new"])
        col_launches = kernels.launch_counts()
        pc = PlanCache()
        with recorded_inputs(torch) as inputs:
            kernels.clear_launch_counts()
            pd, t_pd = serve(True, prompts, sp["new"], pc)
            pd_launches = kernels.launch_counts()
        recorded = (inputs, shape_tallies())
    # every cache leaf but pos: K/V, latents or recurrent state, a stacked
    # pattern position's leaf once
    n_leaves = sum(1 for t in tree_flatten(transformer.init_cache(cfg, 1, 1, "cpu"))[0]
                   if t.dim())
    expect = dict.fromkeys(kernels.KERNELS, 0)
    expect.update(pack=2 * n_leaves * sp["n_req"], unpack=2 * n_leaves * sp["n_req"])
    if pd != colocated:
        raise AssertionError(f"{tag}: PD tokens differ from colocated: {pd} vs {colocated}")
    if len(pd) != sp["n_req"] or any(len(o) != sp["new"] or not all(
            0 <= t < cfg.vocab for t in o) for _, o in pd):
        raise AssertionError(f"{tag}: unexpected serve output {pd}")
    if (pc.stats.misses, pc.stats.hits) != (1, sp["n_req"] - 1):
        raise AssertionError(f"{tag}: plan cache {pc.cache_info()}")
    if pd_launches != expect or any(col_launches.values()):
        raise AssertionError(f"{tag}: serve launches {pd_launches} (colocated "
                             f"{col_launches}), expected {expect}")
    (plan,) = pc._plans.values()
    toks = torch.from_numpy(prompts[0][None].astype(np.int64)).to(dev)
    with launch_train.deterministic():
        _, cache = transformer.prefill(model, toks,
                                       transformer.init_cache(cfg, 1, sp["max_len"], dev))
    eng = Compressor(codec_name="packed", device=dev)
    wire = kv_transfer.pack_cache(cache, eng, plan=plan)
    if not bits_equal(kv_transfer.unpack_cache(wire, eng), cache):
        raise AssertionError(f"{tag}: a shipped cache is not bit-identical")
    msgs = [m for m in wire["messages"] if hasattr(m, "wire_bytes")]
    shapes = sorted({tuple(t.shape) for t in tree_flatten(cache)[0] if t.dim()})
    by_dtype = {}  # dtype: [raw bytes, wire bytes, leaves]
    for m, (kind, _, dt) in zip(wire["messages"], wire["meta"]):
        if kind == "z":
            acc = by_dtype.setdefault(dt, [0, 0, 0])
            acc[0] += m.raw_bytes
            acc[1] += m.wire_bytes()
            acc[2] += 1
    # where a run's time goes: an admission's prefill, a batched decode step
    batched = transformer.init_cache(cfg, sp["slots"], sp["max_len"], dev)
    batched["pos"] = torch.tensor(sp["prompt"], dtype=torch.int32, device=dev)
    cur = torch.zeros((sp["slots"], 1), dtype=torch.int32, device=dev)
    with launch_train.deterministic():
        parts = {"prefill_ms": _wall_ms(lambda: transformer.prefill(
                     model, toks, transformer.init_cache(cfg, 1, sp["max_len"], dev)),
                     torch, runs=3),
                 "decode_step_ms": _wall_ms(lambda: transformer.decode_step(model, cur, batched),
                                            torch, runs=3)}
    del batched
    out = {"launches": pd_launches, "recorded": recorded, **parts,
           "tok_s": {"colocated": sp["n_req"] * sp["new"] / t_col,
                     "pd": sp["n_req"] * sp["new"] / t_pd},
           "ratio": sum(m.wire_bytes() for m in msgs) / sum(m.raw_bytes for m in msgs),
           "pack_ms": _wall_ms(lambda: kv_transfer.pack_cache(cache, eng, plan=plan), torch,
                               runs=3),
           "unpack_ms": _wall_ms(lambda: kv_transfer.unpack_cache(wire, eng), torch, runs=3),
           "leaves": len(msgs), "shapes": shapes,
           "width": {dt: plan.width_for_dtype(dt) for dt in by_dtype},
           "by_dtype": {dt: {"leaves": n, "raw_bytes": r, "wire_bytes": w, "ratio": w / r}
                        for dt, (r, w, n) in by_dtype.items()},
           "raw_bytes": sum(m.raw_bytes for m in msgs),
           "wire_bytes": sum(m.wire_bytes() for m in msgs)}
    print(f"  {tag}: {sp['n_req']} requests x {sp['prompt']} prompt + {sp['new']} new "
          f"tokens, {sp['slots']} slots, max_len {sp['max_len']}: PD tokens identical to "
          f"colocated; plan cache 1 miss {sp['n_req'] - 1} hits; launches {pd_launches}; "
          f"tokens/s colocated {out['tok_s']['colocated']:.1f} ({t_col * 1e3:.1f} ms), PD "
          f"{out['tok_s']['pd']:.1f} ({t_pd * 1e3:.1f} ms)")
    print(f"  {tag} shipment: {len(msgs)} leaves of shapes {shapes}, bit-identical; "
          f"{out['raw_bytes']} bytes a request, {out['wire_bytes']} on the wire, ratio "
          f"{out['ratio']:.4f} (widths {out['width']}); by dtype {out['by_dtype']}; pack "
          f"{out['pack_ms']:.2f} ms, unpack {out['unpack_ms']:.2f} ms (median of 3)")
    print(f"  {tag} breakdown, ms (host clock to a device sync, median of 3): prefill 1 x "
          f"{sp['prompt']} {out['prefill_ms']:.2f}, decode step {sp['slots']} slots "
          f"{out['decode_step_ms']:.2f}")
    return out


def moe_gradient_stats(encoded: dict, names: list, meta, torch) -> dict:
    """What an MoE model's gradients give the codec, read from
    ``encoded``, the inputs encode_fused recorded in a one-rank ZeRO-1 run
    (``recorded_inputs``): the first is the first step's gradient bucket,
    which the reduce-scatter encodes before the all-gather encodes the
    weights.  Returns its 512-value blocks, how many are all zero (the
    codec's zero escape), of those the ones inside the routed experts'
    leaves and inside the embedding (rows of tokens the step did not
    see), and per MoE layer (by parameter path) the experts whose three
    gradient leaves are all zero: no token of the step was kept by them."""
    from repro_torch.optim import zero1

    bucket = next(iter(encoded.values()))[0].reshape(-1)
    blocks = bucket.numel() // 512
    zero = (bucket[:blocks * 512].view(blocks, 512) == 0).all(1)
    inside = {"experts": 0, "embed": 0}
    off = 0
    for i, _, size in meta.members[0]:
        part = "embed" if names[i] == "embed" else "experts" if "/ffn/we" in names[i] else None
        if part:  # the blocks wholly inside the leaf
            inside[part] += int(zero[-(-off // 512):(off + size) // 512].sum())
        off += size
    grads = dict(zip(names, zero1.unflatten_buckets(meta, [bucket],
                                                    [bucket.new_empty(0)] * len(names))))
    idle = {}
    for name in names:
        if name.endswith("ffn/we1"):
            pre = name.removesuffix("we1")
            lead = grads[name].shape[:-2]  # (E,) or (repeats, E)
            used = sum((grads[pre + w].reshape(*lead, -1) != 0).any(-1).to(torch.int64)
                       for w in ("we1", "we2", "we3"))
            idle[pre.removesuffix("/ffn/")] = (used == 0).sum(-1).tolist()
    n_zero = int(zero.sum())
    return {"blocks": blocks, "zero_blocks": n_zero, "zero_share": n_zero / blocks,
            "zero_in_experts": inside["experts"], "zero_in_embed": inside["embed"],
            "idle_experts": idle}


def merge_shapes(into: dict, more: dict) -> dict:
    """Per-shape entries of ``time_path_shapes`` merged: a shape already
    there keeps its times and adds the other's launches."""
    for name, by_key in more.items():
        for key, entry in by_key.items():
            have = into.setdefault(name, {}).get(key)
            if have is None:
                into[name][key] = entry
            else:
                have["launches"] += entry["launches"]
                have["launches_by_run"].update(entry["launches_by_run"])
    return into


class Zoo:
    """What the zoo phase's runs share: the card, the launches of each run,
    the kernels' timed shapes and each model's peak memory, and the runs
    every zoo model goes through (serve_full, ship_and_decode,
    train_twins).  A script may build one and drive a single part, e.g.
    ``zoo_mixers(Zoo(dev, torch, np, bw))`` after phase_build."""

    def __init__(self, dev, torch, np, bw):
        self.dev, self.torch, self.np, self.bw = dev, torch, np, bw
        self.launches, self.shapes, self.peaks = {}, {}, {}

    def fresh(self):
        import gc

        gc.collect()
        self.torch.cuda.empty_cache()
        self.torch.cuda.reset_peak_memory_stats(self.dev)

    def timed(self, run, recorded):
        merge_shapes(self.shapes, time_path_shapes({run: recorded}, {run: self.launches[run]},
                                                   self.bw, self.dev, self.torch))

    def peak(self, key):
        self.peaks[key] = self.torch.cuda.max_memory_allocated(self.dev)
        print(f"  {key} peak memory {_gib(self.peaks[key])}")

    def serve_full(self, arch, sp, cfg=None):
        """``arch`` at full width and depth (or at ``cfg``, a cut depth)
        served colocated, then PD.  Returns zoo_serve's numbers."""
        import gc

        from repro_torch import configs
        from repro_torch.models import transformer

        torch, dev = self.torch, self.dev
        self.fresh()
        full = configs.get(arch)
        cfg = cfg or full
        # the bf16 weights and the f32 draw of the largest leaf (transformer.init)
        largest = max(t.numel() for _, t in transformer.tree_paths(
            transformer.abstract_params(cfg)))
        need, free = cfg.param_count() * 2 + largest * 4, torch.cuda.mem_get_info(dev)[0]
        if need > free:
            raise AssertionError(f"{arch} does not fit at full depth: {_gib(need)} of bf16 "
                                 f"weights and the f32 draw of a {largest}-value leaf, "
                                 f"{_gib(free)} free")
        model = zoo_model(cfg, dev, torch)
        print(f"zoo {arch}: d_model {cfg.d_model}, head_dim {cfg.hd}, {cfg.kv_heads} KV heads, "
              f"{cfg.n_layers} of {full.n_layers} layers; {cfg.param_count() / 1e9:.2f} B "
              f"of {full.param_count() / 1e9:.2f} B parameters "
              f"({cfg.active_param_count() / 1e9:.2f} B active), "
              f"{cfg.param_count() * 2 / 1e9:.1f} GB bf16; layers "
              f"{[(s.mixer, s.ffn, s.window) for s in (*cfg.prefix, *cfg.pattern)]}; "
              f"weights and init draw {_gib(need)}")
        out = zoo_serve(arch, cfg, model, sp, dev, torch, self.np)
        run = f"zoo_{arch}_pd"
        self.launches[run] = out.pop("launches")
        recorded = out.pop("recorded")
        del model
        self.peak(arch)
        gc.collect()
        self.timed(run, recorded)
        return out

    def ship_and_decode(self, run, arch, cfg, batch_size, seq, n_decode, max_len):
        """``cfg`` (``arch``, maybe cut in depth) drawn on the card: a
        prefill of a registry.make_batch batch (with its vision embeddings
        or an encoder-decoder model's frames), its cache over the host wire
        bit-identical, then ``n_decode`` greedy tokens from the shipped and
        from the original cache, identical (with the encoder's output where
        the model has one).  Its pack and unpack launches are ``run``'s."""
        import gc

        from repro_torch import configs, kernels
        from repro_torch.core.policy import CompressionPolicy
        from repro_torch.launch import train as launch_train
        from repro_torch.models import registry, transformer
        from repro_torch.p2p.engine import Compressor
        from repro_torch.sched.cache import PlanCache
        from repro_torch.serve import kv_transfer
        from repro_torch.tree_util import bits_equal, tree_flatten, tree_unflatten

        torch, dev = self.torch, self.dev
        self.fresh()
        full = configs.get(arch)
        model = zoo_model(cfg, dev, torch)
        batch = registry.make_batch(cfg, batch_size, seq, rng=self.np.random.default_rng(SEED),
                                    device=dev)
        extra = {k: batch[k] for k in ("vision_embeds", "frames") if k in batch}
        with launch_train.deterministic():
            logits, cache = transformer.prefill(
                model, batch["tokens"], transformer.init_cache(cfg, batch_size, max_len, dev),
                **extra)
            enc_out = model.encode(batch.get("frames"))
            eng = Compressor(codec_name="packed", device=dev)
            with recorded_inputs(torch) as inputs:
                kernels.clear_launch_counts()
                wire, plan = kv_transfer.ship_cache(cache, eng, policy=CompressionPolicy(min_bytes=0),
                                                    plan_cache=PlanCache())
                back = kv_transfer.unpack_cache(wire, eng)
                self.launches[run] = kernels.launch_counts()
            recorded = (inputs, shape_tallies())
            if not bits_equal(back, cache):
                raise AssertionError(f"{arch}: the shipped cache is not bit-identical")
            leaves, treedef = tree_flatten(cache)

            def greedy(c):
                c = tree_unflatten(treedef, [t.clone() for t in tree_flatten(c)[0]])
                tok = torch.argmax(logits[:, -1], -1)
                out = [tok.tolist()]
                for _ in range(n_decode - 1):
                    lg, c = transformer.decode_step(model, tok[:, None], c, enc_out=enc_out)
                    tok = torch.argmax(lg[:, -1], -1)
                    out.append(tok.tolist())
                return out

            from_ship, from_cache = greedy(back), greedy(cache)
        n_leaves = sum(1 for t in leaves if t.dim())
        expect = dict.fromkeys(kernels.KERNELS, 0)
        expect.update(pack=2 * n_leaves, unpack=2 * n_leaves)
        if self.launches[run] != expect:
            raise AssertionError(f"{arch} shipment launches {self.launches[run]}, "
                                 f"expected {expect}")
        if from_ship != from_cache or not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"{arch}: decode from the shipped cache {from_ship} vs "
                                 f"{from_cache}")
        msgs = [m for m in wire["messages"] if hasattr(m, "wire_bytes")]
        ratio = sum(m.wire_bytes() for m in msgs) / sum(m.raw_bytes for m in msgs)
        enc = f" and {cfg.n_enc_layers} encoder layers" if cfg.enc_dec else ""
        print(f"zoo {arch}: d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.kv_heads} KV "
              f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {cfg.n_layers} of "
              f"{full.n_layers} layers{enc} (repeats {cfg.repeats} of {full.repeats}): "
              f"{cfg.param_count() / 1e9:.3f} B of {full.param_count() / 1e9:.3f} B parameters")
        print(f"  prefill of {batch_size} x {seq} tokens with "
              f"{ {k: tuple(v.shape) for k, v in extra.items()} } (registry.make_batch); cache "
              f"({n_leaves} leaves of {tuple(leaves[0].shape)} {leaves[0].dtype}, "
              f"{sum(m.raw_bytes for m in msgs)} bytes) over the host wire bit-identical, ratio "
              f"{ratio:.4f}; {n_decode} greedy decode steps"
              f"{' with enc_out' if enc_out is not None else ''} from it identical to the "
              f"original's {from_cache}; launches {self.launches[run]}")
        del model, cache, back, wire, logits, batch, extra, leaves, enc_out
        self.peak(arch)
        gc.collect()
        self.timed(run, recorded)

    def train_twins(self, arch, steps, batch, seq, cfg=None, run_one=None):
        """The launcher's ZeRO-1 path for ``arch`` (at ``cfg`` where given, a
        cut depth), or ``run_one(compress, group)`` (a run with the
        launcher's ``losses``, ``step_ms``, ``state``, ``tcfg`` and
        ``plan_cache``), compressed then raw, one after the other (the
        compressed run's final weights wait in host memory, and its
        kernels' inputs too: its all-gather decode's plain merge takes tens
        of GB at a bucket of a billion values): identical loss bits, final
        weights and launches; the raw run launches nothing.  Returns (the
        compressed run's numbers with each bucket's ratios, the raw run's,
        its recorded inputs, the compressed run's parameter names, its
        bucket layout and n_dp)."""
        import gc

        from repro_torch import kernels
        from repro_torch.launch import train as launch_train
        from repro_torch.train import step as step_lib
        from repro_torch.tree_util import bits_equal, tree_flatten

        torch, dev = self.torch, self.dev
        self.fresh()
        runs, recorded, finals = {}, None, {}
        with launch_train.single_process_group(dev) as group:
            n_dp = torch.distributed.get_world_size(group)
            for compress in (True, False):
                with recorded_inputs(torch, host=True) as inputs:
                    kernels.clear_launch_counts()
                    if run_one is None:
                        run = launch_train.train(cfg or arch, steps=steps, batch=batch,
                                                 seq=seq, compress=compress, device=dev,
                                                 seed=SEED, group=group)
                    else:
                        run = run_one(compress, group)
                    run.launches = kernels.launch_counts()
                runs[compress] = {"losses": run.losses, "step_ms": run.step_ms,
                                  "launches": run.launches, "n": run.state.meta.padded[0],
                                  "buckets": len(run.state.meta.dtype_names)}
                if compress:
                    recorded = (inputs, shape_tallies())
                    names, meta = list(run.state.model.params), run.state.meta
                    # the run's plan, a hit in its own cache
                    plan = step_lib.zero1_plan(run.state, run.tcfg, group, cache=run.plan_cache)
                    runs[compress]["ratios"] = {
                        pp.rs.dtype_name: {"n": pp.rs.length, "rs": pp.rs.ratio,
                                           "ag": pp.ag.ratio} for pp in plan.buckets}
                finals[compress] = [t.cpu() for t in tree_flatten(run.state.model.tree())[0]]
                del run
                gc.collect()
                torch.cuda.empty_cache()
        comp, raw = runs[True], runs[False]
        expect = dict.fromkeys(kernels.KERNELS, 0)
        expect.update({k: steps * comp["buckets"] * v
                       for k, v in two_shot_launches(True, True, n_dp).items()})
        if comp["losses"] != raw["losses"] or any(s != s for s in comp["losses"]):
            raise AssertionError(f"{arch} losses differ: {comp['losses']} vs {raw['losses']}")
        if comp["launches"] != expect or any(raw["launches"].values()):
            raise AssertionError(f"{arch} launches {comp['launches']} (raw {raw['launches']}), "
                                 f"expected {expect}")
        if not bits_equal(finals[True], finals[False]):
            raise AssertionError(f"{arch}: final parameters differ between the twins")
        del finals
        return comp, raw, recorded, names, meta, n_dp


def phase_zoo(dev, torch, np, bw):
    """The model zoo at full width, each model drawn from SEED on the card,
    run, held, its kernels' new shapes timed, and freed before the next:
    glm4-9b and gemma3-27b at a cut depth served colocated and PD (a model
    whose weights and init draw do not fit fails the phase); qwen2-vl-72b
    cut in depth: a prefill with vision embeddings, its cache over the host
    wire and greedy decode from both;
    tinyllama-1.1b trained through the launcher's ZeRO-1 path, compressed
    and raw; deepseek-v2-lite-16b (MLA and MoE) served at a cut depth over
    its latent KV cache, then trained at
    full width and a cut depth like tinyllama; then the remaining mixers
    (:func:`zoo_mixers`).  Returns the launches of each run and the timed
    shapes."""
    import gc

    from repro_torch import configs
    from repro_torch.models.layers import moe_capacity

    t_phase = time.perf_counter()
    zoo = Zoo(dev, torch, np, bw)
    launches, peaks = zoo.launches, zoo.peaks
    zoo.fresh()
    print(f"zoo: card {run_card()}; {_gib(torch.cuda.mem_get_info(dev)[0])} free, "
          f"{_gib(torch.cuda.memory_allocated(dev))} still allocated")
    # -- glm4-9b and gemma3-27b: served colocated, then PD ------------------
    for arch, sp in ZOO_SERVE.items():
        zoo.serve_full(arch, sp, dataclasses.replace(configs.get(arch), repeats=sp["repeats"])
                       if "repeats" in sp else None)
    # -- qwen2-vl-72b at a cut depth: prefill with vision embeddings --------
    zoo.ship_and_decode("zoo_qwen2_vl_ship", "qwen2_vl_72b",
                        dataclasses.replace(configs.get("qwen2_vl_72b"), repeats=QWEN_REPEATS),
                        QWEN_BATCH, QWEN_SEQ, QWEN_DECODE, QWEN_MAX_LEN)
    # -- tinyllama-1.1b: the launcher's ZeRO-1 path, compressed then raw ----
    comp, raw, recorded, _, _, n_dp = zoo.train_twins("tinyllama_1_1b", TINY_STEPS, TINY_BATCH,
                                                      TINY_SEQ)
    launches["zoo_tinyllama_train"] = comp["launches"]
    cfg = configs.get("tinyllama_1_1b")
    print(f"zoo tinyllama_1_1b: full width and depth ({cfg.n_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f} B parameters), launcher ZeRO-1 n_dp={n_dp}, batch "
          f"{TINY_BATCH} x seq {TINY_SEQ}, remat: bucket n={comp['n']} "
          f"(param_count {cfg.param_count()}); compressed losses {comp['losses']} step_ms "
          f"{[round(t, 1) for t in comp['step_ms']]}; raw losses {raw['losses']} step_ms "
          f"{[round(t, 1) for t in raw['step_ms']]}: loss bits and final parameters "
          f"identical; launches {comp['launches']}")
    zoo.peak("tinyllama_1_1b")
    gc.collect()
    torch.cuda.empty_cache()
    zoo.timed("zoo_tinyllama_train", recorded)
    del recorded
    # -- deepseek-v2-lite-16b: MLA + MoE served, its depth cut ----------------
    zoo.serve_full(DEEPSEEK, DEEPSEEK_SERVE, dataclasses.replace(
        configs.get(DEEPSEEK), repeats=DEEPSEEK_SERVE["repeats"]))
    # -- and trained at full width, the depth cut: ZeRO-1 twins -------------
    full = configs.get(DEEPSEEK)
    cfg = dataclasses.replace(full, repeats=DEEPSEEK_REPEATS)
    comp, raw, recorded, names, meta, n_dp = zoo.train_twins(
        DEEPSEEK, DEEPSEEK_STEPS, DEEPSEEK_BATCH, DEEPSEEK_SEQ, cfg)
    launches["zoo_deepseek_train"] = comp["launches"]
    experts = moe_gradient_stats(recorded[0]["encode_fused"], names, meta, torch)
    print(f"zoo {DEEPSEEK} train: full width, depth cut to {cfg.n_layers} of {full.n_layers} "
          f"layers (the dense prefix and {DEEPSEEK_REPEATS} MoE), "
          f"{cfg.param_count() / 1e9:.3f} B parameters, launcher ZeRO-1 n_dp={n_dp}, batch "
          f"{DEEPSEEK_BATCH} x seq {DEEPSEEK_SEQ} (C = "
          f"{moe_capacity(cfg, DEEPSEEK_BATCH * DEEPSEEK_SEQ)} slots an expert), remat: "
          f"bucket n={comp['n']} (param_count {cfg.param_count()}); compressed losses "
          f"{comp['losses']} step_ms {[round(t, 1) for t in comp['step_ms']]}; raw losses "
          f"{raw['losses']} step_ms {[round(t, 1) for t in raw['step_ms']]}: loss bits and "
          f"final parameters identical; launches {comp['launches']}")
    print(f"  {DEEPSEEK} first step's gradient bucket: {experts['zero_blocks']} of "
          f"{experts['blocks']} 512-value blocks all zero ({experts['zero_share']:.6f}), "
          f"{experts['zero_in_experts']} of them in the routed experts' leaves and "
          f"{experts['zero_in_embed']} in the embedding (rows of tokens the step did not "
          f"see); experts with no token (all-zero expert gradients) by MoE layer "
          f"{experts['idle_experts']} of {cfg.moe.n_experts}")
    zoo.peak("deepseek_train")
    gc.collect()
    torch.cuda.empty_cache()
    zoo.timed("zoo_deepseek_train", recorded)
    del recorded
    # -- the remaining mixers --------------------------------------------------
    zoo_mixers(zoo)
    zoo.fresh()
    seconds = time.perf_counter() - t_phase
    print(f"zoo: {seconds:.1f} s; peak memory by model "
          f"{ {k: _gib(v) for k, v in peaks.items()} }")
    return {"launches": launches, "shapes": zoo.shapes, "seconds": seconds, "peaks": peaks}


def zero_blocks_in(encoded: dict, names: list, meta, inside) -> dict:
    """All-zero 512-value blocks of the first gradient bucket that
    encode_fused recorded in a one-rank ZeRO-1 run (``recorded_inputs``: the
    reduce-scatter encodes it before the all-gather encodes the weights),
    and how many of them lie wholly inside the leaves whose name
    ``inside(name)`` picks."""
    bucket = next(iter(encoded.values()))[0].reshape(-1)
    blocks = bucket.numel() // 512
    zero = (bucket[:blocks * 512].view(blocks, 512) == 0).all(1)
    n_in, off = 0, 0
    for i, _, size in meta.members[0]:
        if inside(names[i]):
            n_in += int(zero[-(-off // 512):(off + size) // 512].sum())
        off += size
    return {"blocks": blocks, "zero_blocks": int(zero.sum()),
            "zero_share": int(zero.sum()) / blocks, "inside": n_in}


def zoo_mixers(zoo):
    """The remaining mixers on the card, through ``zoo`` (a :class:`Zoo`):
    jamba at full width and JAMBA_REPEATS of its patterns, and xlstm-350m
    at full width and depth, served colocated and PD over the host wire
    (their recurrent states, f32 beside bf16, bit-identical); whisper-small's
    prefill with frames, its cache over the host wire and greedy decode
    from both caches with the encoder's output; ZeRO-1 twins of jamba (its
    pattern cut to Mamba + SwiGLU, attention + SwiGLU: a bf16 and an f32
    bucket) and xlstm through the launcher, of whisper through
    train.step.train_step on registry.make_batch batches."""
    import gc

    from repro_torch import configs
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry
    from repro_torch.sched.cache import PlanCache
    from repro_torch.train import step as step_lib

    dev, torch, np, launches, peaks = zoo.dev, zoo.torch, zoo.np, zoo.launches, zoo.peaks

    def twins_line(tag, cfg, full, comp, raw, n_dp, batch, seq, note=""):
        print(f"zoo {tag} train: {cfg.n_layers} of {full.n_layers} layers "
              f"{[(s.mixer, s.ffn) for s in cfg.pattern]} x {cfg.repeats}, "
              f"{cfg.param_count() / 1e9:.3f} B parameters, ZeRO-1 n_dp={n_dp}, batch {batch} "
              f"x seq {seq}{note}, remat: {comp['buckets']} bucket(s) "
              f"{comp['ratios']}; compressed losses {comp['losses']} step_ms "
              f"{[round(t, 1) for t in comp['step_ms']]}; raw losses {raw['losses']} step_ms "
              f"{[round(t, 1) for t in raw['step_ms']]}: loss bits and final parameters "
              f"identical; launches {comp['launches']}")

    # -- jamba at full width, JAMBA_REPEATS patterns: served ----------------
    full = configs.get(JAMBA)
    cfg = dataclasses.replace(full, repeats=JAMBA_REPEATS)
    out = zoo.serve_full(JAMBA, MIXER_SERVE, cfg)
    print(f"  {JAMBA}: {sum(s.mixer == 'mamba' for s in cfg.pattern) * cfg.repeats} Mamba and "
          f"{sum(s.mixer == 'attn' for s in cfg.pattern) * cfg.repeats} attention layers, "
          f"{sum(s.ffn == 'moe' for s in cfg.pattern) * cfg.repeats} MoE; prefill 1 x "
          f"{MIXER_SERVE['prompt']} {out['prefill_ms']:.2f} ms, decode step "
          f"{out['decode_step_ms']:.2f} ms; state wire by dtype {out['by_dtype']}")
    # -- xlstm-350m at full width, XLSTM_REPEATS periods: served --------------
    xcfg = dataclasses.replace(configs.get(XLSTM), repeats=XLSTM_REPEATS)
    xsp = dict(MIXER_SERVE, prompt=XLSTM_PROMPT)
    out = zoo.serve_full(XLSTM, xsp, xcfg)
    print(f"  {XLSTM}: prefill 1 x {xsp['prompt']} {out['prefill_ms']:.2f} ms "
          f"({xsp['prompt']} steps x {xcfg.n_layers} layers of eager "
          f"ops), decode step {out['decode_step_ms']:.2f} ms; state wire by dtype "
          f"{out['by_dtype']}")
    # -- whisper-small: prefill with frames, the cache shipped, decode ------
    zoo.ship_and_decode("zoo_whisper_ship", WHISPER, configs.get(WHISPER), WHISPER_BATCH,
                        WHISPER_SEQ, WHISPER_DECODE, WHISPER_MAX_LEN)
    # -- jamba trained at full width, its pattern cut -------------------------
    pattern = tuple(next(s for s in full.pattern if (s.mixer, s.ffn) == kind)
                    for kind in (("mamba", "swiglu"), ("attn", "swiglu")))
    cfg = dataclasses.replace(full, pattern=pattern, repeats=1)
    di, ds = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    scan = {b: b * JAMBA_TRAIN_SEQ * di * ds * 4 for b in (4, 8)}  # one (B, S, di, ds) f32
    # live in one Mamba layer's backward: the doubling scan keeps a and b of
    # each of log2(256) steps, each chunk's h, da and db: ~20 such tensors
    free, tiny_peak = torch.cuda.mem_get_info(dev)[0], peaks.get("tinyllama_1_1b", 0)
    spare8 = free - max(tiny_peak, 17 * cfg.param_count() + 20 * scan[8])
    batch = 8 if spare8 >= 5 * 2**30 else 4
    print(f"zoo {JAMBA} train reckoning: a (B, {JAMBA_TRAIN_SEQ}, {di}, {ds}) f32 scan "
          f"tensor is {_gib(scan[4])} at B 4, {_gib(scan[8])} at B 8; at 8 x "
          f"{JAMBA_TRAIN_SEQ} about {_gib(17 * cfg.param_count() + 20 * scan[8])} for the "
          f"ZeRO-1 state and one layer's backward beside tinyllama's "
          f"{_gib(tiny_peak)} peak, {_gib(spare8)} spare of {_gib(free)} free: batch "
          f"{batch} x {JAMBA_TRAIN_SEQ}")
    comp, raw, recorded, _, meta, n_dp = zoo.train_twins(JAMBA, JAMBA_TRAIN_STEPS, batch,
                                                         JAMBA_TRAIN_SEQ, cfg)
    if meta.dtype_names != ("bfloat16", "float32"):
        raise AssertionError(f"jamba: buckets {meta.dtype_names}, expected bf16 and f32")
    launches["zoo_jamba_train"] = comp["launches"]
    twins_line(JAMBA, cfg, full, comp, raw, n_dp, batch, JAMBA_TRAIN_SEQ,
               f" (buckets {dict(zip(meta.dtype_names, meta.lengths))})")
    zoo.peak("jamba_train")
    gc.collect()
    torch.cuda.empty_cache()
    zoo.timed("zoo_jamba_train", recorded)
    del recorded
    # -- xlstm-350m trained at full width, XLSTM_REPEATS periods ---------------
    full = configs.get(XLSTM)
    t0 = time.perf_counter()
    comp, raw, recorded, names, meta, n_dp = zoo.train_twins(
        XLSTM, XLSTM_TRAIN_STEPS, XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ, xcfg)
    seconds = time.perf_counter() - t0
    launches["zoo_xlstm_train"] = comp["launches"]
    slstm = {f"blocks/{pi}/mixer/wk" for pi, s in enumerate(full.pattern) if s.mixer == "slstm"}
    zero = zero_blocks_in(recorded[0]["encode_fused"], names, meta, lambda n: n in slstm)
    twins_line(XLSTM, xcfg, full, comp, raw, n_dp, XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ,
               f" ({seconds:.1f} s for both twins)")
    print(f"  {XLSTM} first step's gradient bucket: {zero['zero_blocks']} of {zero['blocks']} "
          f"512-value blocks all zero ({zero['zero_share']:.6f}), {zero['inside']} of them in "
          f"sLSTM's wk (never read: {len(slstm)} x {full.d_model} x "
          f"{full.kv_heads * full.hd} values)")
    zoo.peak("xlstm_train")
    gc.collect()
    torch.cuda.empty_cache()
    zoo.timed("zoo_xlstm_train", recorded)
    del recorded
    # -- whisper-small: ZeRO-1 twins through train_step ------------------------
    cfg = configs.get(WHISPER)
    batches = [registry.make_batch(cfg, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ,
                                   rng=np.random.default_rng(SEED + i), device=dev)
               for i in range(WHISPER_TRAIN_STEPS)]

    def whisper_run(compress, group):
        """The launcher's run, by hand: its pipeline makes no frames."""
        policy = CompressionPolicy(min_bytes=0) if compress else CompressionPolicy.disabled()
        tcfg = step_lib.TrainConfig(policy=policy, loss_chunk=min(1024, WHISPER_TRAIN_SEQ))
        run = types.SimpleNamespace(
            losses=[], step_ms=[], plan_cache=PlanCache(), tcfg=tcfg,
            state=step_lib.build_train_state(cfg, tcfg,
                                             generator=torch.Generator().manual_seed(SEED),
                                             group=group, device=dev))
        with launch_train.deterministic():
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plan = step_lib.zero1_plan(run.state, tcfg, group, cache=run.plan_cache)
                run.losses.append(float(step_lib.train_step(run.state, b, tcfg, group=group,
                                                            plan=plan)["loss"]))
                torch.cuda.synchronize()
                run.step_ms.append((time.perf_counter() - t0) * 1e3)
        return run

    comp, raw, recorded, _, _, n_dp = zoo.train_twins(WHISPER, WHISPER_TRAIN_STEPS, None, None,
                                                      run_one=whisper_run)
    launches["zoo_whisper_train"] = comp["launches"]
    twins_line(WHISPER, cfg, cfg, comp, raw, n_dp, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ,
               f", frames {(WHISPER_TRAIN_BATCH, cfg.enc_seq, cfg.d_model)} "
               f"(train.step.train_step)")
    zoo.peak("whisper_train")
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    zoo.timed("zoo_whisper_train", recorded)


# per zoo run: the unit its launches are counted per, and how many
ZOO_UNITS = {"zoo_glm4_9b_pd": ("glm4_pd_admission", ZOO_SERVE["glm4_9b"]["n_req"]),
             "zoo_gemma3_27b_pd": ("gemma3_pd_admission", ZOO_SERVE["gemma3_27b"]["n_req"]),
             "zoo_qwen2_vl_ship": ("qwen2_vl_shipment", 1),
             "zoo_tinyllama_train": ("tinyllama_train_step", TINY_STEPS),
             f"zoo_{DEEPSEEK}_pd": ("deepseek_pd_admission", DEEPSEEK_SERVE["n_req"]),
             "zoo_deepseek_train": ("deepseek_train_step", DEEPSEEK_STEPS),
             f"zoo_{JAMBA}_pd": ("jamba_pd_admission", MIXER_SERVE["n_req"]),
             f"zoo_{XLSTM}_pd": ("xlstm_pd_admission", MIXER_SERVE["n_req"]),
             "zoo_whisper_ship": ("whisper_shipment", 1),
             "zoo_jamba_train": ("jamba_train_step", JAMBA_TRAIN_STEPS),
             "zoo_xlstm_train": ("xlstm_train_step", XLSTM_TRAIN_STEPS),
             "zoo_whisper_train": ("whisper_train_step", WHISPER_TRAIN_STEPS)}


# tp phase: ZeRO-1 with tensor and expert parallelism over 'model' in
# processes of their own on the one card, joined by a gloo group (NCCL
# refuses two ranks on one device), each capped at a share of its memory.
# tinyllama's depth is cut from 22 layers: at 22 a rank's bucket of 0.55 G
# values outgrew 17.4 GiB in the all-gather's plain decode (2.05 GiB more
# asked at 16.71 allocated), and four such ranks do not fit the card; a
# rank peaked at 14.17 GiB at 14 layers and 17.49 at 18 (~0.83 a layer),
# so 19 would pass 18.3 under a cap that leaves the card no room; it runs
# 12 layers, to keep chip_smoke.py in its time with the serve
# jobs
# loss_rel, gnorm_rel: the first step's loss and grad norm against the same
# model at model = 1 (the norm counting the leaves 'model' replicates once
# a model rank, the reference's count).  In f32 both agree within 1e-7
# (SMOKE, on the CPU); in bf16 the sums part in the last bits, and the MoE
# router's near ties may part between layouts (SMOKE on the CPU: tinyllama
# 6.2e-6 and 3.3e-4, deepseek 2.1e-4 and 6.7e-3); a missing sum over the
# model group moves either by far more
# the new jobs' bounds, set from tools/rehearse_tp.py at SMOKE size before
# their first run on the card: jamba FSDP at (2, 2) parted from model = 1
# by 1.20e-05 (loss) and 7.42e-03 (grad norm: the bf16 backward through
# the Mamba scan, ill-conditioned in both packages), xlstm at (1, 2) by
# 2.48e-06 and 3.53e-04; jamba's loss bound leaves room for its MoE
# router's near ties, as deepseek's does.  xlstm's grad norm bound was 1e-2
# and its first run on the card parted by 2.53e-02 at full width: the bf16
# backward through the exponential gates grows the layouts' rounding with
# the width and the steps (tools/tp_gap.py, on the CPU at d_model 1024, 4
# x 64: 6.0e-03 in bf16, 5.7e-08 in f32, so the split itself is exact);
# it is 5e-2 since
TP_JAMBA_LOSS_REL, TP_JAMBA_GNORM_REL = 1e-3, 5e-2
TP_XLSTM_LOSS_REL, TP_XLSTM_GNORM_REL = 1e-4, 5e-2
# tp_jamba_fsdp: FSDP at model > 1, jamba-v0.1-52b at full width cut to
# its pattern positions 3-4, (Mamba, MoE) then (attention, SwiGLU): one
# layer of each kind the job adds (3.67 B parameters, 0.92 B a rank), on
# Adafactor (deepseek-v3's FSDP optimizer): under AdamW (7.35 GB of
# moments a rank) a rank outgrew its 18.61 GiB cap at 14.62 GiB allocated
# asking 1.75 more, without the (attention, SwiGLU) layer at 14.92 asking
# 1.75, and with growing segments at 17.83 asking 0.88; on Adafactor it
# peaks at 14.33 GiB with both layers;
# tp_xlstm: mLSTM and sLSTM split over their heads, one period of
# xlstm-350m (7 mLSTM + 1 sLSTM), 2 of its 4 heads a rank;
# tp_serve_*: ServeEngine at (data, model) = (1, 2), colocated then PD
# (each rank ships its own block of every admitted cache), on jamba cut
# as tp_jamba_fsdp (prompts of 508 fill rank 0's block of 512 positions,
# the decode steps cross into rank 1's), deepseek-v2-lite cut as
# tp_deepseek (prompts of 600 fill both blocks) and one period of
# xlstm-350m.  logits_rel: the prefills' and the first TP_SERVE_STEPS
# decode steps' logits against the same model at model = 1 (fed the
# ranks' tokens), the largest difference over the largest magnitude; set
# from tools/tp_gap.py --serve at full width before the jobs' first run:
# on the H100 jamba 1.434e-01 and deepseek 2.933e-01 in bf16 (2.3e-05 and
# 2.7e-06 in f32: the split is exact, the bf16 layouts round apart and the
# MoE routers' near ties part), on the CPU xlstm 3.067e-02 (f32 6.9e-06);
# about twice each, three times xlstm's (the card rounds otherwise)
TP_SERVE_STEPS = 4
TP_SERVE_JAMBA_REL, TP_SERVE_DEEPSEEK_REL, TP_SERVE_XLSTM_REL = 0.3, 0.6, 0.1
TP_JOBS = {
    "tp_tinyllama": dict(arch="tinyllama_1_1b", shape=(2, 2), batch=8, seq=512, steps=3,
                         repeats=3, mem=0.235, loss_rel=2e-4, gnorm_rel=1e-2),
    "tp_deepseek": dict(arch=DEEPSEEK, shape=(1, 2), batch=8, seq=512, steps=2,
                        repeats=DEEPSEEK_REPEATS, mem=0.45, loss_rel=1e-3, gnorm_rel=2e-2),
    "tp_jamba_fsdp": dict(arch="jamba_v0_1_52b", shape=(2, 2), batch=4, seq=512, steps=2,
                          pattern=(3, 4), repeats=1, partition="fsdp", optimizer="adafactor",
                          mem=0.235,
                          loss_rel=TP_JAMBA_LOSS_REL, gnorm_rel=TP_JAMBA_GNORM_REL),
    "tp_xlstm": dict(arch="xlstm_350m", shape=(1, 2), batch=8, seq=128, steps=2, repeats=1,
                     mem=0.45, loss_rel=TP_XLSTM_LOSS_REL, gnorm_rel=TP_XLSTM_GNORM_REL),
    "tp_serve_jamba": dict(arch="jamba_v0_1_52b", shape=(1, 2), pattern=(3, 4), repeats=1,
                           mem=0.45, logits_rel=TP_SERVE_JAMBA_REL,
                           serve=dict(n_req=4, prompt=508, new=16, slots=4, max_len=1024)),
    "tp_serve_deepseek": dict(arch=DEEPSEEK, shape=(1, 2), repeats=DEEPSEEK_REPEATS, mem=0.45,
                              logits_rel=TP_SERVE_DEEPSEEK_REL, ingest=True,
                              serve=dict(n_req=4, prompt=600, new=16, slots=4, max_len=1024)),
    "tp_serve_xlstm": dict(arch="xlstm_350m", shape=(1, 2), repeats=1, mem=0.45,
                           logits_rel=TP_SERVE_XLSTM_REL,
                           serve=dict(n_req=2, prompt=120, new=16, slots=2, max_len=192)),
}
TP_TIMEOUT = 600  # seconds a job's processes may take
# a serve job that ingests (``ingest``): the seed of the change between its
# full and its delta update, and the requests (and new tokens each) served
# colocated and PD on the ingested weights
TP_INGEST_CHANGE, TP_INGEST_SERVE = 5, (2, 8)


def tp_config(job):
    """The job's config: its arch at full width, its depth cut to
    ``repeats`` and (where the job says) to the ``pattern`` positions it
    lists."""
    from repro_torch import configs

    cfg = configs.get(job["arch"])
    if "pattern" in job:
        cfg = dataclasses.replace(cfg, pattern=tuple(cfg.pattern[i] for i in job["pattern"]))
    return cfg if job["repeats"] is None else dataclasses.replace(cfg, repeats=job["repeats"])


def tp_child(rank, world, store, out, job):
    """One rank of a tp job (spawned; the kernels are built): the
    launcher's path for the job's partition (ZeRO-1 unless it says FSDP)
    on a (data, model) mesh over a gloo group on cuda:0, compressed then
    raw; its numbers (and rank 0's kernel inputs) saved to ``out``."""
    import torch
    import torch.distributed as dist

    if job.get("device", "cuda") == "cuda":  # a CPU rehearsal sets "cpu"
        torch.cuda.set_device(0)
        torch.cuda.set_per_process_memory_fraction(job["mem"], 0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        torch.save(_tp_child_runs(rank, job, torch), out)
    finally:
        dist.destroy_process_group()


def tp_serve_prompts(cfg, sp, np) -> list:
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab, sp["prompt"]).astype(np.int32)
            for _ in range(sp["n_req"])]


@contextlib.contextmanager
def tp_serve_logits(torch):
    """While active, the logits of ``transformer.prefill`` and
    ``transformer.decode_step`` as the engine calls them, on the host:
    ``{"prefill": [...], "decode": [...]}``, the first TP_SERVE_STEPS decode
    steps' only."""
    from repro_torch.models import transformer

    seen = {"prefill": [], "decode": []}
    orig = transformer.prefill, transformer.decode_step

    def prefill(*a, **kw):
        out = orig[0](*a, **kw)
        seen["prefill"].append(out[0].float().cpu())
        return out

    def decode_step(*a, **kw):
        out = orig[1](*a, **kw)
        if len(seen["decode"]) < TP_SERVE_STEPS:
            seen["decode"].append(out[0].float().cpu())
        return out

    transformer.prefill, transformer.decode_step = prefill, decode_step
    try:
        yield seen
    finally:
        transformer.prefill, transformer.decode_step = orig


def tp_serve_run(cfg, model, sp, pd, torch, np, n_req=None, new=None) -> tuple:
    """``ServeEngine`` over the job's prompts (the first ``n_req``, ``new``
    tokens each), colocated or PD over the host KV wire (a fresh
    PlanCache): ((rid, tokens) sorted, seconds to the last token)."""
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.sched.cache import PlanCache
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    scfg = ServeConfig(batch_slots=sp["slots"], max_len=sp["max_len"],
                       prefill_chunk=sp["prompt"], pd_disaggregated=pd)
    eng = ServeEngine(cfg, model, scfg, kv_plan_cache=PlanCache() if pd else None,
                      kv_policy=CompressionPolicy(min_bytes=0) if pd else None)
    for i, p in enumerate(tp_serve_prompts(cfg, sp, np)[:n_req]):
        eng.submit(Request(rid=i, prompt=p, max_new=new or sp["new"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    return sorted((r.rid, tuple(r.out)) for r in done), time.perf_counter() - t0


def _tp_child_serve(rank, job, torch):
    """A serve job's rank: this rank's blocks of the job's model (a
    generator on the card seeded SEED, as the parent's model = 1), one
    warm-up request, then the engine colocated and PD; per run its
    tokens, recorded logits, launches, shape tallies, peak memory and
    seconds (rank 0's PD run also its kernel inputs)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    from repro_torch.tree_util import tree_flatten

    dev = torch.device("cuda", 0) if job.get("device", "cuda") == "cuda" else torch.device("cpu")
    mesh = mesh_lib.make_mesh(job["shape"], ("data", "model"), device=dev)
    cfg, sp = tp_config(job), job["serve"]
    model = transformer.init(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev,
                             mesh=mesh)
    block = transformer.cache_struct(cfg, 1, sp["max_len"], mesh=mesh)
    leaves = [t for t in tree_flatten(block)[0] if t.dim()]
    out = {"runs": {}, "mrank": model.mg.rank, "block_shapes": sorted(
        {tuple(t.shape) for t in leaves}), "block_bytes": sum(
        t.numel() * t.element_size() for t in leaves)}
    with launch_train.deterministic():
        tp_serve_run(cfg, model, sp, False, torch, np, n_req=1, new=2)  # warm-up
        for pd in (False, True):
            record = pd and rank == 0
            torch.cuda.reset_peak_memory_stats(dev)
            with (recorded_inputs(torch, host=True) if record else
                  contextlib.nullcontext(None)) as inputs, tp_serve_logits(torch) as seen:
                kernels.clear_launch_counts()
                tokens, secs = tp_serve_run(cfg, model, sp, pd, torch, np)
                launches = kernels.launch_counts()
            out["runs"][pd] = {"tokens": tokens, "logits": seen, "launches": launches,
                               "tallies": shape_tallies(), "seconds": secs,
                               "peak": torch.cuda.max_memory_allocated(dev)}
            if record:
                out["inputs"] = inputs
    expect = dict.fromkeys(kernels.KERNELS, 0)
    expect.update(pack=2 * len(leaves) * sp["n_req"], unpack=2 * len(leaves) * sp["n_req"])
    out["expect"] = expect
    if "ingest_path" in job:
        with launch_train.deterministic():
            out["ingest"] = _tp_child_ingest(rank, job, cfg, model, torch, np)
    return out


def tp_block_sha(leaves, torch) -> str:
    """sha256 over the bytes of ``leaves`` in order."""
    import hashlib

    h = hashlib.sha256()
    for t in leaves:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _tp_child_ingest(rank, job, cfg, model, torch, np) -> dict:
    """A serve job's rank after its serve runs: an engine on the rank's
    blocks ingests the parent's full update, then its delta
    (``ServeEngine.ingest_weights`` at model > 1), each timed (apply ms),
    its launches counted and the sha256 of the rank's blocks taken; a
    corrupted copy of the delta must be refused with the blocks and the
    version untouched; then TP_INGEST_SERVE requests colocated and PD on
    the new weights (rank 0 records its kernel inputs)."""
    from repro_torch import kernels
    from repro_torch.core.integrity import WireIntegrityError
    from repro_torch.runtime.faults import corrupt_payload
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    ups = torch.load(job["ingest_path"], weights_only=False)
    sp = job["serve"]
    eng = ServeEngine(cfg, model, ServeConfig(batch_slots=1, max_len=sp["max_len"]))
    res = {"updates": {}}
    dev = model.leaves()[0].device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with (recorded_inputs(torch, host=True) if rank == 0 else
          contextlib.nullcontext(None)) as inputs:
        kernels.clear_launch_counts()
        seen = dict.fromkeys(kernels.KERNELS, 0)
        for name in ("full", "delta"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            version = eng.ingest_weights(ups[name])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            now = kernels.launch_counts()
            res["updates"][name] = {
                "version": version, "epoch": eng.weight_epoch, "ms": ms,
                "launches": {k: now[k] - seen[k] for k in now},
                "sha": tp_block_sha(model.leaves(), torch)}
            seen = now
        res["launches"], res["tallies"] = kernels.launch_counts(), shape_tallies()
    res["peak"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if inputs is not None:
        res["inputs"] = inputs
    before = res["updates"]["delta"]["sha"]
    try:
        eng.ingest_weights(corrupt_payload(ups["delta"], np.random.default_rng(SEED)))
        res["corrupt"] = ""
    except WireIntegrityError as e:
        res["corrupt"] = str(e)
    res["untouched"] = (tp_block_sha(model.leaves(), torch) == before
                        and eng.weight_version == res["updates"]["delta"]["version"])
    n_req, new = TP_INGEST_SERVE
    res["tokens"] = {pd: tp_serve_run(cfg, model, sp, pd, torch, np, n_req=n_req, new=new)[0]
                     for pd in (False, True)}
    return res


def tp_ingest_updates(job, dev, torch, np, path) -> dict:
    """The parent's side of a serve job's ingestion: the job's weights at
    model = 1 (the ranks' init), a full update of them and, after
    TP_INGEST_CHANGE (the low 3 mantissa bits of about 30% of every leaf
    XORed with a seeded mask, as consecutive optimizer steps move them), a
    delta (``WeightSyncEngine.update_for``), saved to ``path``; each
    update decoded whole here (``apply_update``, the delta against the
    full one's leaves) and, per model rank, the sha256 of its blocks of
    the decoded leaves (``transformer.block_specs``).  Returns the updates'
    modes, ratios, wire bytes, the hashes and each rank's expected
    launches (unpack twice a compressed bucket)."""
    import gc

    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.models import transformer
    from repro_torch.sched.cache import PlanCache
    from repro_torch.sync.engine import WeightSyncEngine, apply_update, decode_chunks
    from repro_torch.tree_util import tree_leaves

    cfg, n_model = tp_config(job), job["shape"][1]
    model = transformer.init(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    sync = WeightSyncEngine(policy=CompressionPolicy(min_bytes=0), plan_cache=PlanCache())
    v1 = sync.publish(model.tree())
    full = sync.update_for("tp")
    sync.ack("tp", v1)
    gen = torch.Generator(dev).manual_seed(TP_INGEST_CHANGE)
    ints = {2: torch.int16, 4: torch.int32}
    with torch.no_grad():
        for p in model.leaves():
            bits = p.view(ints[p.element_size()])
            mask = torch.randint(0, 8, p.shape, generator=gen, device=dev).to(bits.dtype)
            bits.bitwise_xor_(mask * (torch.rand(p.shape, generator=gen, device=dev) < 0.3))
    sync.publish(model.tree())
    delta = sync.update_for("tp")
    torch.save({"full": full, "delta": delta}, path)
    specs = transformer.block_specs(cfg, n_model)
    paths = [q for q, _ in transformer.tree_paths(transformer.abstract_params(cfg))]

    def block(t, spec, r):
        for d, e in enumerate(spec):
            if e == "model":
                n = t.shape[d] // n_model
                t = t.narrow(d, r * n, n)
        return t

    out = {"sha": {}, "modes": {}, "ratio": {}, "wire": {}, "expect": {}}
    whole = None
    for name, u in (("full", full), ("delta", delta)):
        whole = tree_leaves(apply_update(u, base_params=whole, device=dev))
        out["sha"][name] = [tp_block_sha([block(t, specs[q], r) for q, t in zip(paths, whole)],
                                         torch) for r in range(n_model)]
        out["modes"][name] = [m for _, _, m, _ in u.buckets]
        out["ratio"][name], out["wire"][name] = u.ratio, u.wire_bytes
        out["expect"][name] = 2 * sum(len(decode_chunks(members))
                                      for _, members, m, _ in u.buckets if m != "raw")
    if tp_block_sha(whole, torch) != tp_block_sha(model.leaves(), torch):
        raise AssertionError("the decoded delta update is not the published weights")
    del model, sync, whole
    gc.collect()
    return out


def tp_serve_model1(job, tokens, dev, torch, np) -> tuple:
    """A serve job's model at model = 1 in this process (the ranks' init):
    each prompt prefilled into its slot of a batched cache, then
    TP_SERVE_STEPS decode steps fed the ranks' tokens ``tokens`` ((rid,
    tokens) sorted; request ``i`` took slot ``i``); returns the prefills'
    and the steps' logits on the host."""
    import gc

    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine

    cfg, sp = tp_config(job), job["serve"]
    model = transformer.init(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    cache = transformer.init_cache(cfg, sp["slots"], sp["max_len"], dev)
    pre, dec = [], []
    with launch_train.deterministic():
        for i, p in enumerate(tp_serve_prompts(cfg, sp, np)):
            lg, one = transformer.prefill(model, torch.from_numpy(p[None].astype(np.int64)).to(dev),
                                          transformer.init_cache(cfg, 1, sp["max_len"], dev))
            ServeEngine._splice_impl(cache, one, i)
            pre.append(lg.float().cpu())
        cache["pos"] = torch.tensor(sp["prompt"], dtype=torch.int32, device=dev)
        for k in range(TP_SERVE_STEPS):
            feed = torch.tensor([[out[k]] for _, out in tokens], dtype=torch.int32, device=dev)
            lg, cache = transformer.decode_step(model, feed, cache)
            dec.append(lg.float().cpu())
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()
    return pre, dec


def tp_serve_job(tag, job, dev, torch, np) -> tuple:
    """Run a serve job's ranks and check them: on every rank the PD run's
    tokens and logits equal the colocated run's, and every rank's equal
    rank 0's (the same whole logits, the same greedy picks); the colocated
    run launches nothing, PD pack and unpack twice a block leaf an
    admission; the prefills' and first TP_SERVE_STEPS steps' logits
    within ``logits_rel`` of the model at model = 1; the share of its
    greedy picks equal to the ranks' tokens is reported.  A job that
    ingests (:func:`tp_ingest_updates`, :func:`_tp_child_ingest`): every
    rank's blocks after each update have the sha256 of its blocks of the
    decoded whole leaves, its launches are unpack twice a piece of a
    compressed bucket, every rank holds the same version and epoch, a corrupted copy
    is refused on every rank with its blocks untouched, and the PD tokens
    on the new weights equal the colocated ones on every rank.  Returns
    the runs as ``(run, launches of all ranks, rank 0's (inputs, tallies
    of all ranks), (unit, count))``: the PD serve run and, where the job
    ingests, the ingestion."""
    import tempfile

    from repro_torch import configs, kernels

    cfg, sp = tp_config(job), job["serve"]
    free = torch.cuda.mem_get_info(dev)[0]
    ingest = None
    with tempfile.TemporaryDirectory(prefix="ingest_") as tmp:
        if job.get("ingest"):
            path = os.path.join(tmp, "updates.pt")
            ingest = tp_ingest_updates(job, dev, torch, np, path)
            torch.cuda.empty_cache()
            job = dict(job, ingest_path=path)
        ranks = run_tp_job(job, torch)
    col0 = ranks[0]["runs"][False]
    total, tallies = dict.fromkeys(kernels.KERNELS, 0), {k: {} for k in SHAPED}
    for r, res in enumerate(ranks):
        col, pd = res["runs"][False], res["runs"][True]
        for run, name in ((pd, "PD"), (col, "colocated")):
            if run["tokens"] != col0["tokens"] or any(
                    len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b))
                    for key in ("prefill", "decode")
                    for a, b in [(run["logits"][key], col0["logits"][key])]):
                raise AssertionError(f"{tag} rank {r}: {name} tokens or logits differ from "
                                     f"rank 0's colocated run")
        if any(col["launches"].values()) or pd["launches"] != res["expect"]:
            raise AssertionError(f"{tag} rank {r}: launches {pd['launches']} (colocated "
                                 f"{col['launches']}), expected {res['expect']}")
        if len(col0["tokens"]) != sp["n_req"] or any(
                len(o) != sp["new"] or not all(0 <= t < cfg.vocab for t in o)
                for _, o in col0["tokens"]):
            raise AssertionError(f"{tag}: unexpected serve output {col0['tokens']}")
        for k, v in pd["launches"].items():
            total[k] += v
        for k, by in pd["tallies"].items():
            if not set(by) <= set(ranks[0]["inputs"][k]):
                raise AssertionError(f"{tag} rank {r}: {k} at {list(by)}, rank 0 recorded "
                                     f"{list(ranks[0]['inputs'][k])}")
            for shape, n in by.items():
                tallies[k][shape] = tallies[k].get(shape, 0) + n
    pre, dec = tp_serve_model1(job, col0["tokens"], dev, torch, np)
    got = torch.cat([*col0["logits"]["prefill"], *col0["logits"]["decode"]])
    want = torch.cat([*pre, *dec])
    gap = float((got - want).abs().max() / want.abs().max())
    picks = torch.cat([torch.cat(pre)[:, -1].argmax(-1)[:, None],
                       torch.stack([d[:, -1].argmax(-1) for d in dec], 1)], 1)
    ranks_picks = torch.tensor([list(o[:TP_SERVE_STEPS + 1]) for _, o in col0["tokens"]])
    share = float((picks == ranks_picks).float().mean())
    if not gap <= job["logits_rel"]:
        raise AssertionError(f"{tag}: logits {gap:.3e} of the largest from model = 1's, "
                             f"bound {job['logits_rel']}")
    world = len(ranks)
    full = configs.get(job["arch"])
    layers = ", ".join(f"{s.mixer}+{s.ffn}" for s in cfg.pattern)
    print(f"{tag}: {job['arch']} d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"{cfg.kv_heads} KV heads, vocab {cfg.vocab}, {cfg.n_layers} of {full.n_layers} "
          f"layers ({layers}){f', {cfg.moe.n_experts} experts' if cfg.moe.n_experts else ''}; "
          f"ServeEngine at (data, model) = {job['shape']}, {world} processes on cuda:0 over "
          f"gloo, each capped at {job['mem']} of the card ({_gib(free)} free before them); "
          f"{sp['n_req']} requests x {sp['prompt']} prompt + {sp['new']} new tokens, "
          f"{sp['slots']} slots, max_len {sp['max_len']}; a rank's cache block "
          f"{ranks[0]['block_shapes']}, {ranks[0]['block_bytes']} bytes a request")
    for r, res in enumerate(ranks):
        col, pd = res["runs"][False], res["runs"][True]
        n_tok = sp["n_req"] * sp["new"]
        print(f"  rank {r} (model rank {res['mrank']}): PD tokens and logits identical to "
              f"colocated and to rank 0's; tokens/s colocated {n_tok / col['seconds']:.1f} "
              f"({col['seconds'] * 1e3:.1f} ms), PD {n_tok / pd['seconds']:.1f} "
              f"({pd['seconds'] * 1e3:.1f} ms) (host-staged gloo); peak "
              f"{_gib(max(col['peak'], pd['peak']))}; PD launches {pd['launches']}")
    print(f"  logits of the {sp['n_req']} prefills and {TP_SERVE_STEPS} decode steps vs model = "
          f"1 (one process, the same seed, fed the ranks' tokens): largest difference "
          f"{gap:.3e} of the largest |logit| {float(want.abs().max()):.4g} (bound "
          f"{job['logits_rel']}); greedy picks equal to the ranks' tokens {share:.4f}")
    runs = [(tag, total, (ranks[0].pop("inputs"), tallies),
             (f"{tag}_rank_admission", job["shape"][1] * sp["n_req"]))]
    if ingest is not None:
        runs.append(tp_ingest_check(tag, ranks, ingest, torch))
    return runs


def tp_ingest_check(tag, ranks, ingest, torch) -> tuple:
    """Check a serve job's ingestion on every rank (see :func:`tp_serve_job`)
    and print each update's ratio and apply ms; returns its run as
    :func:`tp_serve_job` does."""
    from repro_torch import kernels

    total, tallies = dict.fromkeys(kernels.KERNELS, 0), {k: {} for k in SHAPED}
    first = ranks[0]["ingest"]
    for r, res in enumerate(ranks):
        g = res["ingest"]
        for name in ("full", "delta"):
            u, u0 = g["updates"][name], first["updates"][name]
            want = dict.fromkeys(kernels.KERNELS, 0)
            want["unpack"] = ingest["expect"][name]
            if u["sha"] != ingest["sha"][name][res["mrank"]]:
                raise AssertionError(f"{tag} rank {r}: its blocks after the {name} update are "
                                     f"not its blocks of the decoded whole leaves")
            if u["launches"] != want or (u["version"], u["epoch"]) != (u0["version"],
                                                                       u0["epoch"]):
                raise AssertionError(f"{tag} rank {r}: {name} ingest launches {u['launches']} "
                                     f"(expected {want}), version {u['version']}@{u['epoch']} "
                                     f"(rank 0 {u0['version']}@{u0['epoch']})")
        if "checksum" not in g["corrupt"] or not g["untouched"]:
            raise AssertionError(f"{tag} rank {r}: a corrupted update gave {g['corrupt']!r}, "
                                 f"blocks untouched {g['untouched']}")
        if g["tokens"][True] != g["tokens"][False] or g["tokens"][False] != first["tokens"][False]:
            raise AssertionError(f"{tag} rank {r}: tokens after ingest differ (PD, colocated, "
                                 f"rank 0's)")
        for k, v in g["launches"].items():
            total[k] += v
        for k, by in g["tallies"].items():
            if not set(by) <= set(first["inputs"][k]):
                raise AssertionError(f"{tag} rank {r}: ingest {k} at {list(by)}, rank 0 "
                                     f"recorded {list(first['inputs'][k])}")
            for shape, n in by.items():
                tallies[k][shape] = tallies[k].get(shape, 0) + n
    for name in ("full", "delta"):
        modes = ingest["modes"][name]
        print(f"  ingest {name} v{first['updates'][name]['version']}: buckets "
              f"{modes}, ratio {ingest['ratio'][name]:.4f} ({ingest['wire'][name]} wire bytes); "
              f"apply ms " + ", ".join(f"rank {r} {res['ingest']['updates'][name]['ms']:.1f}"
                                      for r, res in enumerate(ranks))
              + f"; each rank's blocks = its blocks of the decoded leaves (sha256); launches "
              f"{first['updates'][name]['launches']}")
    print(f"  a corrupted update refused on every rank ({first['corrupt'][:60]}...), blocks "
          f"untouched; {TP_INGEST_SERVE[0]} requests on the new weights: PD tokens = colocated "
          f"on every rank; a rank's peak while ingesting " + ", ".join(
              _gib(res["ingest"]["peak"]) for res in ranks))
    return (f"{tag}_ingest", total, (first.pop("inputs"), tallies),
            (f"{tag}_rank_update", 2 * len(ranks)))


def _tp_child_runs(rank, job, torch):
    import gc
    import hashlib

    from repro_torch import kernels
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.train import step as step_lib

    import torch.distributed as dist

    if "serve" in job:
        return _tp_child_serve(rank, job, torch)
    dev = torch.device("cuda", 0) if job.get("device", "cuda") == "cuda" else torch.device("cpu")
    mesh = mesh_lib.make_mesh(job["shape"], ("data", "model"), device=dev)
    partition = job.get("partition", "zero1")
    name = "fsdp_train_step" if partition == "fsdp" else "train_step"
    gnorms, step_fn = [], getattr(step_lib, name)

    def recording(*args, **kw):  # the launcher's step, its grad norm kept
        m = step_fn(*args, **kw)
        gnorms.append(float(m["gnorm"]))
        return m

    setattr(step_lib, name, recording)
    out = {"runs": {}}
    try:
        for compress in (True, False):
            gnorms.clear()
            torch.cuda.reset_peak_memory_stats(dev)
            record = compress and rank == 0
            with (recorded_inputs(torch, host=True) if record else
                  contextlib.nullcontext(None)) as inputs:
                kernels.clear_launch_counts()
                run = launch_train.train(
                    tp_config(job), steps=job["steps"], batch=job["batch"], seq=job["seq"],
                    compress=compress, device=dev, seed=SEED, mesh=mesh, partition=partition,
                    optimizer=job.get("optimizer", "adamw"),
                    generator=torch.Generator(dev).manual_seed(SEED))
                launches = kernels.launch_counts()
            st = run.state
            n_dp = dist.get_world_size(st.group)
            if partition == "fsdp":  # the gathers and reduce-scatters of the plan
                n_ag, n_rs, _, _ = fsdp_work(st, run.tcfg)
                per_step, buckets, n = fsdp_launches(n_ag, n_rs, n_dp), 0, []
            else:  # one two-shot a bucket
                buckets, n = len(st.meta.dtype_names), list(st.meta.padded)
                per_step = {k: buckets * v for k, v in two_shot_launches(True, True, n_dp).items()}
            expect = dict.fromkeys(kernels.KERNELS, 0)
            expect.update({k: job["steps"] * v for k, v in per_step.items()})
            out["runs"][compress] = {
                "losses": run.losses, "gnorms": list(gnorms), "step_ms": run.step_ms,
                "retries": run.retries, "launches": launches, "tallies": shape_tallies(),
                "peak": torch.cuda.max_memory_allocated(dev),
                "digests": [hashlib.sha256(p.detach().contiguous().view(torch.uint8).cpu()
                                           .numpy()).hexdigest() for p in st.model.leaves()],
                "buckets": buckets, "n": n, "n_dp": n_dp, "mrank": st.model.mg.rank,
                "expect": expect}
            if record:
                out["inputs"] = inputs
            del run, st
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        setattr(step_lib, name, step_fn)
    return out


def tp_model1_ref(job, dev, torch) -> tuple:
    """The first step's loss and grad norm of a tp job's model at model = 1
    in this process: the ranks' init (a generator on the card seeded SEED),
    the launcher's first global batch, one forward and backward.  A ZeRO-1
    job's norm counts each leaf that the job's mesh replicates over
    'model' (``step.model_specs``) once a model rank, as the step's sum
    over the model group does (the reference's count); an FSDP job's
    counts each leaf once, as the reference's FSDP step does."""
    import gc

    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer
    from repro_torch.train import step as step_lib

    cfg = tp_config(job)
    model = transformer.init(cfg, generator=torch.Generator(dev).manual_seed(SEED), device=dev)
    batch = DataPipeline(DataConfig(vocab=cfg.vocab, global_batch=job["batch"],
                                    seq_len=job["seq"], seed=SEED)).tensors_at(0, dev)
    loss = step_lib.loss_fn(model, batch, step_lib.TrainConfig(loss_chunk=min(1024, job["seq"])))
    loss.backward()
    n_model = 1 if job.get("partition") == "fsdp" else job["shape"][1]
    specs = dict(transformer.tree_paths(step_lib.model_specs(
        cfg, mesh_lib.AbstractMesh(job["shape"], ("data", "model")))))
    norm_sq = sum(float(torch.sum(torch.square(p.grad.float())))
                  * (1 if "model" in specs[path] else n_model)
                  for path, p in model.params.items() if p.grad is not None)
    loss = float(loss)
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return loss, norm_sq ** 0.5


def run_tp_job(job, torch) -> list:
    """A tp job's ranks in spawned processes (a FileStore in a temporary
    directory); every process is joined or killed.  Returns each rank's
    saved numbers; a rank that fails or outlives TP_TIMEOUT fails it."""
    import multiprocessing
    import tempfile

    world = int(job["shape"][0] * job["shape"][1])
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tp_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=tp_child,
                             args=(r, world, os.path.join(tmp, "store"), outs[r], job))
                 for r in range(world)]
        for p in procs:
            p.start()
        t_end = time.monotonic() + TP_TIMEOUT
        try:
            for p in procs:
                p.join(max(1.0, t_end - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise AssertionError(f"tp {job['arch']}: ranks exited {codes}")
        return [torch.load(o, weights_only=False) for o in outs]


def phase_tp(dev, torch, np, bw):
    """ZeRO-1 with tensor and expert parallelism over 'model' (TP_JOBS), each
    job's ranks in processes of their own on the card: tinyllama-1.1b at
    full width, 3 of 22 layers, on (data, model) = (2, 2),
    deepseek-v2-lite at full width, its depth cut, on (1, 2) (32 of its
    64 experts a rank).
    Every rank's compressed and raw twins bit-identical (losses, grad
    norms, a digest of every local leaf), no retry, the launches
    two_shot_launches a step and bucket; each job's first loss within its
    loss_rel, and its first grad norm within its gnorm_rel, of its model at
    model = 1 here.  Rank 0's kernel inputs held against the plain
    versions and timed at each shape every rank tallied.  Step times
    cross the host through gloo: they are no measure of NVLink.  Returns the launches of each job (all its ranks),
    their units and the timed shapes, as merge_zoo reads them."""
    from repro_torch import configs, kernels

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches, shapes, units = {}, {}, {}
    for tag, job in TP_JOBS.items():
        t0 = time.perf_counter()
        if "serve" in job:
            for run, total, recorded, unit in tp_serve_job(tag, job, dev, torch, np):
                launches[run], units[run] = total, unit
                merge_shapes(shapes, time_path_shapes({run: recorded}, {run: total}, bw, dev,
                                                      torch))
                del recorded
            torch.cuda.empty_cache()
            print(f"  {tag}: {time.perf_counter() - t0:.1f} s")
            continue
        cfg = tp_config(job)
        ref_loss, ref_gnorm = tp_model1_ref(job, dev, torch)
        free = torch.cuda.mem_get_info(dev)[0]
        ranks = run_tp_job(job, torch)
        comp0 = ranks[0]["runs"][True]
        n_dp = comp0["n_dp"]
        expect = comp0["expect"]
        total, tallies = dict.fromkeys(kernels.KERNELS, 0), {k: {} for k in SHAPED}
        for r, res in enumerate(ranks):
            comp, raw = res["runs"][True], res["runs"][False]
            for key in ("losses", "gnorms", "digests"):
                if comp[key] != raw[key]:
                    raise AssertionError(f"{tag} rank {r}: compressed and raw {key} differ")
            if comp["retries"] or raw["retries"] or any(raw["launches"].values()):
                raise AssertionError(f"{tag} rank {r}: retries {comp['retries']}, raw "
                                     f"launches {raw['launches']}")
            if comp["expect"] != expect or comp["launches"] != expect:
                raise AssertionError(f"{tag} rank {r}: launches {comp['launches']}, "
                                     f"expected {expect}")
            if not all(np.isfinite(comp["losses"])) or comp["losses"] != comp0["losses"]:
                raise AssertionError(f"{tag} rank {r}: losses {comp['losses']} vs rank 0's "
                                     f"{comp0['losses']}")
            for k, v in comp["launches"].items():
                total[k] += v
            for k, by in comp["tallies"].items():
                if not set(by) <= set(ranks[0]["inputs"][k]):
                    raise AssertionError(f"{tag} rank {r}: {k} at {list(by)}, rank 0 "
                                         f"recorded {list(ranks[0]['inputs'][k])}")
                for shape, n in by.items():
                    tallies[k][shape] = tallies[k].get(shape, 0) + n
        gap = abs(comp0["losses"][0] - ref_loss) / abs(ref_loss)
        ggap = abs(comp0["gnorms"][0] - ref_gnorm) / abs(ref_gnorm)
        if not (gap <= job["loss_rel"] and ggap <= job["gnorm_rel"]):
            raise AssertionError(f"{tag}: first loss {comp0['losses'][0]} vs {ref_loss}, grad "
                                 f"norm {comp0['gnorms'][0]} vs {ref_gnorm} at model = 1, "
                                 f"relative {gap}, {ggap}")
        world = len(ranks)
        launches[tag] = total
        units[tag] = (f"{tag}_rank_step", world * job["steps"])
        full = configs.get(job["arch"])
        layers = ", ".join(f"{s.mixer}+{s.ffn}" for s in cfg.pattern)
        wire = (f"FSDP, {job.get('optimizer', 'adamw')}, gathers and reduce-scatters "
                f"{expect}" if job.get("partition") == "fsdp" else
                f"ZeRO-1, bucket n={comp0['n']} a model rank")
        print(f"{tag}: {job['arch']} d_model {cfg.d_model}, {cfg.n_heads} heads, "
              f"{cfg.kv_heads} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
              f"{cfg.n_layers} of {full.n_layers} layers ({layers})"
              f"{f', {cfg.moe.n_experts} experts' if cfg.moe.n_experts else ''}; "
              f"(data, model) = {job['shape']}, {world} processes on cuda:0 over gloo, each "
              f"capped at {job['mem']} of the card ({_gib(free)} free before them); batch "
              f"{job['batch']} x {job['seq']}; {wire}, n_dp={n_dp}")
        for r, res in enumerate(ranks):
            comp, raw = res["runs"][True], res["runs"][False]
            print(f"  rank {r} (model rank {comp['mrank']}): losses {comp['losses']} gnorms "
                  f"{comp['gnorms']} twins identical (losses, grad norms, "
                  f"{len(comp['digests'])} leaf digests); step_ms compressed "
                  f"{[round(t, 1) for t in comp['step_ms']]} raw "
                  f"{[round(t, 1) for t in raw['step_ms']]} (host-staged gloo, not NVLink); "
                  f"peak {_gib(max(comp['peak'], raw['peak']))}; launches {comp['launches']}")
        print(f"  first loss {comp0['losses'][0]!r} vs {ref_loss!r} at model = 1 (one "
              f"process, the same seed and batch): relative gap {gap:.3e} (bound "
              f"{job['loss_rel']}); first grad norm {comp0['gnorms'][0]!r} vs "
              f"{ref_gnorm!r}: relative gap {ggap:.3e} (bound {job['gnorm_rel']})")
        recorded = (ranks[0].pop("inputs"), tallies)
        del ranks
        merge_shapes(shapes, time_path_shapes({tag: recorded}, {tag: total}, bw, dev, torch))
        del recorded
        torch.cuda.empty_cache()
        print(f"  {tag}: {time.perf_counter() - t0:.1f} s")
    seconds = time.perf_counter() - t_phase
    print(f"tp: {seconds:.1f} s, card {run_card()}")
    return {"launches": launches, "units": units, "shapes": shapes, "seconds": seconds}


def merge_zoo(rows: list, zoo: dict) -> None:
    """Add the zoo phase's launches (by run and per unit: ZOO_UNITS, or the
    phase's own ``units``) and its timed shapes to the ``kernels`` rows of
    phase_times."""
    units = {**ZOO_UNITS, **zoo.get("units", {})}
    for row in rows:
        by_run = {r: c[row["name"]] for r, c in zoo["launches"].items() if c[row["name"]]}
        row["launches"] += sum(by_run.values())
        row["launches_by_run"].update(by_run)
        row["launches_per"].update({units[r][0]: n / units[r][1]
                                    for r, n in by_run.items()})
        if "shapes" in row:
            merge_shapes({row["name"]: row["shapes"]},
                         {row["name"]: zoo["shapes"].get(row["name"], {})})


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
    """Where a compressed step's time goes: forward+backward (with each layer
    rematerialised, as the launcher's steps run, and without), then each
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

    def fwd_bwd(cfg=tcfg):
        for p in leaves:
            p.grad = None
        step_lib.loss_fn(state.model, batch, cfg).backward()

    with launch_train.deterministic(), capture_wire_reports():
        # the launcher's steps remat every layer (TrainConfig.remat, the default)
        ms = {"forward+backward without remat": _wall_ms(
            lambda: fwd_bwd(dataclasses.replace(tcfg, remat=False)), torch),
              "forward+backward": _wall_ms(fwd_bwd, torch)}
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


FSDP_MICRO = 2  # microbatches of the fsdp phase's steps
FSDP_STEPS = 2  # steps of each twin of the fsdp phase (3 before the dryrun phase's cuts)


def fsdp_work(state, tcfg) -> tuple:
    """``(all-gathers, reduce-scatters, {signature: all-gathers}, {signature:
    a shard})`` of one FSDP step, from the state's sharded dims: a forward
    gathers each sharded top-level leaf once and each sharded block leaf
    once a layer, the rematerialised layers gather their leaves again in
    the backward, each forward gather's backward is one reduce-scatter, and
    all of it happens once a microbatch.  A signature is the gathered
    shard's shape with its sharded dim moved last (the ``fsdp_gather`` plan
    key's shape)."""
    from repro_torch.models import transformer

    repeats = state.model.cfg.repeats
    per_sig, shards, rs = {}, {}, 0
    for path, d in transformer.tree_paths(state.fsdp_dims):
        if d < 0:
            continue
        leaf = state.model.params[path].detach()
        block = path.startswith("blocks/")
        shard = leaf[0].movedim(d - 1, -1) if block else leaf.movedim(d, -1)
        n_fwd = repeats if block else 1
        sig = tuple(shard.shape)
        per_sig[sig] = per_sig.get(sig, 0) + tcfg.microbatches * n_fwd * (
            2 if block and tcfg.remat else 1)
        shards.setdefault(sig, shard)
        rs += tcfg.microbatches * n_fwd
    return sum(per_sig.values()), rs, per_sig, shards


def fsdp_launches(n_ag: int, n_rs: int, n_dev: int) -> dict:
    """Kernel launches of ``n_ag`` compressed FSDP all-gathers and ``n_rs``
    reduce-scatters over n_dev ranks: an all-gather encodes its shard once
    (encode_fused) and decodes the gathered payload and lo planes (unpack
    twice); a reduce-scatter encodes its n_dev rows once, and its fused
    receive runs decode_reduce and an exception-patch unpack a chunk."""
    return {"encode_fused": n_ag + n_rs, "decode_reduce": n_rs * n_dev,
            "unpack": 2 * n_ag + n_rs * n_dev}


def phase_fsdp(main, dev, torch):
    """Compressed FSDP training of smollm_135m at full width on a one-rank
    NCCL group (``partition="fsdp"``, 2 microbatches, remat), batch 8 x seq
    512: FSDP_STEPS compressed steps, then as many of the raw twin from the
    same weights,
    through the launcher's StepRunner.  Losses and the final train state
    (shards and optimizer moments) must be identical, the launches and the
    plan caches' misses (one a signature) and hits those of
    :func:`fsdp_work`; the all-gather decodes' share of a step is timed at
    each signature (unpack x 2 and the plain zero-escape merge)."""
    from repro_torch import kernels
    from repro_torch.core import compressed_collectives as cc
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.tree_util import bits_equal

    runs, t0 = {}, time.perf_counter()
    with launch_train.single_process_group(dev) as group:
        mesh = mesh_lib.make_mesh((1, 1, 1), ("pod", "data", "model"), device=dev)
        n_dp = torch.distributed.get_world_size(group)
        for compress in (True, False):
            with recorded_inputs(torch) as inputs:
                kernels.clear_launch_counts()
                runs[compress] = launch_train.train(
                    ARCH, steps=FSDP_STEPS, batch=BATCH, seq=SEQ, compress=compress,
                    device=dev, seed=SEED, mesh=mesh, partition="fsdp",
                    microbatches=FSDP_MICRO)
                runs[compress].launches = kernels.launch_counts()
            runs[compress].recorded = (inputs, shape_tallies())
        comp, raw = runs[True], runs[False]
        if comp.losses != raw.losses or any(s != s or abs(s) == float("inf")
                                            for s in comp.losses):
            raise AssertionError(f"fsdp loss curves {comp.losses} vs {raw.losses}")
        if not bits_equal(comp.state.tree(), raw.state.tree()):
            raise AssertionError("fsdp final train states differ between the twins")
        n_ag, n_rs, per_sig, shards = fsdp_work(comp.state, comp.tcfg)
        expect = dict.fromkeys(kernels.KERNELS, 0)
        expect.update({k: FSDP_STEPS * v for k, v in fsdp_launches(n_ag, n_rs, n_dp).items()})
        if comp.launches != expect or any(raw.launches.values()):
            raise AssertionError(f"fsdp launch counts {comp.launches} (raw twin "
                                 f"{raw.launches}), expected {expect}")
        want = (len(per_sig), FSDP_STEPS * n_ag - len(per_sig))
        for run in (comp, raw):
            st = run.plan_cache.stats
            if (st.misses, st.hits) != want or run.retries:
                raise AssertionError(f"fsdp plan cache {run.plan_cache.cache_info()}, "
                                     f"expected (misses, hits) {want}, retries {run.retries}")
        names = [r.name for r in comp.wire_reports]
        if names.count("all_gather") != FSDP_STEPS * n_ag \
                or names.count("reduce_scatter") != FSDP_STEPS * n_rs or raw.wire_reports:
            raise AssertionError(f"fsdp wire reports: {len(names)}")
        ratio = {n: sum(r.wire_bytes for r in comp.wire_reports if r.name == n)
                 / sum(r.raw_bytes for r in comp.wire_reports if r.name == n)
                 for n in ("all_gather", "reduce_scatter")}
        # the all-gather decodes of one step: each signature's wire (of a
        # trained shard) decoded, median of 5, times its all-gathers a step
        pol = comp.tcfg.policy
        w_ag, block = pol.width_for("weight"), pol.profile.block
        decode_ms = 0.0
        for sig, shard in shards.items():
            x = cc._pad_flat(shard.reshape(-1), block)
            wire = cc._encode_chunks(x[None], width=w_ag, block=block,
                                     exc_frac=pol.profile.exc_frac)
            decode_ms += per_sig[sig] * _wall_ms(lambda: cc._decode_chunks(
                wire, dtype=x.dtype, n=x.shape[0], width=w_ag, block=block), torch)
    step_ms = sorted(comp.step_ms[1:])[len(comp.step_ms[1:]) // 2]
    print(f"fsdp: {ARCH} full width, FSDP n_dp={n_dp}, batch {BATCH} x seq {SEQ}, "
          f"{FSDP_MICRO} microbatches, remat {comp.tcfg.remat}; a step: {n_ag} all-gathers, "
          f"{n_rs} reduce-scatters; {len(per_sig)} gather signatures {per_sig}")
    print(f"  compressed losses {comp.losses} step_ms {[round(t, 1) for t in comp.step_ms]}")
    print(f"  raw twin   losses {raw.losses} step_ms {[round(t, 1) for t in raw.step_ms]}")
    print(f"  ZeRO-1 (main phase) step_ms {[round(t, 1) for t in main.step_ms]}")
    print(f"  fsdp_gather plan cache (misses, hits): compressed "
          f"{(comp.plan_cache.stats.misses, comp.plan_cache.stats.hits)}, raw twin "
          f"{(raw.plan_cache.stats.misses, raw.plan_cache.stats.hits)}")
    print(f"  wire ratio AG {ratio['all_gather']:.4f} RS {ratio['reduce_scatter']:.4f}; "
          f"launches {comp.launches}; AG decodes {decode_ms:.1f} ms a step = "
          f"{decode_ms / step_ms:.3f} of the compressed step ({step_ms:.1f} ms); losses "
          f"and final train states identical; the phase {time.perf_counter() - t0:.1f} s; "
          f"card {run_card()}")
    return {"launches": comp.launches, "recorded": comp.recorded, "step_ms": comp.step_ms,
            "raw_step_ms": raw.step_ms, "ratio": ratio, "decode_ms": decode_ms}


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


def phase_sync_strategies(sync, dev, torch):
    """The sync phase's last two versions through a WeightSyncEngine under
    each of SYNC_STRATEGIES (the sync run's policy, a fresh PlanCache): a
    full update of the older, an ack, then a delta of the newer, each
    applied on the card bit-identical.  The plan records the engine's
    strategy (``CommPlan.strategy``, its key); the updates' bytes and
    checksums are identical under both.  Launches an engine: encode_fused 1
    (the full encode), pack 2 (the delta), unpack 4 (the two applies)."""
    from repro_torch import kernels
    from repro_torch.core.integrity import tree_chunks
    from repro_torch.sched.cache import PlanCache
    from repro_torch.sync import WeightSyncEngine, apply_update
    from repro_torch.tree_util import bits_equal

    old, new = sync["versions"]
    seen, launches, recorded = {}, {}, {}
    for strategy in SYNC_STRATEGIES:
        eng = WeightSyncEngine(policy=sync["policy"], strategy=strategy,
                               plan_cache=PlanCache())
        with recorded_inputs(torch) as inputs:
            kernels.clear_launch_counts()
            v = eng.publish(old)
            full = eng.update_for("r")
            held = apply_update(full, device=dev)
            eng.ack("r", v, full.epoch)
            eng.publish(new)
            delta = eng.update_for("r")
            got = apply_update(delta, base_params=held, device=dev)
            torch.cuda.synchronize()
            launches[strategy] = kernels.launch_counts()
        recorded[strategy] = (inputs, shape_tallies())
        plan = eng.plan_for(new)
        if (full.mode, delta.mode) != ("full", "delta") or not bits_equal(held, old) \
                or not bits_equal(got, new):
            raise AssertionError(f"{strategy}: modes {full.mode}, {delta.mode}, "
                                 f"exact {bits_equal(held, old)}, {bits_equal(got, new)}")
        if plan.strategy != strategy or plan.key[2] != strategy:
            raise AssertionError(f"{strategy}: plan strategy {plan.strategy}, key {plan.key[:3]}")
        seen[strategy] = [(u.checksum, u.wire_bytes, [
            (b[:3], list(tree_chunks(b[3]))) for b in u.buckets]) for u in (full, delta)]
    first = seen[SYNC_STRATEGIES[0]]
    if any(seen[s] != first for s in SYNC_STRATEGIES):
        raise AssertionError("the host wire differs between strategies")
    expect = dict.fromkeys(kernels.KERNELS, 0)
    expect.update(encode_fused=1, pack=2, unpack=4)
    if any(c != expect for c in launches.values()):
        raise AssertionError(f"sync strategy launches {launches}, expected {expect} each")
    print(f"sync_strategies: engines under {', '.join(SYNC_STRATEGIES)}: full v{v} "
          f"({first[0][1]} B) and delta ({first[1][1]} B) updates with identical bytes and "
          f"checksums, applied bit-identical on the card; each plan records its strategy; "
          f"launches {launches[SYNC_STRATEGIES[0]]} an engine")
    return {"launches": {k: sum(c[k] for c in launches.values()) for k in expect},
            "recorded": _merged_recorded(recorded.values())}


def _merged_recorded(parts) -> tuple:
    """One ``(inputs, tallies)`` of several recorded windows: the first input
    of each shape, the tallies summed."""
    inputs = {name: {} for name in SHAPED}
    tallies = {name: {} for name in SHAPED}
    for ins, tal in parts:
        for name in SHAPED:
            for shape, args in ins[name].items():
                inputs[name].setdefault(shape, args)
            for shape, n in tal[name].items():
                tallies[name][shape] = tallies[name].get(shape, 0) + n
    return inputs, tallies


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
    return {"launches": launches, "recorded": recorded, "cost": cost,
            "dump": obs_dump_run(dev, torch)}


OBS_DUMP_FILES = ("trace_train_sync.json", "metrics_train_sync.json", "metrics_train_sync.md",
                  "report_train_sync.json", "report_train_sync.md")


def obs_dump_run(dev, torch) -> dict:
    """``obs.dump.run`` on the card, the twin of the reference's
    ``benchmarks/run.py`` key ``obs`` (3 smoke train steps, then 3 weight-sync
    publishes), with ``REPRO_TRACE_DIR`` at a temporary directory: its three
    lines name the files, the five files are there, the Chrome trace holds
    ``train:step``, ``plan:*`` and ``sync:*`` spans, the metrics and the
    report parse, and the compressed steps launched the kernels.  Prints one
    ``obs_dump:`` line; returns the run's launches and recorded inputs."""
    import collections
    import io
    import tempfile

    from repro_torch import kernels
    from repro_torch.obs import dump

    before = os.environ.get("REPRO_TRACE_DIR")
    with tempfile.TemporaryDirectory(prefix="obs_dump_") as out:
        os.environ["REPRO_TRACE_DIR"] = out
        try:
            with recorded_inputs(torch) as inputs, \
                    contextlib.redirect_stdout(io.StringIO()) as said:
                kernels.clear_launch_counts()
                t0 = time.perf_counter()
                dump.run(device=dev)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                launches = kernels.launch_counts()
        finally:
            if before is None:
                os.environ.pop("REPRO_TRACE_DIR")
            else:
                os.environ["REPRO_TRACE_DIR"] = before
        recorded = (inputs, shape_tallies())
        lines = said.getvalue().splitlines()
        want = [f"obs dump: {k} -> {os.path.join(out, f)}" for k, f in
                (("trace", OBS_DUMP_FILES[0]), ("metrics", OBS_DUMP_FILES[1]),
                 ("report", OBS_DUMP_FILES[4]))]
        if lines != want or sorted(os.listdir(out)) != sorted(OBS_DUMP_FILES):
            raise AssertionError(f"obs dump printed {lines} and wrote {os.listdir(out)}")
        with open(os.path.join(out, OBS_DUMP_FILES[0])) as f:
            spans = collections.Counter(e["name"] for e in json.load(f)["traceEvents"])
        with open(os.path.join(out, OBS_DUMP_FILES[1])) as f:
            counters = json.load(f)["counters"]
        with open(os.path.join(out, OBS_DUMP_FILES[3])) as f:
            report = json.load(f)
        if (spans["train:step"] != 3 or not any(k.startswith("plan:") for k in spans)
                or not any(k.startswith("sync:") for k in spans)
                or counters["plan_exec_total"] != {"kind=zero1": 3}
                or counters["sync_publish_total"] != {"": 3}
                or not launches["encode_fused"] or not launches["decode_reduce"]):
            raise AssertionError(f"obs dump: spans {dict(spans)}, plan_exec_total "
                                 f"{counters['plan_exec_total']}, launches {launches}")
        sizes = {f: os.path.getsize(os.path.join(out, f)) for f in OBS_DUMP_FILES}
    for text in lines:
        print(text)
    print(f"obs_dump: dump.run on {dev} in {run_s:.2f} s: {len(spans)} span names "
          f"({sum(spans.values())} spans), {len(report['ratio_series'])} ratio series, files "
          f"{sizes}; launches {launches}")
    return {"launches": launches, "recorded": recorded, "seconds": run_s}


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


def time_path_shapes(recorded, runs, bw, dev, torch) -> dict:
    """encode_fused, decode_reduce, pack and unpack at each shape the runs
    of ``recorded`` (``{run: (inputs, tallies)}`` of ``recorded_inputs`` and
    ``shape_tallies``) launched them at: each held against its plain
    version on the first run's input of the shape, then timed once a shape
    with its bound.  Every launch a run tallied (``runs[run][kernel]``
    launches) must be at a recorded shape.  Returns ``{kernel: {shape key:
    entry}}``."""
    from repro_torch.core import codec
    from repro_torch.kernels import bitpack, ref
    from repro_torch.kernels import decode_reduce as dr
    from repro_torch.kernels import encode_fused as ef

    def same(name, got, want):
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version at the path's shape")

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
                args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                             for a in inputs[name][shape])
                call = held(name, kernel, plain, args)
                by_shape.setdefault(shape, (args, call, {}))[2][r] = count
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
    return path_shapes


# Peak rates for the bound: f32 outside the tensor cores; the integer
# operations of the rANS kernels are counted at the same rate, which the
# card's int32 rate does not exceed, so the bound stays a lower bound.
PEAK_OPS = 67e12


def path_run(launches, recorded, unit, n) -> dict:
    """One main-path run as ``phase_times`` reads it: the launches counted in
    it (the counts set to 0 just before it), its recorded kernel inputs, and
    the unit its launches are counted per, ``n`` of them in the run."""
    return {"launches": launches, "recorded": recorded, "unit": (unit, n)}


def phase_times(runs, comp, serve, dev, torch, np, worst, bw):
    """Each kernel and its plain version at the shapes its path gives it:
    encode_fused, decode_reduce and plane_split at the main path's AG
    bucket; pack and unpack at one KV leaf's exponent residuals at the plan's
    width; encode_fused, decode_reduce, pack and unpack also at every shape
    the runs launched them at, on the runs' recorded inputs; rANS encode
    and the compacted-stream decode at one KV leaf's exponent plane.  Each
    kernel is checked against its plain version on these inputs first.
    ``runs``: every main-path run, ``{run: path_run(...)}``."""
    from repro_torch import kernels
    from repro_torch.core import ans, codec, packing
    from repro_torch.core.calibrate import CompressionProfile
    from repro_torch.kernels import bitpack, rans, ref
    from repro_torch.kernels import decode_reduce as dr
    from repro_torch.kernels import encode_fused as ef
    from repro_torch.kernels import plane_split as ps
    from repro_torch.optim import zero1

    per_unit = {r: m["unit"] for r, m in runs.items()}
    recorded = {r: m["recorded"] for r, m in runs.items()}
    runs = {r: m["launches"] for r, m in runs.items()}
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
    # launched them at (the zoo phase times its own shapes, which merge_zoo
    # adds to these rows)
    path_shapes = time_path_shapes(recorded, runs, bw, dev, torch)

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


def roofline_alone() -> None:
    """The roofline phase alone on the card, on a run of its own: the kernels
    built, STEPS compressed ZeRO-1 steps of smollm-135m through the launcher
    (as the main phase's), then ``phase_roofline``.

        python3 -c "import chip_smoke; chip_smoke.roofline_alone()"
    """
    import torch

    from repro_torch import kernels
    from repro_torch.launch import train as launch_train

    dev = kernels.resolve_device("cuda")
    phase_build(kernels, torch)
    with launch_train.single_process_group(dev) as group:
        run = launch_train.train(ARCH, steps=STEPS, batch=BATCH, seq=SEQ, device=dev,
                                 seed=SEED, group=group)
        phase_roofline(run, group, dev, torch)


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
    with dryrun_cell() as cell:
        return run_phases(smi, cell, dev, name, torch, np)


def run_phases(smi, cell, dev, name, torch, np) -> int:
    """Every phase after the build (:func:`main`)."""
    worst = phase_check(dev, torch, np)
    phase_check_wire(dev, torch, np)
    serve = phase_serve(dev, torch, np)
    sampled = phase_serve_sampled(dev, torch, np)
    comp, psum, file_twins, roofline = phase_main(dev, torch)
    phase_dryrun(roofline, cell, dev, torch)
    fsdp = phase_fsdp(comp, dev, torch)
    sync = phase_sync(dev, torch)
    strategies = phase_sync_strategies(sync, dev, torch)
    fleet = phase_fleet(sync, dev, torch)
    p2p = phase_p2p(serve, psum, sync, dev, torch)
    obs_run = phase_obs(comp, psum, sync, dev, torch, np)
    bw = card_bandwidth(name)
    runs = {
        "serve_pd": path_run(serve["pd_launches"], serve["recorded"]["serve_pd"],
                             "pd_admission", N_REQ),
        "serve_pd_rans": path_run(serve["rans_launches"], serve["recorded"]["serve_pd_rans"],
                                  "pd_rans_admission", N_RANS),
        "serve_pd_sampled": path_run(sampled["launches"], sampled["recorded"],
                                     "pd_sampled_admission", N_REQ),
        "train": path_run(comp.launches, comp.recorded, "train_step", STEPS),
        "train_file": path_run(file_twins["launches"], file_twins["recorded"],
                               "train_file_step", FILE_STEPS),
        "roofline": path_run(roofline["launches"], roofline["recorded"],
                             "roofline_step", ROOFLINE_STEPS),
        "fsdp": path_run(fsdp["launches"], fsdp["recorded"], "fsdp_step", FSDP_STEPS),
        "psum": path_run(psum["launches"], psum["recorded"], "psum_phase", 1),
        "weight_sync": path_run(sync["launches"], sync["recorded"], "publish",
                                sync["n_publishes"]),
        "sync_strategies": path_run(strategies["launches"], strategies["recorded"],
                                    "strategy_engine", len(SYNC_STRATEGIES)),
        "p2p": path_run(p2p["launches"], p2p["recorded"], "p2p_phase", 1),
        "fleet": path_run(fleet["launches"], fleet["recorded"], "fleet_phase", 1),
        "obs": path_run(obs_run["launches"], obs_run["recorded"], "obs_phase", 1),
        "obs_dump": path_run(obs_run["dump"]["launches"], obs_run["dump"]["recorded"],
                             "obs_dump_run", 1)}
    rows = phase_times(runs, comp, serve, dev, torch, np, worst, bw)
    # the zoo's models take the card alone: only the rows stay
    del comp, fsdp, serve, sync, psum, p2p, fleet, obs_run, sampled, file_twins, roofline, \
        strategies, runs
    merge_zoo(rows, phase_zoo(dev, torch, np, bw))
    merge_zoo(rows, phase_tp(dev, torch, np, bw))
    print(f"card: {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
