"""CPU rehearsal of ``chip_smoke.py``'s tp phase at SMOKE size.

    PYTHONPATH=src python tools/rehearse_tp.py [JOB[,JOB...]]

Runs ``chip_smoke.phase_tp`` on the CPU: each job's ranks are spawned
processes over gloo on ``device="cpu"``, every config is its arch's SMOKE
config (``configs.get`` is swapped for ``get_smoke``; ``tp_jamba_fsdp``'s
pattern positions become SMOKE's (Mamba, MoE) then (attention, SwiGLU)),
FSDP shards every leaf (``fsdp_min_bytes = 0``), and each kernel wrapper's
plain version counts a launch under the wrapper's shape key, so the
phase's launch checks and its hold of the recorded inputs run as on the
card.  CUDA events and the card's memory calls are faked; no number it
prints is a device number.  It prints the phase's lines, among them each
job's first loss and grad norm against the same model at model = 1, the
gaps the phase's ``loss_rel`` and ``gnorm_rel`` bounds are set from.
Default jobs: all of ``TP_JOBS``.
"""
import functools
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402

# SMOKE's positions of each job's pattern cut, where the full config's differ
SMOKE_PATTERN = {"tp_jamba_fsdp": (1, 2), "tp_serve_jamba": (1, 2)}


def patch(torch) -> None:
    """SMOKE configs, FSDP shards at any size, and a launch counted (with
    the wrapper's shape key) where a wrapper takes its plain version; the
    card's memory calls as no-ops.  In every process: spawned ranks do
    not see the parent's patches."""
    from repro_torch import configs, kernels
    from repro_torch.kernels import bitpack, decode_reduce, encode_fused
    from repro_torch.train import step as step_lib

    configs.get = configs.get_smoke
    step_lib.TrainConfig = functools.partial(step_lib.TrainConfig, fsdp_min_bytes=0)
    keys = {
        (encode_fused, "plain", "encode_fused"):
            lambda x, width, block: (x.dtype, x.shape[0], block, width),
        (decode_reduce, "plain", "decode_reduce"):
            lambda pay, lo, gb, acc, name, width: (name, pay.shape[0], width),
        (bitpack, "plain_pack", "pack"):
            lambda vals, width: (vals.dtype, vals.shape[0] // 32, width),
        (bitpack, "plain_unpack", "unpack"): lambda packed, width: (packed.shape[0], width),
    }
    for (mod, attr, kernel), key in keys.items():
        def counted(*args, _fn=getattr(mod, attr), _kernel=kernel, _key=key):
            out = _fn(*args)
            kernels.count_launch(_kernel, _key(*args))
            return out
        setattr(mod, attr, counted)
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.empty_cache = lambda *a, **k: None


def child(rank, world, store, out, job):
    import torch

    patch(torch)
    cs.tp_child(rank, world, store, out, job)


def run_job(job, torch) -> list:
    """``chip_smoke.run_tp_job`` with the patched child."""
    import multiprocessing
    import tempfile

    world = int(job["shape"][0] * job["shape"][1])
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tp_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=child,
                             args=(r, world, os.path.join(tmp, "store"), outs[r], job))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(cs.TP_TIMEOUT)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if [p.exitcode for p in procs] != [0] * world:
            raise AssertionError(f"ranks exited {[p.exitcode for p in procs]}")
        return [torch.load(o, weights_only=False) for o in outs]


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self, *_):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3

    def synchronize(self):
        pass


def main() -> None:
    import numpy as np
    import torch

    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(cs.TP_JOBS)
    patch(torch)
    torch.cuda.Event = _Event
    torch.cuda.mem_get_info = lambda *a, **k: (1 << 34, 1 << 35)
    cs.run_card = lambda: "cpu (rehearsal)"
    cs.run_tp_job = run_job
    cs.TIMED_RUNS = 2
    jobs = {}
    for name in names:
        jobs[name] = dict(cs.TP_JOBS[name], device="cpu")
        if name in SMOKE_PATTERN:
            jobs[name]["pattern"] = SMOKE_PATTERN[name]
    cs.TP_JOBS = jobs
    res = cs.phase_tp("cpu", torch, np, 3.35e12)
    print("launches", res["launches"])


if __name__ == "__main__":
    main()
