#!/usr/bin/env python3
"""Settle time of each weight-sync fleet topology in two run orders, on one
CUDA card: does a topology's place in the run move its time?

    python3 tools/fleet_order.py [--smoke --device cpu]

Random smollm-135m weights from seed 0 and three successors with up to
three low bits flipped in 30% of the values (warm XOR deltas), published
to 6 replicas on the device, as ``chip_smoke.py``'s fleet phase does; each
wave is one publish and ``settle()``, timed on the host clock up to a
device sync.  The topologies run as pipeline, tree, star, then star, tree,
pipeline, then star twice; each topology gets a fresh engine and plan
cache.  Prints one line a fleet and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

ORDERS = ((("pipeline", 1), ("tree", 2), ("star", 2)),
          (("star", 2), ("tree", 2), ("pipeline", 1)),
          (("star", 2), ("star", 2)))


def versions(cfg, dev, torch, n=4):
    from repro_torch.models import transformer
    from repro_torch.tree_util import tree_flatten, tree_unflatten

    first = transformer.init(cfg, generator=torch.Generator().manual_seed(0), device=dev).tree()
    out = [first]
    g = torch.Generator(dev).manual_seed(1)
    for _ in range(n - 1):
        leaves, treedef = tree_flatten(out[-1])
        nxt = []
        for t in leaves:
            bits = t.view(torch.int16)
            mask = torch.randint(0, 8, bits.shape, generator=g, device=dev, dtype=torch.int16)
            mask[torch.rand(bits.shape, generator=g, device=dev) > 0.3] = 0
            nxt.append((bits ^ mask).view(t.dtype))
        out.append(tree_unflatten(treedef, nxt))
    return out


def main(argv=None) -> int:
    import torch

    from repro_torch import configs, kernels
    from repro_torch.core.calibrate import CompressionProfile
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.sched.cache import PlanCache
    from repro_torch.sync import FleetConfig, SyncFleet, WeightSyncEngine

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = kernels.resolve_device(args.device)
    cfg = (configs.get_smoke if args.smoke else configs.get)("smollm_135m")
    vs = versions(cfg, dev, torch)
    prof = CompressionProfile(widths={"gradient": 5, "weight": 5, "activation": 5,
                                      "delta": 5, "delta_lo": 6})
    pol = CompressionPolicy(min_bytes=0, profile=prof)
    names = tuple(f"r{i}" for i in range(6))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    for order in ORDERS:
        for kind, fanout in order:
            fleet = SyncFleet(WeightSyncEngine(policy=pol, plan_cache=PlanCache()), names,
                              device=dev, cfg=FleetConfig(broadcast=kind, fanout=fanout,
                                                          ckpt_every_publishes=10 ** 9))
            ms = []
            for p in vs:
                fleet.publish(p)
                t0 = time.perf_counter()
                fleet.settle()
                sync()
                ms.append(round((time.perf_counter() - t0) * 1e3, 1))
            if not fleet.verify_bitexact():
                raise AssertionError(f"{kind}: a replica differs from the published weights")
            print(f"order {[k for k, _ in order]}: {kind} settle ms {ms}", flush=True)
            del fleet
    if dev.type == "cuda":
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
