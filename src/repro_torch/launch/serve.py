"""Serving launcher: slot-based continuous batching (torch port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m \\
        --smoke --requests 16 --max-new 24 [--pd] [--device cpu]

Every decoder-only architecture of ``repro_torch.configs.ARCHS`` serves,
at full size without ``--smoke``; an encoder-decoder one (whisper) is
refused, as the reference's serve launcher refuses it (the engine feeds no frames
and no encoder output).  Random weights from ``--seed``, drawn on the
device; random prompts of ``--prompt-len`` tokens from the same seed;
greedy decoding.  ``--pd`` ships every admitted cache over the compressed
host wire (PD disaggregation).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, kernels
from repro_torch.models import transformer
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pd", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = kernels.resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    if cfg.enc_dec:
        raise SystemExit("enc-dec serving demo not wired in this launcher; "
                         "transformer.prefill(frames=) and decode_step(enc_out=) "
                         "serve whisper")
    model = transformer.init(cfg, generator=torch.Generator(dev).manual_seed(args.seed),
                             device=dev)
    eng = ServeEngine(cfg, model, ServeConfig(
        batch_slots=args.slots, max_len=args.max_len,
        prefill_chunk=args.prompt_len, pd_disaggregated=args.pd))
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        eng.submit(Request(rid=i,
                           prompt=rng.integers(0, cfg.vocab,
                                               args.prompt_len).astype(np.int32),
                           max_new=args.max_new))
    done = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, slots={args.slots}, pd={args.pd}, "
          f"device={dev.type})")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out[:8]}...")


if __name__ == "__main__":
    main()
