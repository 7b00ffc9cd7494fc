"""First-step loss and grad norm (or, with ``--serve``, the serving
logits) of a model split over 'model' against the same model on one
rank, in bf16 and in f32.

    PYTHONPATH=src python tools/tp_gap.py [--arch xlstm_350m] [--repeats 1] \\
        [--pattern 3,4] [--vocab 2048] [--batch 4] [--seq 64] [--ranks 2] \\
        [--device cpu] [--serve --max-len 256 --steps 4]

The arch's full width (its depth cut to ``--repeats`` pattern repeats and,
with ``--pattern``, to the pattern positions it lists; its vocabulary to
``--vocab`` rows, 0 for the whole), weights from a generator seeded 0 on
``--device`` (``cuda``: every process on cuda:0, the ranks joined over
gloo), one batch of the data pipeline (seed 0): one forward and backward
on one rank, then on ``--ranks`` gloo ranks of a (1, ranks) mesh, each
holding its blocks.  The norm counts each leaf once (a split leaf's
squares summed over the ranks).  Prints, per dtype, both losses and norms
and their relative gaps: a gap that vanishes in f32 is the bf16
rounding of the layouts, not the split.

``--serve``: a prefill of each of the batch's rows (``--batch`` x
``--seq``, one row at a time, as the serving engine admits requests)
into its slot of a cache of ``--max-len`` positions, then ``--steps``
decode steps of the batch fed seeded tokens, on one rank and on the ranks (each its block of the
cache); prints the largest logit difference over the largest logit
magnitude (prefill and steps together) and the share of equal greedy
picks.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))


def config(args, dtype):
    from repro_torch import configs

    cfg = configs.get(args.arch)
    if args.pattern:
        cfg = dataclasses.replace(cfg, pattern=tuple(cfg.pattern[int(i)]
                                                     for i in args.pattern.split(",")))
    return dataclasses.replace(cfg, repeats=args.repeats, vocab=args.vocab or cfg.vocab,
                               dtype=dtype)


def device(args):
    return torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")


def serve_logits(model, cfg, args, mesh=None) -> np.ndarray:
    """The logits of a prefill of each row on its own (as ``ServeEngine``
    admits a request) into its slot of a batched cache, then
    ``args.steps`` decode steps of the whole batch (f32 numpy, (batch, 1 +
    steps, vocab))."""
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine

    dev = device(args)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (args.batch, args.seq))).to(dev)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab, (args.steps, args.batch, 1))).to(dev)
    cache = transformer.init_cache(cfg, args.batch, args.max_len, dev, mesh=mesh)
    out = []
    for i in range(args.batch):
        logits, one = transformer.prefill(model, tokens[i:i + 1], transformer.init_cache(
            cfg, 1, args.max_len, dev, mesh=mesh))
        ServeEngine._splice_impl(cache, one, i)
        out.append(logits.float().cpu())
    out = [torch.cat(out)]
    cache["pos"] = one["pos"]
    for t in feed:
        logits, cache = transformer.decode_step(model, t, cache)
        out.append(logits.float().cpu())
    return torch.cat(out, 1).numpy()


def loss_and_squares(model, cfg, args, n_model: int) -> tuple:
    """(loss, {split over 'model': sum of squares, else: sum})."""
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.models import transformer
    from repro_torch.train import step as step_lib

    batch = DataPipeline(DataConfig(vocab=cfg.vocab, global_batch=args.batch,
                                    seq_len=args.seq, seed=0)).tensors_at(0, device(args))
    loss = step_lib.loss_fn(model, batch, step_lib.TrainConfig(loss_chunk=args.seq,
                                                               remat=False))
    loss.backward()
    kept = transformer.block_specs(cfg, max(n_model, 2))
    sq = {True: 0.0, False: 0.0}
    for path, p in model.params.items():
        if p.grad is not None:
            sq["model" in kept[path] and n_model > 1] += float(torch.sum(p.grad.double() ** 2))
    return loss.detach().item(), sq


def rank_main(rank, world, store, out, args, dtype):
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer

    dev = device(args)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        cfg = config(args, dtype)
        mesh = mesh_lib.make_mesh((1, world), ("data", "model"), device=dev)
        model = transformer.init(cfg, generator=torch.Generator(dev).manual_seed(0),
                                 device=dev, mesh=mesh)
        if args.serve:
            np.savez(out, logits=serve_logits(model, cfg, args, mesh))
            return
        loss, sq = loss_and_squares(model, cfg, args, world)
        split = torch.tensor([sq[True]], dtype=torch.float64)
        dist.all_reduce(split)
        np.savez(out, loss=loss, sq=float(split) + sq[False])
    finally:
        dist.destroy_process_group()


def main() -> None:
    import multiprocessing

    from repro_torch.models import transformer

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm_350m")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--pattern", default="")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    ctx = multiprocessing.get_context("spawn")
    dev = device(args)
    for dtype in ("bfloat16", "float32"):
        cfg = config(args, dtype)
        model = transformer.init(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
        if args.serve:
            want = serve_logits(model, cfg, args)
        else:
            loss1, sq = loss_and_squares(model, cfg, args, 1)
            norm1 = (sq[True] + sq[False]) ** 0.5
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(args.ranks)]
            procs = [ctx.Process(target=rank_main, args=(r, args.ranks, os.path.join(tmp, "s"),
                                                         outs[r], args, dtype))
                     for r in range(args.ranks)]
            for p in procs:
                p.start()
            for p in procs:
                p.join()
            if [p.exitcode for p in procs] != [0] * args.ranks:
                raise SystemExit(f"ranks exited {[p.exitcode for p in procs]}")
            res = np.load(outs[0])
            if args.serve:
                others = [np.load(o)["logits"] for o in outs[1:]]
        if args.serve:
            got = res["logits"]
            same = all(np.array_equal(o, got) for o in others)
            gap = np.abs(got - want).max() / np.abs(want).max()
            picks = (got.argmax(-1) == want.argmax(-1)).mean()
            print(f"{args.arch} {dtype} serve: batch {args.batch} x {args.seq}, "
                  f"{args.steps} decode steps, max_len {args.max_len}: logits gap {gap:.3e} "
                  f"(largest |logit| {np.abs(want).max():.4g}), greedy picks equal "
                  f"{picks:.4f}, ranks' logits identical {same}", flush=True)
            continue
        loss_n, norm_n = float(res["loss"]), float(res["sq"]) ** 0.5
        print(f"{args.arch} {dtype}: loss {loss1!r} at model = 1, {loss_n!r} at model = "
              f"{args.ranks} (gap {abs(loss_n - loss1) / abs(loss1):.3e}); grad norm "
              f"{norm1!r} / {norm_n!r} (gap {abs(norm_n - norm1) / norm1:.3e})", flush=True)


if __name__ == "__main__":
    main()
