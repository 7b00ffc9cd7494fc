"""First-step loss and grad norm of a model split over 'model' against the
same model on one rank, on the CPU, in bf16 and in f32.

    PYTHONPATH=src python tools/tp_gap.py [--arch xlstm_350m] [--repeats 1] \\
        [--vocab 2048] [--batch 4] [--seq 64] [--ranks 2]

The arch's full width (its depth cut to ``--repeats`` pattern repeats,
its vocabulary to ``--vocab`` rows), weights from a CPU generator seeded
0, one batch of the data pipeline (seed 0): one forward and backward on
one rank, then on ``--ranks`` gloo ranks of a (1, ranks) mesh, each
holding its blocks.  The norm counts each leaf once (a split leaf's
squares summed over the ranks).  Prints, per dtype, both losses and norms
and their relative gaps: a gap that vanishes in f32 is the bf16
rounding of the layouts, not the split.
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

    return dataclasses.replace(configs.get(args.arch), repeats=args.repeats,
                               vocab=args.vocab, dtype=dtype)


def loss_and_squares(model, cfg, args, n_model: int) -> tuple:
    """(loss, {split over 'model': sum of squares, else: sum})."""
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.models import transformer
    from repro_torch.train import step as step_lib

    batch = DataPipeline(DataConfig(vocab=cfg.vocab, global_batch=args.batch,
                                    seq_len=args.seq, seed=0)).tensors_at(0, "cpu")
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

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        cfg = config(args, dtype)
        mesh = mesh_lib.make_mesh((1, world), ("data", "model"), device="cpu")
        model = transformer.init(cfg, generator=torch.Generator().manual_seed(0),
                                 device="cpu", mesh=mesh)
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
    args = ap.parse_args()
    ctx = multiprocessing.get_context("spawn")
    for dtype in ("bfloat16", "float32"):
        cfg = config(args, dtype)
        model = transformer.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        loss1, sq = loss_and_squares(model, cfg, args, 1)
        norm1 = (sq[True] + sq[False]) ** 0.5
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
        loss_n, norm_n = float(res["loss"]), float(res["sq"]) ** 0.5
        print(f"{args.arch} {dtype}: loss {loss1!r} at model = 1, {loss_n!r} at model = "
              f"{args.ranks} (gap {abs(loss_n - loss1) / abs(loss1):.3e}); grad norm "
              f"{norm1!r} / {norm_n!r} (gap {abs(norm_n - norm1) / norm1:.3e})", flush=True)


if __name__ == "__main__":
    main()
