"""The dry run's sweep in parallel processes, and its table.

    PYTHONPATH=src python tools/dryrun_sweep.py --out DIR [--workers 4] [--trace]
    PYTHONPATH=src python tools/dryrun_sweep.py --out DIR --table

Runs every live cell of ``launch/cells`` at both production meshes, one
``python -m repro_torch.launch.dryrun --arch A --shape S --mesh M`` process
a cell (CPU only, no device), ``--workers`` at a time, the cheapest kinds
first (decode, then train, then prefill, each by the arch's active
parameters; the recurrent archs' train and prefill cells last); without
``--trace`` the cells write no trace (the profiler costs ~2x the run's
time and ~30 times its memory; the JSON's
collective bytes are the step's own count, which the tests hold equal to
the trace's).  Each cell's JSON and log go to ``DIR/cells``; a line a cell
to ``DIR/started.jsonl`` when it starts and ``DIR/results.jsonl`` when it
ends.  ``--table`` prints the markdown table of ``DIR``, a row a cell and
each field ``single / multi``: ok, build and run seconds, arguments and
temp GiB a device, whether they fit an 80 GiB card, FLOPs a rank, the
wire ratio and the collective GB (1e9 bytes); a cell that started and
has no JSON is listed with its elapsed seconds.
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.launch import cells  # noqa: E402

MESHES = ("single", "multi")
KIND = {"decode": 0, "train": 1, "prefill": 2}
RECURRENT = ("jamba_v0_1_52b", "xlstm_350m")
HBM = 80 << 30


def cell_list() -> list:
    """``(arch, shape, mesh)`` of every live cell, the cheapest first: by
    kind, then by the arch's active parameters."""
    out = [(c.arch, c.shape.name, m) for c in cells.live_cells() for m in MESHES]

    def cost(job):
        arch, shape, _ = job
        kind = KIND[cells.SHAPES[shape].kind]
        return (kind + 2 * (arch in RECURRENT and kind > 0),
                configs.get(arch).active_param_count(), job)

    return sorted(out, key=cost)


def sweep(out: str, workers: int, trace: bool) -> None:
    os.makedirs(os.path.join(out, "cells"), exist_ok=True)
    todo, lock = cell_list(), threading.Lock()

    def log(name, rec):
        with lock, open(os.path.join(out, name), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def worker():
        while True:
            with lock:
                if not todo:
                    return
                arch, shape, mesh = todo.pop(0)
            log("started.jsonl", {"job": [arch, shape, mesh], "t": time.time()})
            t0 = time.time()
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                   shape, "--mesh", mesh, "--out-dir", os.path.join(out, "cells")]
            with open(os.path.join(out, "cells", f"{arch}__{shape}__{mesh}.log"), "w") as f:
                rc = subprocess.call(cmd + ([] if trace else ["--no-trace"]), stdout=f,
                                     stderr=subprocess.STDOUT, cwd=ROOT,
                                     env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
            log("results.jsonl", {"arch": arch, "shape": shape, "mesh": mesh, "rc": rc,
                                  "elapsed": time.time() - t0})

    threads = [threading.Thread(target=worker) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _mesh_entry(out: str, started: dict, arch: str, shape: str, mesh: str) -> dict:
    """One cell at one mesh as the table's fields (strings)."""
    jp = os.path.join(out, "cells", f"{arch}__{shape}__{mesh}.json")
    if not os.path.exists(jp):
        t = started.get((arch, shape, mesh))
        ok = "not started" if t is None else f"no: running {time.time() - t:.0f} s"
        return {"ok": ok}
    with open(jp) as f:
        r = json.load(f)
    mem = r["memory"]
    arg, tmp = mem["argument_size_bytes"], mem["temp_size_bytes"]
    return {"ok": "yes" if r["ok"] else "no", "s": f"{r['build_s']}, {r['run_s']}",
            "gib": f"{arg / 2**30:.3f}, {tmp / 2**30:.3f}",
            "fits": "yes" if arg + tmp <= HBM else "no", "flops": f"{r['cost']['flops']:.4e}",
            "wire": f"{r['wire']['ratio']:.4f}",
            "coll": f"{sum(r['collectives']['bytes'].values()) / 1e9:.3f}"}


def table(out: str) -> None:
    """Print the sweep's table: a row a cell, each field ``single /
    multi``."""
    started = {}
    path = os.path.join(out, "started.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                started[tuple(rec["job"])] = rec["t"]
    cols = ("ok", "s", "gib", "fits", "flops", "wire", "coll")
    print("| cell | ok | build, run s | args, temp GiB a device | fits 80 GiB | FLOPs a rank "
          "| wire ratio | collective GB |")
    print("|---|---|---|---|---|---|---|---|")
    for arch, shape, mesh in cell_list():
        if mesh != MESHES[0]:
            continue
        ent = [_mesh_entry(out, started, arch, shape, m) for m in MESHES]
        print(f"| {arch}:{shape} | " + " | ".join(
            " / ".join(e.get(c, "-") for e in ent) for c in cols) + " |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--table", action="store_true")
    args = ap.parse_args(argv)
    if args.table:
        table(args.out)
    else:
        sweep(args.out, args.workers, args.trace)


if __name__ == "__main__":
    main()
