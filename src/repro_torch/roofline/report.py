"""Roofline report: a directory of cell JSONs and their profiler traces ->
markdown (torch port of ``repro.roofline.report``).

    PYTHONPATH=src python -m repro_torch.roofline.report --dir DIR [--mesh MESH]

Each cell is ``<name>.json`` (the reference's cell schema: ``arch``,
``shape``, ``mesh``, ``ok``, ``cost``, ``wire``, and optionally ``n_chips``
and ``model_flops``) with ``<name>.trace.json`` beside it, a
``torch.profiler`` Chrome trace of the cell's step.  ``chip_smoke.py``'s
roofline phase writes one.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.roofline.analysis import (MD_HEADER, MD_HEADER_WIRE, analyze_cell,
                                           markdown_row, markdown_row_wire)

TRACE_SUFFIX = ".trace.json"


def collect(dir_: str, mesh: str = "single", compressed_only: bool = True) -> list:
    """The :class:`~repro_torch.roofline.analysis.Roofline` of every ``ok``
    cell of ``mesh`` in ``dir_`` that has its trace (``__raw`` twins left out
    unless ``compressed_only`` is False), in file-name order."""
    rows = []
    for jp in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        base = os.path.basename(jp)
        if base.endswith(TRACE_SUFFIX) or (base.endswith("__raw.json") and compressed_only):
            continue
        with open(jp) as f:
            rec = json.load(f)
        if rec.get("mesh") != mesh or not rec.get("ok"):
            continue
        trace = jp[:-len(".json")] + TRACE_SUFFIX
        if not os.path.exists(trace):
            continue
        rows.append(analyze_cell(jp, trace))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--no-wire", action="store_true",
                    help="the three-term table without the measured WireReport columns")
    args = ap.parse_args(argv)
    rows = collect(args.dir, args.mesh)
    shape_order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    rows.sort(key=lambda r: (r.arch, shape_order.get(r.shape, 9)))
    # default view: the trace's collective bytes and the measured wire bytes
    # of the collectives' own WireReports side by side (the same wires)
    print(MD_HEADER if args.no_wire else MD_HEADER_WIRE)
    for r in rows:
        print(markdown_row(r) if args.no_wire else markdown_row_wire(r))
    if args.json_out:
        out = [dict(arch=r.arch, shape=r.shape, mesh=r.mesh,
                    t_compute=r.t_compute, t_memory=r.t_memory,
                    t_collective=r.t_collective, bottleneck=r.bottleneck,
                    useful=r.useful_flops_fraction,
                    roofline_fraction=r.roofline_fraction,
                    flops=r.flops, hbm_bytes=r.hbm_bytes,
                    coll_bytes=r.coll_bytes, model_flops=r.model_flops,
                    wire_bytes=r.wire_bytes, wire_raw_bytes=r.wire_raw_bytes,
                    wire_ratio=r.wire_ratio,
                    decode_hbm_eliminated=r.decode_hbm_eliminated,
                    encode_hbm_eliminated=r.encode_hbm_eliminated)
               for r in rows]
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
