"""The port's roofline (``roofline/analysis.py``, ``model.py``, ``report.py``)
and ``launch/cells.py`` held against the JAX reference:

* ``cells``: the same 40 cells and 8 skips (44 with glm4), shapes and knobs;
* ``model_flops_for`` and ``analytic_cost``: equal, to the last bit, for
  every cell on both mesh kinds; the reference's ``analytic_cost`` raises on
  the train cells of smollm-135m and xlstm-350m (their knobs are 4-tuples),
  so there the port is held against the reference given 3-tuple knobs;
* ``Roofline``: the same fields and properties; the times are the
  reference's scaled by the ratio of the constants (the port's are an
  H100's), the fractions and the bottleneck equal;
* ``collective_bytes`` on ``torch.profiler`` traces of known gloo
  collectives at world size 1 (exact bytes by kind), and on the port's
  compressed all-gather and reduce-scatter, whose traced bytes equal their
  WireReports' wire bytes;
* ``analyze_cell`` / ``markdown_row_wire``: the reference's folding test
  re-posed on a trace; ``analyze_cell_v2``; ``report.collect`` and its CLI.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro.launch import cells as jcells
from repro.roofline import analysis as JA
from repro.roofline import model as JM
from repro_torch import configs
from repro_torch.core import compressed_collectives as cc
from repro_torch.core import policy
from repro_torch.launch import cells
from repro_torch.launch.train import single_process_group
from repro_torch.roofline import analysis as A
from repro_torch.roofline import model as M
from repro_torch.roofline import report
from torch_port_util import grad_like_bits, to_torch

ALL = [c for c in cells.all_cells(include_glm=True)]
FOUR_TUPLE_KNOBS = ("smollm_135m", "xlstm_350m")


def _key(c):
    """A cell's fields; of a skip's reason the part before the reference's
    pointer to a design document of its own."""
    return (c.name, c.arch, c.shape.name, c.shape.seq_len, c.shape.global_batch,
            c.shape.kind, c.skip and c.skip.split(" (")[0])


@pytest.mark.parametrize("include_glm", [False, True])
def test_cells_are_the_references(include_glm):
    got, want = cells.all_cells(include_glm), jcells.all_cells(include_glm)
    assert [_key(c) for c in got] == [_key(c) for c in want]
    assert len(got) == (44 if include_glm else 40)
    assert sum(c.skip is not None for c in got) == 8 + include_glm
    assert [c.name for c in cells.live_cells(include_glm)] == [
        c.name for c in jcells.live_cells(include_glm)]
    assert {k: dataclasses.astuple(v) for k, v in cells.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jcells.SHAPES.items()}
    assert cells.LONG_OK == jcells.LONG_OK and cells.TRAIN_KNOBS == jcells.TRAIN_KNOBS


def test_model_flops_match_reference_for_every_cell():
    for c in ALL:
        assert A.model_flops_for(c.arch, c.shape.name) == JA.model_flops_for(
            c.arch, c.shape.name), c.name
        assert A.model_flops_for(c.arch, c.shape) == A.model_flops_for(c.arch, c.shape.name)


def _cost_tuple(ac):
    return (ac.gemm_flops, ac.attn_flops, ac.model_flops, ac.hbm_bytes_per_device,
            ac.notes, ac.total_flops)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_analytic_cost_matches_reference_for_every_cell(mesh, monkeypatch):
    for c in ALL:
        got = M.analytic_cost(c.arch, c.shape.name, mesh)
        if c.shape.kind == "train" and c.arch in FOUR_TUPLE_KNOBS:
            with pytest.raises(ValueError, match="too many values to unpack"):
                JM.analytic_cost(c.arch, c.shape.name, mesh)
            continue
        assert _cost_tuple(got) == _cost_tuple(JM.analytic_cost(c.arch, c.shape.name, mesh)), \
            c.name
        n_chips = 512 if mesh == "multi" else 256
        assert _cost_tuple(M.analytic_cost(c.arch, c.shape, mesh, n_chips=n_chips,
                                           n_model=16)) == _cost_tuple(got)
    # the train cells the reference cannot cost: its formula with 3-tuple knobs
    for arch in FOUR_TUPLE_KNOBS:
        monkeypatch.setitem(jcells.TRAIN_KNOBS, arch, jcells.TRAIN_KNOBS[arch][:3])
        for remat in (None, True, False):
            assert _cost_tuple(M.analytic_cost(arch, "train_4k", mesh, micro_remat=remat)) \
                == _cost_tuple(JM.analytic_cost(arch, "train_4k", mesh, micro_remat=remat))


def test_analytic_cost_of_one_card():
    shape = cells.Shape("train_8x512", 512, 8, "train")
    one = M.analytic_cost("smollm_135m", shape, n_chips=1, n_model=1)
    assert one.model_flops == A.model_flops_for("smollm_135m", shape) == pytest.approx(
        6 * 134_515_008 * 4096)
    assert one.gemm_flops == 4 / 6 * 2 * one.model_flops  # fwd, bwd, one remat replay
    # on one card the whole parameter set and optimizer state are local
    many = M.analytic_cost("smollm_135m", shape, n_chips=16, n_model=16)
    assert one.hbm_bytes_per_device > many.hbm_bytes_per_device


def test_analytic_cost_refuses_a_model_axis_that_does_not_divide_the_chips():
    shape = cells.Shape("train_8x512", 512, 8, "train")
    for n_chips, n_model in ((1, 16), (24, 16), (16, 0)):
        with pytest.raises(ValueError, match="model axis"):
            M.analytic_cost("smollm_135m", shape, n_chips=n_chips, n_model=n_model)


def test_analytic_cost_shards_parameters_by_the_cells_partition(monkeypatch):
    """The parameter bytes follow ``cells.TRAIN_KNOBS``' partition: over all
    chips under FSDP, over the model axis alone under ZeRO-1."""
    arch, cfg = "tinyllama_1_1b", configs.get("tinyllama_1_1b")
    zero1 = M.analytic_cost(arch, "decode_32k", "single")
    monkeypatch.setitem(cells.TRAIN_KNOBS, arch, ("fsdp",) + cells.TRAIN_KNOBS[arch][1:])
    fsdp = M.analytic_cost(arch, "decode_32k", "single")
    assert zero1.hbm_bytes_per_device - fsdp.hbm_bytes_per_device == pytest.approx(
        cfg.param_count() * 2 * (1 / 16 - 1 / 256))


def _pair(**kw):
    fields = dict(arch="x", shape="train_4k", mesh="single", flops=3e12, hbm_bytes=2e10,
                  coll_bytes=6e9, model_flops=5e14, n_chips=256, wire_bytes=64 << 20,
                  wire_raw_bytes=100 << 20)
    fields.update(kw)
    return A.Roofline(**fields), JA.Roofline(**fields)


def test_roofline_fields_and_terms_are_the_references_scaled_by_the_constants():
    assert [f.name for f in dataclasses.fields(A.Roofline)] == [
        f.name for f in dataclasses.fields(JA.Roofline)]
    got, want = _pair()
    assert got.t_compute * A.PEAK_FLOPS_BF16 == pytest.approx(want.t_compute * JA.PEAK_FLOPS_BF16)
    assert got.t_compute == pytest.approx(want.t_compute * JA.PEAK_FLOPS_BF16
                                          / A.PEAK_FLOPS_BF16)
    assert got.t_memory == pytest.approx(want.t_memory * JA.HBM_BW / A.HBM_BW)
    assert got.t_collective == pytest.approx(want.t_collective * JA.ICI_BW / A.LINK_BW)
    assert got.useful_flops_fraction == want.useful_flops_fraction
    assert got.wire_ratio == want.wire_ratio == pytest.approx(0.64)
    # the reference's own terms test, posed at the card's constants
    r = A.Roofline(arch="x", shape="train_4k", mesh="single",
                   flops=A.PEAK_FLOPS_BF16 * 0.010, hbm_bytes=A.HBM_BW * 0.005,
                   coll_bytes=A.LINK_BW * 0.020,
                   model_flops=A.PEAK_FLOPS_BF16 * 0.008 * 256, n_chips=256)
    assert (r.t_compute, r.t_memory, r.t_collective) == pytest.approx((0.010, 0.005, 0.020))
    assert r.bottleneck == "collective" and r.t_bound == pytest.approx(0.020)
    assert r.useful_flops_fraction == pytest.approx(0.8)
    assert r.roofline_fraction == pytest.approx(0.008 / 0.020)
    assert (A.PEAK_FLOPS_BF16, A.HBM_BW, A.LINK_BW, A.NET_BW) == (989.4e12, 3.35e12, 450e9,
                                                                  50e9)


def test_wire_report_seconds_and_markdown_rows():
    reports = [policy.WireReport(name="a", axis="data", raw_bytes=100, wire_bytes=60),
               policy.WireReport(name="b", axis="data", raw_bytes=50, wire_bytes=40)]
    assert A.wire_report_seconds(reports) == 100 / A.LINK_BW
    assert A.wire_report_seconds(reports, link_bw=A.NET_BW) == JA.wire_report_seconds(
        reports, link_bw=A.NET_BW)
    got, want = _pair(flops=A.PEAK_FLOPS_BF16 * 0.01, hbm_bytes=A.HBM_BW * 0.002,
                      coll_bytes=A.LINK_BW * 0.001)
    assert A.markdown_row(got).startswith("| x | train_4k | single | 10.00 | 2.00 | 1.00 | "
                                          "compute |")
    assert A.markdown_row(got).count("|") == JA.markdown_row(want).count("|")
    assert A.markdown_row_wire(got).count("|") == JA.markdown_row_wire(want).count("|")
    assert A.MD_HEADER == JA.MD_HEADER
    assert A.MD_HEADER_WIRE == JA.MD_HEADER_WIRE.replace("HLO coll", "trace coll")


# ---------------------------------------------------------------------------
# collective bytes from a profiler trace
# ---------------------------------------------------------------------------

def _trace(fn, path):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    return path.read_text()


def test_collective_bytes_of_known_gloo_collectives(tmp_path):
    def run():
        dist.all_reduce(torch.ones(1000, dtype=torch.bfloat16))
        dist.all_reduce(torch.ones(3, dtype=torch.int64))
        dist.all_gather_into_tensor(torch.empty(1000), torch.ones(1000))
        dist.all_gather([torch.empty(10, dtype=torch.float16)],
                        torch.ones(10, dtype=torch.float16))
        dist.reduce_scatter_tensor(torch.empty(600, dtype=torch.int32),
                                   torch.ones(600, dtype=torch.int32))
        dist.all_to_all_single(torch.empty(256, dtype=torch.uint8),
                               torch.zeros(256, dtype=torch.uint8))
        cc.raw_ppermute(torch.ones(300, dtype=torch.bfloat16), None, [(0, 0)])
        dist.broadcast(torch.ones(7), 0)  # no kind of the reference's: not counted

    with single_process_group("cpu"):
        text = _trace(run, tmp_path / "t.json")
    got = A.collective_bytes(text)
    assert got["bytes"] == {"all-reduce": 2000 + 24, "all-gather": 4000 + 20,
                            "reduce-scatter": 2400, "all-to-all": 256,
                            "collective-permute": 600}
    assert got["counts"] == {"all-reduce": 2, "all-gather": 2, "reduce-scatter": 1,
                             "all-to-all": 1, "collective-permute": 1}
    assert got["total_bytes"] == sum(got["bytes"].values())
    assert A.collective_bytes(json.loads(text)) == got
    assert A.collective_bytes(json.loads(text)["traceEvents"]) == got
    assert set(got["bytes"]) == set(JA.collective_bytes("")["bytes"])


def test_collective_bytes_refuse_a_trace_without_shapes(tmp_path):
    with single_process_group("cpu"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            dist.all_reduce(torch.ones(8))
        prof.export_chrome_trace(str(tmp_path / "t.json"))
    with pytest.raises(ValueError, match="record_shapes"):
        A.collective_bytes((tmp_path / "t.json").read_text())
    op = {"ph": "X", "name": "c10d::_allgather_base_", "ts": 0, "dur": 1,
          "args": {"Input Dims": [[4], [4]], "Input type": ["?", "complex"]}}
    with pytest.raises(ValueError, match="unknown element type"):
        A.collective_bytes([op])
    lst = {"ph": "X", "name": "c10d::allreduce_", "ts": 0, "dur": 1,
           "args": {"Input Dims": [[[4]]], "Input type": ["TensorList"]}}
    with pytest.raises(ValueError, match="no element type"):
        A.collective_bytes([lst])
    # NCCL's record_param_comms nested in the op gives a list's type
    nested = {"ph": "X", "name": "record_param_comms", "ts": 0.5, "dur": 0.1,
              "args": {"dtype": "BFloat16"}}
    assert A.collective_bytes([lst, nested])["bytes"]["all-reduce"] == 8


@pytest.mark.parametrize("fn", ["all_gather_compressed", "reduce_scatter_compressed"])
def test_traced_bytes_of_a_compressed_wire_are_its_wire_report(tmp_path, fn):
    x = to_torch(grad_like_bits("bfloat16", 512 * 64, seed=3), "bfloat16")
    with single_process_group("cpu") as g, policy.capture_wire_reports() as reps:
        text = _trace(lambda: getattr(cc, fn)(x, g, width=5), tmp_path / "t.json")
    (rep,) = reps
    got = A.collective_bytes(text)
    assert got["total_bytes"] == rep.wire_bytes < rep.raw_bytes
    kind = "all-gather" if fn == "all_gather_compressed" else "all-to-all"
    assert got["bytes"][kind] == rep.wire_bytes


# ---------------------------------------------------------------------------
# cell JSONs, analyze_cell, the report
# ---------------------------------------------------------------------------

def _all_reduce_trace(path):
    with single_process_group("cpu"):
        _trace(lambda: dist.all_reduce(torch.ones(512)), path)


def test_analyze_cell_folds_wire_reports(tmp_path):
    """The reference's folding test, with a trace of one f32[512] all-reduce
    in place of its HLO line."""
    rec = {"arch": "tinyllama_1_1b", "shape": "train_4k", "mesh": "single",
           "ok": True, "cost": {"flops": 1e12, "bytes accessed": 1e9},
           "wire": {"n": 4, "n_fused": 2, "raw_bytes": 100 << 20,
                    "wire_bytes": 64 << 20, "ratio": 0.64,
                    "decode_hbm_paid": 0,
                    "decode_hbm_eliminated": 400 << 20}}
    jp = tmp_path / "cell.json"
    jp.write_text(json.dumps(rec))
    _all_reduce_trace(tmp_path / "cell.trace.json")
    r = A.analyze_cell(str(jp))
    assert r.wire_bytes == 64 << 20
    assert r.wire_raw_bytes == 100 << 20
    assert r.wire_ratio == pytest.approx(0.64)
    assert r.decode_hbm_eliminated == 400 << 20
    assert r.coll_bytes == 512 * 4 and r.n_chips == 256
    assert r.model_flops == JA.model_flops_for("tinyllama_1_1b", "train_4k")
    row = A.markdown_row_wire(r)
    assert "0.640" in row and f"{64.0:.1f}" in row
    # no wire record -> dashes, not a crash; n_chips and model_flops from the
    # record when it has them
    rec2 = dict(rec, n_chips=1, model_flops=2e12, mesh="one_card", shape="train_8x512")
    del rec2["wire"]
    jp2 = tmp_path / "cell2.json"
    jp2.write_text(json.dumps(rec2))
    (tmp_path / "cell2.trace.json").write_text(json.dumps({"traceEvents": []}))
    r2 = A.analyze_cell(str(jp2))
    assert r2.wire_ratio == 0.0 and r2.coll_bytes == 0
    assert (r2.n_chips, r2.model_flops) == (1, 2e12)
    assert r2.useful_flops_fraction == pytest.approx(2.0)
    assert "- | - | -" in A.markdown_row_wire(r2)
    rec3 = dict(rec, mesh="multi")
    (tmp_path / "cell3.json").write_text(json.dumps(rec3))
    assert A.analyze_cell(str(tmp_path / "cell3.json"),
                          str(tmp_path / "cell.trace.json")).n_chips == 512


def test_analyze_cell_v2_is_the_analytic_cost_beside_the_trace(tmp_path):
    rec = {"arch": "tinyllama_1_1b", "shape": "prefill_32k", "mesh": "multi", "ok": True,
           "cost": {}}
    (tmp_path / "c.json").write_text(json.dumps(rec))
    _all_reduce_trace(tmp_path / "c.trace.json")
    r, coll, got = M.analyze_cell_v2(str(tmp_path / "c.json"))
    ac = JM.analytic_cost("tinyllama_1_1b", "prefill_32k", "multi")
    assert got == rec and coll["total_bytes"] == 2048
    assert (r.flops, r.hbm_bytes, r.model_flops, r.n_chips) == (
        ac.total_flops / 512, ac.hbm_bytes_per_device, ac.model_flops, 512)
    one = dict(rec, n_chips=1, mesh="one_card")
    (tmp_path / "d.json").write_text(json.dumps(one))
    r1, _, _ = M.analyze_cell_v2(str(tmp_path / "d.json"), str(tmp_path / "c.trace.json"))
    ac1 = M.analytic_cost("tinyllama_1_1b", "prefill_32k", n_chips=1, n_model=1)
    assert (r1.flops, r1.hbm_bytes, r1.n_chips) == (ac1.total_flops, ac1.hbm_bytes_per_device,
                                                    1)


def test_report_collects_the_ok_cells_of_a_mesh(tmp_path, capsys):
    out = tmp_path / "rows.json"
    tmp_path = tmp_path / "cells"
    tmp_path.mkdir()
    base = {"shape": "train_4k", "mesh": "single", "ok": True,
            "cost": {"flops": 1e12, "bytes accessed": 1e9},
            "wire": {"raw_bytes": 100, "wire_bytes": 80}}
    cells_ = {"a": dict(base, arch="tinyllama_1_1b"),
              "b": dict(base, arch="glm4_9b", shape="decode_32k"),
              "b__raw": dict(base, arch="glm4_9b"),
              "c": dict(base, arch="glm4_9b", ok=False),
              "d": dict(base, arch="glm4_9b", mesh="multi"),
              "e": dict(base, arch="gemma3_27b")}  # no trace beside it
    for name, rec in cells_.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
        if name != "e":
            (tmp_path / f"{name}.trace.json").write_text(json.dumps({"traceEvents": []}))
    rows = report.collect(str(tmp_path))
    assert [(r.arch, r.shape) for r in rows] == [("tinyllama_1_1b", "train_4k"),
                                                 ("glm4_9b", "decode_32k")]
    assert len(report.collect(str(tmp_path), compressed_only=False)) == 3
    assert [r.arch for r in report.collect(str(tmp_path), mesh="multi")] == ["glm4_9b"]
    report.main(["--dir", str(tmp_path), "--json-out", str(out)])
    text = capsys.readouterr().out.splitlines()
    assert text[:2] == A.MD_HEADER_WIRE.splitlines()
    assert text[2].startswith("| glm4_9b | decode_32k |") and len(text) == 4
    assert [d["wire_ratio"] for d in json.loads(out.read_text())] == [0.8, 0.8]
    report.main(["--dir", str(tmp_path), "--no-wire"])
    assert capsys.readouterr().out.splitlines()[:2] == A.MD_HEADER.splitlines()
    assert np.isfinite([r.t_bound for r in rows]).all()
