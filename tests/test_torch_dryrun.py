"""The dry run (``launch/dryrun``) at SMOKE width, its cells cut to a
small shape, on a fake (data, model) = (2, 2) world: one cell of each
kind, a ZeRO-1 train cell (tinyllama), an FSDP train cell (qwen2-vl, its
vision stub's ``vision_embeds`` in the batch), a prefill cell
(deepseek-v2-lite: MLA, MoE over 'model'), a decode cell (whisper: its
``enc_out``) and a ``long_500k`` cell (xlstm: a batch of 1 that the DP
ranks do not split).  ``configs.get`` points at ``get_smoke`` and the
train cells compress every wire (``min_bytes`` 0; FSDP shards the leaves
of 32 KiB and more) at one microbatch.

* every cell writes the reference's JSON schema and a trace that
  ``roofline/report.collect`` reads; the trace's collective bytes equal
  the JSON's (which ``run_cell`` already held against the step's own
  count, the plan and the wire reports);
* the fake-tensor accounting of the same cell at a one-rank mesh
  (arguments, outputs, the peak above the arguments, the arguments
  written in place, FLOPs) equals the same tracker's and counter's on real
  CPU tensors in a gloo world of one rank;
* the ZeRO-1 state's bytes: the specs count each bucket row once a model
  shard, the rank holds its block (``spec_argument_size_bytes`` against
  ``argument_size_bytes``).

Tolerances: none; every number is compared exactly."""
import dataclasses
import json
import os

import numpy as np
import pytest

from repro_torch import configs
from repro_torch.core.policy import CompressionPolicy
from repro_torch.launch import cells
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import analysis, report
from repro_torch.train import step as step_lib

MESH = (2, 2)
CELLS = {
    "zero1": ("tinyllama_1_1b", cells.Shape("train_4k", 16, 8, "train")),
    "fsdp": ("qwen2_vl_72b", cells.Shape("train_4k", 16, 8, "train")),
    "prefill": ("deepseek_v2_lite_16b", cells.Shape("prefill_32k", 16, 4, "prefill")),
    "decode": ("whisper_small", cells.Shape("decode_32k", 16, 4, "decode")),
    "long": ("xlstm_350m", cells.Shape("long_500k", 64, 1, "decode")),
}
FSDP_MIN_BYTES = 32 << 10
KEYS = {"arch", "shape", "mesh", "compressed", "ok", "memory", "cost", "cost_raw_keys", "wire",
        "n_chips", "model_flops", "build_s", "run_s", "collectives"}
MEMORY = {"argument_size_bytes", "output_size_bytes", "temp_size_bytes", "alias_size_bytes",
          "generated_code_size_bytes", "spec_argument_size_bytes"}
WIRE = {"n", "n_fused", "raw_bytes", "wire_bytes", "ratio", "decode_hbm_paid",
        "decode_hbm_eliminated", "encode_hbm_paid", "encode_hbm_eliminated", "by_name"}


def _smoke(monkeypatch):
    """SMOKE configs, every train wire compressed, FSDP over the leaves of
    FSDP_MIN_BYTES and more, one microbatch."""
    monkeypatch.setattr(configs, "get", configs.get_smoke)
    monkeypatch.setitem(cells.TRAIN_KNOBS, "qwen2_vl_72b", ("fsdp", "adamw", 1))
    monkeypatch.setitem(cells.TRAIN_KNOBS, "tinyllama_1_1b", ("zero1", "adamw", 1))
    make = dryrun.make_train_config

    def make_train_config(*a, **k):
        tcfg = make(*a, **k)
        return dataclasses.replace(tcfg, fsdp_min_bytes=FSDP_MIN_BYTES, policy=(
            CompressionPolicy(min_bytes=0) if tcfg.policy.enabled else tcfg.policy))

    monkeypatch.setattr(dryrun, "make_train_config", make_train_config)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    _smoke(mp)
    out = {}
    try:
        for kind, (arch, shape) in CELLS.items():
            d = tmp_path_factory.mktemp(kind)
            out[kind] = {"dir": str(d), "cell": dryrun.run_cell(arch, shape, "single", str(d),
                                                                mesh_shape=MESH)}
            for fake in (True, False):
                out[kind][fake] = dryrun.run_cell(
                    arch, shape, "single", str(tmp_path_factory.mktemp(f"{kind}_{fake}")),
                    mesh_shape=(1, 1), fake=fake, save_trace=False)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kind", CELLS)
def test_cell_json_has_the_reference_schema(runs, kind):
    arch, shape = CELLS[kind]
    rec = runs[kind]["cell"]
    with open(os.path.join(runs[kind]["dir"], f"{arch}__{shape.name}__single.json")) as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert KEYS <= set(rec) and set(rec["memory"]) == MEMORY and set(rec["wire"]) == WIRE
    assert rec["ok"] and rec["mesh"] == "single" and rec["n_chips"] == 4
    assert rec["cost_raw_keys"] == ["flops"] and rec["cost"]["flops"] > 0
    assert rec["memory"]["generated_code_size_bytes"] is None
    assert rec["memory"]["argument_size_bytes"] > 0 and rec["memory"]["temp_size_bytes"] > 0
    assert rec["mesh_shape"] == {"data": 2, "model": 2}


@pytest.mark.parametrize("kind", CELLS)
def test_report_collect_reads_the_cell_and_its_trace(runs, kind):
    arch, shape = CELLS[kind]
    rec, d = runs[kind]["cell"], runs[kind]["dir"]
    (row,) = report.collect(d, mesh="single")
    assert (row.arch, row.shape, row.n_chips) == (arch, shape.name, 4)
    assert row.flops == rec["cost"]["flops"]
    with open(os.path.join(d, f"{arch}__{shape.name}__single.trace.json")) as f:
        traced = analysis.collective_bytes(f.read())
    assert traced["bytes"] == rec["collectives"]["bytes"]
    assert traced["counts"] == rec["collectives"]["counts"]
    assert row.coll_bytes == sum(rec["collectives"]["bytes"].values()) > 0


@pytest.mark.parametrize("kind", ["zero1", "fsdp"])
def test_train_cells_compress_their_sync_wires(runs, kind):
    wire = runs[kind]["cell"]["wire"]
    names = {"zero1": {"plan:zero1"}, "fsdp": {"all_gather", "reduce_scatter"}}[kind]
    assert set(wire["by_name"]) == names and 0 < wire["ratio"] < 1.5
    assert wire["wire_bytes"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode", "long"])
def test_serve_cells_report_no_compressed_wire(runs, kind):
    assert runs[kind]["cell"]["wire"]["n"] == 0


@pytest.mark.parametrize("kind", CELLS)
def test_fake_accounting_equals_real_cpu_tensors(runs, kind):
    fake, real = runs[kind][True], runs[kind][False]
    assert fake["fake"] and not real["fake"]
    assert fake["memory"] == real["memory"]
    assert fake["cost"] == real["cost"]
    assert fake["collectives"] == real["collectives"]


def test_zero1_state_bytes_by_specs_count_a_row_once_a_model_shard(runs):
    """On the (2, 2) mesh the specs lay each ZeRO-1 bucket leaf out ``(dp,
    None)`` over ``(n_dp, 2 * shard_len)``: the spec bytes are the held
    bytes plus the optimizer state's bucket leaves once more, and the
    step counter (a 0-d int32 in the specs, a host int in the port's
    ``TrainState``)."""
    arch, _ = CELLS["zero1"]
    mem = runs["zero1"]["cell"]["memory"]
    mesh = mesh_lib.AbstractMesh(MESH, ("data", "model"))
    mp = pytest.MonkeyPatch()
    _smoke(mp)
    try:
        tcfg = dryrun.make_train_config(arch, mesh)
        ostruct, ospecs = step_lib._zero1_state_layout(configs.get(arch), tcfg, mesh)
    finally:
        mp.undo()
    rows = mesh_lib.shard_bytes((ostruct["buckets"], ospecs["buckets"]), mesh)
    assert rows % 2 == 0 and rows > 0
    assert mem["spec_argument_size_bytes"] - mem["argument_size_bytes"] == rows // 2 + 4


def test_fsdp_and_serve_bytes_by_specs_are_the_rank_s(runs):
    """Every other leaf the specs lay out as the rank holds it; an FSDP
    state's step counter is a host int in the port (4 bytes in the specs)."""
    for kind in ("fsdp", "prefill", "decode", "long"):
        mem = runs[kind]["cell"]["memory"]
        step = 4 if kind == "fsdp" else 0
        assert mem["spec_argument_size_bytes"] == mem["argument_size_bytes"] + step, kind


def test_long_cell_replicates_its_batch_of_one(runs):
    """xlstm's batch of 1 over 2 DP ranks: the rank holds the whole row
    (its tokens' bytes are those of the whole batch)."""
    arch, shape = CELLS["long"]
    mesh = mesh_lib.AbstractMesh(MESH, ("data", "model"))
    mp = pytest.MonkeyPatch()
    _smoke(mp)
    try:
        specs = dryrun.input_specs(arch, shape, mesh)
    finally:
        mp.undo()
    assert dryrun.local_shapes(specs[1], mesh) == [(1, 1)]
    rows = {s[1 if i else 0] for i, s in enumerate(dryrun.local_shapes(specs[2], mesh))
            if len(s) > 1}
    assert 1 in rows and np.all([r >= 1 for r in rows])
