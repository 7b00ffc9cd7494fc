"""The port's training slice (smollm SMOKE, ZeRO-1 over the compressed
two-shot wire) held against the JAX reference, plus the port's own
invariants: compressed and raw twins identical, no kernel launch on the
CPU, entry points that refuse to fall back to the CPU, and no import of JAX.

Tolerances, with their reasons:
* data batches, configs, parameter order and ZeRO-1 bucket bytes: exact;
* forward loss: relative 1e-4.  Both frameworks compute the bf16 forward
  with f32 accumulation but sum in other orders (measured: 3e-5);
* ZeRO-1 update on the same gradients: f32 master and moments within 1e-6
  of the bucket's largest magnitude, because XLA:CPU contracts and
  reassociates the update's arithmetic (measured: 6e-8, a few ulps, which
  cancellation carries into the small entries); so a bf16 weight may round
  the other way: at most 0.1% of them, by one bf16 ulp (measured: 1 of
  68 096);
* a whole train step: the bf16 backward rounds in other places, so
  gradients differ in their last bits.  AdamW's first step moves every
  weight by about ``lr`` times the gradient's sign, so a near-zero
  gradient whose sign flips moves a weight by ``2 lr`` and one bf16
  rounding: weights within ``2 lr_1 + 2**-7 |w|``, with at most 1% of them
  different (measured: 0.6%); loss relative 1e-4; grad norm relative 1e-2
  (measured: 2e-3).
"""
import ast
import re
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core.policy import CompressionPolicy as JPolicy
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro.launch.mesh import make_smoke_mesh
from repro.models import transformer as jtransformer
from repro.optim import optimizers as jopt
from repro.optim import zero1 as jzero1
from repro.train import step as jstep
from repro_torch import configs, kernels
from repro_torch.core.calibrate import CompressionProfile
from repro_torch.core.policy import CompressionPolicy
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.optim import optimizers as opt
from repro_torch.optim import zero1
from repro_torch.train import step as step_lib
from torch_port_util import np_of, run_gloo_ranks, train_twin_rank

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH, BATCH, SEQ, LR, WARMUP = "smollm_135m", 4, 32, 1e-3, 2


@pytest.fixture(scope="module")
def reference():
    """The reference's SMOKE weights (numpy tree) and first batch."""
    cfg = jconfigs.get_smoke(ARCH)
    params = jtransformer.init(jax.random.PRNGKey(0), cfg)
    batch = JDataPipeline(JDataConfig(vocab=cfg.vocab, global_batch=BATCH,
                                      seq_len=SEQ, seed=0)).batch_at(0)
    return cfg, params, jax.tree_util.tree_map(np.asarray, params), batch


def _tensors(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def test_configs_and_data_match_reference():
    for get in ("get", "get_smoke"):
        ref, port = getattr(jconfigs, get)(ARCH), getattr(configs, get)(ARCH)
        for f in dataclasses.fields(port):
            if f.name == "pattern":
                for spec, rspec in zip(port.pattern, ref.pattern, strict=True):
                    assert dataclasses.asdict(spec).items() <= \
                        dataclasses.asdict(rspec).items()
            else:
                assert getattr(port, f.name) == getattr(ref, f.name), (get, f.name)
        assert port.param_count() == ref.param_count()
    jp = JDataPipeline(JDataConfig(vocab=256, global_batch=8, seq_len=16, seed=3),
                       process_index=1, process_count=2)
    tp = DataPipeline(DataConfig(vocab=256, global_batch=8, seq_len=16, seed=3),
                      process_index=1, process_count=2)
    for step in (0, 5):
        for k, v in jp.batch_at(step).items():
            assert np.array_equal(tp.batch_at(step)[k], v), (step, k)


def test_reference_weights_fill_the_same_bucket(reference):
    """Parameter order equals ``tree_leaves``: the ZeRO-1 bucket holds the
    reference's bytes, and the optimizer state carries across."""
    cfg, params, tree, _ = reference
    model = transformer.load_reference_params(tree, configs.get_smoke(ARCH), "cpu")
    paths = [p for p, _ in transformer.tree_paths(tree)]
    assert list(model.params.keys()) == paths
    assert paths[:3] == ["blocks/0/ffn/w1", "blocks/0/ffn/w2", "blocks/0/ffn/w3"]
    assert paths[-2:] == ["embed", "final_norm"]
    meta = zero1.plan_buckets(model.leaves(), 2)
    jmeta = jzero1.plan_buckets(params, 2)
    assert (meta.dtype_names, meta.members, meta.padded) == \
        (jmeta.dtype_names, jmeta.members, jmeta.padded)
    (bucket,) = zero1.flatten_buckets(meta, model.leaves())
    (jbucket,) = jzero1.flatten_buckets(jmeta, params)
    assert np.array_equal(np_of(bucket), np_of(jbucket))
    ocfg = jopt.OptimConfig()
    jst = jzero1.zero1_init_local(ocfg, jmeta, params, ("data",), dp_index=1)
    st = zero1.zero1_init_local(opt.OptimConfig(), meta, model.leaves(), dp_index=1)
    loaded = zero1.load_reference_zero1_state(
        jax.tree_util.tree_map(np.asarray, jst), "cpu")
    for k in ("master", "m", "v"):
        assert torch.equal(st["buckets"][0][k], loaded["buckets"][0][k]), k


def test_forward_loss_matches_reference(reference):
    cfg, params, tree, batch = reference
    hidden = jtransformer.forward(params, batch, cfg)
    want = float(jstep.chunked_ce_loss(params, hidden, batch["labels"], cfg, 16))
    model = transformer.load_reference_params(tree, configs.get_smoke(ARCH), "cpu")
    with torch.no_grad():
        got = float(step_lib.loss_fn(model, _tensors(batch),
                                     step_lib.TrainConfig(loss_chunk=16)))
    assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_zero1_step_matches_reference_on_the_same_gradients(reference, optimizer):
    """Two compressed ZeRO-1 steps on a one-rank group, fed the same bf16
    gradients as the reference's ``zero1_step`` on a one-device mesh."""
    _, params, tree, _ = reference
    rng = np.random.default_rng(31)
    gtree = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.02, a.shape).astype(a.dtype), tree)
    jocfg = jopt.OptimConfig(name=optimizer, lr=LR, warmup_steps=WARMUP)
    jmeta = jzero1.plan_buckets(params, 1)
    jst = jzero1.zero1_init_local(jocfg, jmeta, params, ("data",), dp_index=0)

    def body(p, g, st):
        return jzero1.zero1_step(jocfg, jmeta, p, g, st, dp_axes=("data",),
                                 policy=JPolicy(min_bytes=0))

    jfn = jax.jit(jax.shard_map(body, mesh=make_smoke_mesh(1), in_specs=(P(),) * 3,
                                out_specs=(P(),) * 4, axis_names={"data", "model"},
                                check_vma=False))
    jgrads = jax.tree_util.tree_map(jnp.asarray, gtree)
    jp, jstate = params, jst
    for _ in range(2):
        jp, jstate, jflag, jgnorm = jfn(jp, jgrads, jstate)

    model = transformer.load_reference_params(tree, configs.get_smoke(ARCH), "cpu")
    grads = [transformer.numpy_to_torch(a, torch.bfloat16)
             for _, a in transformer.tree_paths(gtree)]
    meta = zero1.plan_buckets(model.leaves(), 1)
    state = zero1.load_reference_zero1_state(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    p = model.leaves()
    ocfg = opt.OptimConfig(name=optimizer, lr=LR, warmup_steps=WARMUP)
    with launch_train.single_process_group("cpu") as group:
        for _ in range(2):
            p, state, flag, gnorm = zero1.zero1_step(
                ocfg, meta, p, grads, state, group=group,
                policy=CompressionPolicy(min_bytes=0))
    assert int(flag) == int(jflag) == 0
    assert float(gnorm) == pytest.approx(float(jgnorm), rel=1e-6)
    n_diff = n_all = 0
    for got, want in zip(p, jax.tree_util.tree_leaves(jp)):
        g, w = got.float().numpy(), np.asarray(want, np.float32)
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=0)
        n_diff += int((g != w).sum())
        n_all += g.size
    assert n_diff <= 1e-3 * n_all, (n_diff, n_all)
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    assert int(state["count"]) == int(jstate["count"]) == 2
    for k, want in jstate["buckets"][0].items():
        w = want.reshape(-1)
        np.testing.assert_allclose(state["buckets"][0][k].numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_train_step_matches_reference(reference):
    """One whole compressed ZeRO-1 step (forward, backward, RS, update, AG)
    against ``repro.train.step`` on a one-device mesh, ``min_bytes=0``."""
    _, _, tree, batch = reference
    jcfg = jconfigs.get_smoke(ARCH)
    jtcfg = jstep.TrainConfig(policy=JPolicy(min_bytes=0), loss_chunk=16,
                              optim=jopt.OptimConfig(lr=LR, warmup_steps=WARMUP))
    mesh = make_smoke_mesh(1)
    jstate, _ = jstep.build_train_state(jcfg, jtcfg, mesh, jax.random.PRNGKey(0))
    jfn, _ = jstep.build_train_step(jcfg, jtcfg, mesh)
    opt_tree = jax.tree_util.tree_map(np.asarray, jstate["opt"])
    jnew, jm = jax.jit(jfn)(jstate, batch)

    tcfg = step_lib.TrainConfig(loss_chunk=16, policy=CompressionPolicy(min_bytes=0),
                                optim=opt.OptimConfig(lr=LR, warmup_steps=WARMUP))
    model = transformer.load_reference_params(tree, configs.get_smoke(ARCH), "cpu")
    state = step_lib.TrainState(model=model, opt=zero1.load_reference_zero1_state(opt_tree, "cpu"),
                                meta=zero1.plan_buckets(model.leaves(), 1))
    with launch_train.single_process_group("cpu") as group, launch_train.deterministic():
        m = step_lib.train_step(state, _tensors(batch), tcfg, group=group)
    assert m["overflow"] == int(jm["overflow"]) == 0
    assert state.step == int(jnew["step"]) == 1
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(m["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=1e-2)
    lr1 = float(opt.lr_at(tcfg.optim, torch.tensor(1)))
    n_diff = n_all = 0
    for got, want in zip(model.leaves(), jax.tree_util.tree_leaves(jnew["params"])):
        g = got.detach().float().numpy()
        w = np.asarray(want, np.float32)
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=2 * lr1)
        n_diff += int((g != w).sum())
        n_all += g.size
    assert n_diff <= 0.01 * n_all, (n_diff, n_all)


def _smoke_train(compress, **kw):
    return launch_train.train(ARCH, steps=3, batch=BATCH, seq=SEQ, compress=compress,
                              smoke=True, device="cpu", lr=LR, warmup=WARMUP, **kw)


def _param_bits(run):
    return [np_of(p) for p in run.state.model.leaves()]


def test_compressed_and_raw_twins_are_identical_and_launch_no_kernel():
    kernels.clear_launch_counts()
    with launch_train.single_process_group("cpu"):
        comp = _smoke_train(True)
        raw = _smoke_train(False)
    assert comp.losses == raw.losses and comp.losses[-1] < comp.losses[0]
    for a, b in zip(_param_bits(comp), _param_bits(raw)):
        assert np.array_equal(a, b)
    assert comp.retries == raw.retries == 0
    # each step's wire is one consolidated report of its zero1 plan
    assert [r.name for r in comp.wire_reports] == ["plan:zero1"] * 3
    assert raw.wire_reports == []
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_two_rank_twins_are_identical(tmp_path):
    res = run_gloo_ranks(train_twin_rank, 2, tmp_path, 2, BATCH, SEQ)
    for r in res:
        assert np.array_equal(r["comp_losses"], r["raw_losses"])
        assert np.array_equal(r["comp_params"], r["raw_params"])
        assert r["comp_retries"] == r["raw_retries"] == 0
    assert np.array_equal(res[0]["comp_params"], res[1]["comp_params"])
    assert np.array_equal(res[0]["comp_losses"], res[1]["comp_losses"])


def test_overflowing_step_is_kept_back_and_rerun_raw(monkeypatch):
    """Width 1 with no exception room overflows every compressed wire: the
    guarded step keeps the old weights and step count, and the launcher
    reruns it uncompressed, so the run equals the raw twin."""
    monkeypatch.setattr(CompressionProfile, "default", staticmethod(
        lambda dtype_name="bfloat16": CompressionProfile(
            widths={"gradient": 1, "weight": 1}, exc_frac=1e-9)))
    tcfg = step_lib.TrainConfig(loss_chunk=16, policy=CompressionPolicy(min_bytes=0))
    with launch_train.single_process_group("cpu") as group:
        state = step_lib.build_train_state(
            configs.get_smoke(ARCH), tcfg, generator=torch.Generator().manual_seed(0),
            group=group, device="cpu")
        before = [np_of(p) for p in state.model.leaves()]
        opt_before = state.opt
        batch = DataPipeline(DataConfig(vocab=256, global_batch=BATCH,
                                        seq_len=SEQ)).tensors_at(0, "cpu")
        m = step_lib.train_step(state, batch, tcfg, group=group)
        assert m["overflow"] == 1 and state.step == 0 and state.opt is opt_before
        for a, p in zip(before, state.model.leaves()):
            assert np.array_equal(a, np_of(p))
        comp = _smoke_train(True)
        raw = _smoke_train(False)
    assert comp.retries == 3
    assert comp.losses == raw.losses


def test_entry_points_default_to_cuda_and_refuse_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke(ARCH)
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        DataPipeline(DataConfig(vocab=256, global_batch=2, seq_len=8)).tensors_at(0)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--arch", ARCH, "--smoke", "--steps", "1"])


def test_launch_cli_trains_on_the_cpu(capsys):
    launch_train.main(["--arch", "smollm-135m", "--smoke", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    # the StepRunner's log line pads the step to six columns, as the reference's
    assert re.search(r"step +1 loss", out) and "retries 0 | compressed=True" in out


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    assert len(files) > 20
    rel = {str(f.relative_to(SRC)) for f in files[:-1]}
    assert {f"repro_torch/{m}.py" for m in (
        "kernels/bitpack", "kernels/rans", "core/ans", "core/integrity",
        "p2p/engine", "sched/plan", "sched/compile", "sched/cache",
        "serve/kv_transfer", "serve/engine", "launch/serve", "tree_util",
        "kernels/plane_split", "sync/engine", "sync/store",
        "launch/rl_weight_sync")} <= rel
    for f in files:
        assert not _imports(f) & {"jax", "jaxlib", "repro"}, f
    mods = [".".join(f.relative_to(SRC).with_suffix("").parts) for f in files[:-1]]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
