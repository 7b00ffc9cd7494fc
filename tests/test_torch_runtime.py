"""The port's fault-tolerant step runner and heartbeat
(``repro_torch.runtime.fault_tolerance``) held against the reference's
(``repro.runtime.fault_tolerance``), and the port's launcher running
through it; the twin of ``tests/test_runtime.py``'s runner tests.

* each scenario (the retry on overflow, a straggler caught by an injected
  delay, train and resume, the fallback through corrupt checkpoints, the
  heartbeat, the SIGTERM flush and a bit-exact resume) gives the
  reference's outcome step by step: states, metrics, counters, the steps
  on disk and the obs counters;
* the launcher: a two-step CPU run through its StepRunner gives the losses
  and bits of the plain step loop it ran before (a ``zero1`` plan and
  ``train_step`` a step, a raw retry on overflow), a train state saved by
  the runner restores bit-identical, and a run resumed from a checkpoint
  continues with the uninterrupted run's losses.

Tolerance: none (step times are not compared).
"""
import dataclasses
import json
import os
import signal
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro.runtime import fault_tolerance as jft
from repro_torch import configs, obs
from repro_torch.core.calibrate import CompressionProfile
from repro_torch.core.policy import CompressionPolicy
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.launch import train as launch_train
from repro_torch.optim.optimizers import OptimConfig
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.fault_tolerance import RunnerConfig, StepRunner
from repro_torch.sched.cache import PlanCache
from repro_torch.train import step as step_lib
from repro_torch.tree_util import bits_equal

ARCH, BATCH, SEQ, LR, WARMUP = "smollm_135m", 2, 16, 1e-3, 2


@pytest.fixture(autouse=True)
def _isolate():
    for o in (obs, jobs):
        o.set_enabled(True)
        o.reset()
    yield
    for o in (obs, jobs):
        o.set_enabled(None)
        o.reset()


class Side:
    """One package's runtime: its runner module, pipeline and tensors."""

    def __init__(self, port: bool):
        self.port = port
        self.ft, self.obs = (ft, obs) if port else (jft, jobs)
        self.DataConfig, self.DataPipeline = ((DataConfig, DataPipeline) if port
                                              else (JDataConfig, JDataPipeline))

    def asarray(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype) if self.port else \
            jnp.asarray(x, dtype)

    def resume(self, runner, like):
        return runner.try_resume(like, device="cpu") if self.port else runner.try_resume(like)

    def value(self, x) -> int:
        return int(np.asarray(x))


PORT, REF = Side(True), Side(False)


def _obs_outcome(side) -> dict:
    snap = side.obs.snapshot()
    return {"counters": snap["counters"],
            "hist": {k: {s: v["count"] for s, v in d.items()}
                     for k, d in snap["histograms"].items()},
            "spans": [(s.name, s.ph) for s in side.obs.spans()]}


# ---------------------------------------------------------------------------
# the runner scenarios of tests/test_runtime.py, run by both packages
# ---------------------------------------------------------------------------

def _retry(side, tmp):
    """The step reports overflow: the runner reruns the batch on the
    fallback, whose state wins."""
    calls = {"main": 0, "fb": 0}

    def step(state, batch):
        calls["main"] += 1
        return state, {"overflow": np.int32(1), "loss": np.float32(5.0)}

    def fallback(state, batch):
        calls["fb"] += 1
        return {"v": state["v"] + 1}, {"overflow": np.int32(0), "loss": np.float32(4.0)}

    r = side.ft.StepRunner(step, fallback, side.ft.RunnerConfig(ckpt_dir=tmp))
    state, m = r.run_step({"v": 0}, {})
    # a fallback that overflows too: retried up to max_retries_per_step
    r2 = side.ft.StepRunner(step, step, side.ft.RunnerConfig(ckpt_dir=tmp))
    _, m2 = r2.run_step({"v": 0}, {})
    # no fallback: one retry is counted, the step's own result stands
    r3 = side.ft.StepRunner(step, None, side.ft.RunnerConfig(ckpt_dir=tmp))
    _, m3 = r3.run_step({"v": 0}, {})
    return {"calls": calls, "v": state["v"], "retries": (m["retries"], r.retries,
                                                         m2["retries"], m3["retries"]),
            "loss": float(m["loss"]), "overflow2": int(m2["overflow"])}


def _straggler(side, tmp):
    def fast(state, batch):
        return state, {"overflow": np.int32(0), "loss": np.float32(1.0)}

    r = side.ft.StepRunner(fast, None, side.ft.RunnerConfig(ckpt_dir=tmp,
                                                            straggler_factor=2.0))
    flags = [r.run_step({}, {})[1]["straggler"] for _ in range(10)]

    def slow(state, batch):
        time.sleep(max(0.05, 4 * np.median(r.times)))
        return state, {"overflow": np.int32(0), "loss": np.float32(1.0)}

    r.step_fn = slow
    _, m = r.run_step({}, {})
    # a fast step can read as a straggler on a busy host, so only the
    # injected one is compared
    return {"n_fast": len(flags), "slow": m["straggler"], "caught": r.stragglers >= 1,
            "n_times": len(r.times)}


def _train_resume(side, tmp):
    """Train, checkpoint, 'crash', resume exactly."""
    pipe = side.DataPipeline(side.DataConfig(vocab=100, global_batch=2, seq_len=4))

    def step(state, batch):
        s = {"v": state["v"] + side.asarray(batch["tokens"]).sum()}
        return s, {"overflow": np.int32(0), "loss": np.float32(side.value(s["v"]) % 7)}

    r = side.ft.StepRunner(step, None, side.ft.RunnerConfig(ckpt_dir=tmp, ckpt_every=3),
                           pipeline=pipe)
    state, hist = r.train({"v": side.asarray(0)}, num_steps=7, log_every=0,
                          log_fn=lambda *_: None)
    on_disk = r.ckpt.available_steps()
    r2 = side.ft.StepRunner(step, None, side.ft.RunnerConfig(ckpt_dir=tmp),
                            pipeline=side.DataPipeline(
                                side.DataConfig(vocab=100, global_batch=2, seq_len=4)))
    resumed, start = side.resume(r2, {"v": side.asarray(0)})
    state2, hist2 = r2.train(resumed, start_step=start, num_steps=2, log_every=0,
                             log_fn=lambda *_: None)
    return {"v": side.value(state["v"]), "hist": hist, "on_disk": on_disk, "start": start,
            "resumed": side.value(resumed["v"]), "v2": side.value(state2["v"]),
            "hist2": hist2, "pipe_step": r2.pipeline.state_dict()}


def _heartbeat(side, tmp):
    hb = os.path.join(tmp, "hb.json")

    def step(state, batch):
        return state, {"overflow": np.int32(0), "loss": np.float32(0.0)}

    pipe = side.DataPipeline(side.DataConfig(vocab=10, global_batch=2, seq_len=4))
    r = side.ft.StepRunner(step, None, side.ft.RunnerConfig(
        ckpt_dir=tmp, heartbeat_path=hb, ckpt_every=100), pipeline=pipe)
    r.train({}, num_steps=2, log_every=0, log_fn=lambda *_: None)
    with open(hb) as f:
        beat = json.load(f)
    return {"step": beat["step"], "keys": sorted(beat), "tmp_left": os.path.exists(hb + ".tmp")}


def _corrupt_fallback(side, tmp):
    """A corrupt latest checkpoint: try_resume walks back, newest first,
    counting each skip; all corrupt -> a clean cold start."""
    base = np.arange(8.0, dtype=np.float32)

    def step(s, batch):
        return s, {"overflow": np.int32(0), "loss": np.float32(0.0)}

    r = side.ft.StepRunner(step, None, side.ft.RunnerConfig(ckpt_dir=tmp, keep=3))
    for s in (1, 2, 3):
        r.ckpt.save(s, {"w": side.asarray(base + s)})
    steps = r.ckpt.available_steps()
    d3 = os.path.join(tmp, "step_00000003")
    fn = [f for f in os.listdir(d3) if f.endswith(".npy")][0]
    with open(os.path.join(d3, fn), "r+b") as f:
        f.seek(70)
        f.write(b"\x00\xff\x00")
    like = {"w": side.asarray(np.zeros(8, np.float32))}
    resumed, start = side.resume(r, like)
    out = {"steps": steps, "start": start, "w": np.asarray(resumed["w"]).tolist()}
    for s in (1, 2):
        os.remove(os.path.join(tmp, f"step_{s:08d}", "manifest.json"))
    out["cold"] = side.resume(r, like)
    return out


def _sigterm(side, tmp):
    """The SIGTERM path: the handler flushes a synchronous checkpoint of
    the state in flight; a fresh runner resumes it bit-exactly."""
    def step(s, batch):
        return ({"v": s["v"] + side.asarray(batch["tokens"]).sum()},
                {"overflow": np.int32(0), "loss": np.float32(0.0)})

    cfg = side.DataConfig(vocab=50, global_batch=2, seq_len=4)
    r = side.ft.StepRunner(step, None, side.ft.RunnerConfig(ckpt_dir=tmp, ckpt_every=1000),
                           pipeline=side.DataPipeline(cfg))
    state, _ = r.train({"v": side.asarray(0)}, num_steps=5, log_every=0,
                       log_fn=lambda *_: None)
    before = r.ckpt.latest_step()
    r._on_sigterm(signal.SIGTERM, None)  # the eviction notice
    r2 = side.ft.StepRunner(step, None, side.ft.RunnerConfig(ckpt_dir=tmp),
                            pipeline=side.DataPipeline(cfg))
    resumed, start = side.resume(r2, {"v": side.asarray(0)})
    state2, _ = r2.train(resumed, start_step=start, num_steps=1, log_every=0,
                         log_fn=lambda *_: None)
    want = side.value(state["v"]) + int(np.asarray(
        side.DataPipeline(cfg).batch_at(5)["tokens"]).sum())
    return {"before": before, "stop": r._stop, "after": r.ckpt.latest_step(),
            "start": start, "resumed": side.value(resumed["v"]), "v": side.value(state["v"]),
            "v2": side.value(state2["v"]), "want": want}


SCENARIOS = {"retry_on_overflow": _retry, "straggler": _straggler,
             "train_and_resume": _train_resume, "heartbeat": _heartbeat,
             "resume_falls_back_over_corrupt_checkpoints": _corrupt_fallback,
             "sigterm_flush_and_bitexact_resume": _sigterm}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_runner_scenario_matches_the_reference(name, tmp_path):
    got = SCENARIOS[name](PORT, str(tmp_path / "port"))
    want = SCENARIOS[name](REF, str(tmp_path / "ref"))
    assert got == want
    got_obs, want_obs = _obs_outcome(PORT), _obs_outcome(REF)
    if name == "straggler":
        for o in (got_obs, want_obs):
            assert o["counters"].pop("train_stragglers_total")[""] >= 1
    assert got_obs == want_obs
    if name == "retry_on_overflow":
        # r: one step, one fallback; r2: a step and two retries on itself;
        # r3: a step
        assert got["calls"] == {"main": 5, "fb": 1} and got["v"] == 1
        assert got["retries"] == (1, 1, 2, 1) and got["overflow2"] == 1
        assert got_obs["counters"]["train_retries_total"] == {"": 4}
        assert got_obs["spans"].count(("train:retry", "i")) == 4
    elif name == "straggler":
        assert got["slow"] and got["caught"] and got["n_times"] == 11
        assert got_obs["hist"]["train_step_seconds"] == {"": 11}
    elif name == "train_and_resume":
        assert got["start"] == 7 and got["on_disk"] == (6, 3)
        assert got["pipe_step"] == {"step": 7}
        assert got_obs["spans"].count(("train:checkpoint", "X")) == 2
    elif name == "heartbeat":
        assert got["step"] == 1 and not got["tmp_left"]
    elif name == "resume_falls_back_over_corrupt_checkpoints":
        assert got["start"] == 3 and got["w"] == list(np.arange(8.0) + 2)
        assert got["cold"] == (None, 0)
        # step 3 skipped once, then steps 3, 2 and 1 on the cold start
        assert got_obs["counters"]["ckpt_resume_fallbacks_total"] == {"": 4}
    elif name == "sigterm_flush_and_bitexact_resume":
        assert got["before"] is None and got["after"] == 4 and got["stop"]
        assert got["start"] == 5 and got["resumed"] == got["v"] and got["v2"] == got["want"]


def test_heartbeat_atomic_write_and_age(tmp_path):
    hb = str(tmp_path / "hb.json")
    assert ft.heartbeat_age(hb) is None  # missing file: no liveness signal
    ft.write_heartbeat(hb, 42)
    assert not os.path.exists(hb + ".tmp")
    with open(hb) as f:
        assert json.load(f)["step"] == 42
    age = ft.heartbeat_age(hb)
    assert age is not None and 0.0 <= age < 30.0
    assert jft.heartbeat_age(hb) is not None  # the reference reads the port's file
    with open(hb, "w") as f:
        f.write('{"step": 4')
    assert ft.heartbeat_age(hb) is None and jft.heartbeat_age(hb) is None
    ft.write_heartbeat(hb, 43)  # re-publishing over garbage heals it
    assert ft.heartbeat_age(hb) is not None


def test_runner_config_defaults_match_the_reference():
    assert dataclasses.asdict(RunnerConfig()) == dataclasses.asdict(jft.RunnerConfig())


def test_sigterm_handler_is_installed_and_restored(tmp_path):
    was = signal.getsignal(signal.SIGTERM)
    try:
        r = StepRunner(lambda s, b: (s, {"overflow": 0, "loss": 0.0}), None,
                       RunnerConfig(ckpt_dir=str(tmp_path), install_sigterm=True))
        assert signal.getsignal(signal.SIGTERM) == r._on_sigterm
    finally:
        signal.signal(signal.SIGTERM, was)


# ---------------------------------------------------------------------------
# the launcher through its StepRunner
# ---------------------------------------------------------------------------

def _plain_loop(steps: int, *, compress: bool = True) -> tuple:
    """The launcher's loop before it ran through the StepRunner: a zero1
    plan and ``train_step`` a step, the raw plan's step on overflow."""
    cfg = configs.get_smoke(ARCH)
    tcfg = step_lib.TrainConfig(
        loss_chunk=SEQ, policy=CompressionPolicy(min_bytes=0) if compress
        else CompressionPolicy.disabled(), optim=OptimConfig(lr=LR, warmup_steps=WARMUP))
    raw_tcfg = dataclasses.replace(tcfg, policy=CompressionPolicy.disabled())
    state = step_lib.build_train_state(cfg, tcfg, generator=torch.Generator().manual_seed(0),
                                       device="cpu")
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, global_batch=BATCH, seq_len=SEQ))
    cache, losses, retries = PlanCache(), [], 0
    with launch_train.deterministic():
        for s in range(steps):
            b = pipe.tensors_at(s, "cpu")
            m = step_lib.train_step(state, b, tcfg,
                                    plan=step_lib.zero1_plan(state, tcfg, cache=cache))
            if m["overflow"]:
                retries += 1
                m = step_lib.train_step(state, b, raw_tcfg,
                                        plan=step_lib.zero1_plan(state, raw_tcfg, cache=cache))
            losses.append(float(m["loss"]))
    return losses, state, retries


def _train(**kw):
    return launch_train.train(ARCH, batch=BATCH, seq=SEQ, smoke=True, device="cpu", lr=LR,
                              warmup=WARMUP, **kw)


def test_launcher_losses_equal_the_plain_step_loop():
    with launch_train.single_process_group("cpu"):
        run = _train(steps=2)
        snap = obs.snapshot()
        losses, state, retries = _plain_loop(2)
    assert run.losses == losses and run.retries == retries == 0
    assert bits_equal(run.state.model.tree(), state.model.tree())
    assert bits_equal(run.state.opt, state.opt) and run.state.step == state.step == 2
    assert len(run.step_ms) == 2 and run.runner.stragglers == 0
    assert snap["histograms"]["train_step_seconds"][""]["count"] == 2
    assert snap["counters"]["plan_exec_total"] == {"kind=zero1": 2}


def test_launcher_overflow_retries_equal_the_plain_step_loop(monkeypatch):
    monkeypatch.setattr(CompressionProfile, "default", staticmethod(
        lambda dtype_name="bfloat16": CompressionProfile(
            widths={"gradient": 1, "weight": 1}, exc_frac=1e-9)))
    with launch_train.single_process_group("cpu"):
        run = _train(steps=2)
        losses, state, retries = _plain_loop(2)
    assert run.losses == losses and run.retries == retries == 2
    assert bits_equal(run.state.model.tree(), state.model.tree())
    assert obs.snapshot()["counters"]["train_retries_total"] == {"": 2}
    assert [s.name for s in obs.spans()].count("train:retry") == 2


def test_train_state_checkpoint_round_trip(tmp_path):
    """The runner's async checkpoint of a ZeRO-1 train state restores
    bit-identical (parameters, optimizer shard, step), and a step from the
    restored state equals the same step from the live one."""
    rcfg = RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=1,
                        heartbeat_path=str(tmp_path / "hb.json"))
    with launch_train.single_process_group("cpu") as group:
        run = _train(steps=2, rcfg=rcfg)
        assert run.runner.ckpt.available_steps() == (1,)
        assert json.load(open(tmp_path / "hb.json"))["step"] == 1
        restored, start = run.runner.try_resume(run.state, device="cpu")
        assert start == 2 and restored.step == run.state.step == 2
        assert bits_equal(restored.tree(), run.state.tree())
        assert restored.model is not run.state.model
        b = DataPipeline(DataConfig(vocab=configs.get_smoke(ARCH).vocab, global_batch=BATCH,
                                    seq_len=SEQ)).tensors_at(2, "cpu")
        with launch_train.deterministic():
            m_live = step_lib.train_step(run.state, b, run.tcfg, group=group)
            m_rest = step_lib.train_step(restored, b, run.tcfg, group=group)
    assert float(m_live["loss"]) == float(m_rest["loss"])
    assert bits_equal(restored.tree(), run.state.tree())
    assert [s.name for s in obs.spans()].count("train:checkpoint") == 1


def test_launcher_resume_continues_the_uninterrupted_run(tmp_path):
    with launch_train.single_process_group("cpu"):
        full = _train(steps=4)
        first = _train(steps=2, rcfg=RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=1))
        rest = _train(steps=2, rcfg=RunnerConfig(ckpt_dir=str(tmp_path)), resume=True)
    assert rest.start_step == 2
    assert first.losses + rest.losses == full.losses
    assert bits_equal(rest.state.tree(), full.state.tree())


def test_launch_cli_checkpoints_heartbeat_and_resume(tmp_path, capsys):
    args = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1",
            "--heartbeat", str(tmp_path / "hb.json")]
    launch_train.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "stragglers 0 | retries 0 | compressed=True" in out
    assert sorted(os.listdir(tmp_path / "ck")) == ["latest", "step_00000001"]
    assert json.load(open(tmp_path / "hb.json"))["step"] == 1
    launch_train.main(args + ["--steps", "1", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step      2 loss" in out
