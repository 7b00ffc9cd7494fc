"""Fault-tolerant training runtime (torch port of
``repro.runtime.fault_tolerance``).

What a long training run needs beyond a correct step function:

  * **overflow retry** — the compressed wires are lossless *unless* the
    static exception capacity overflows, which the step surfaces as a flag
    (the guarded step then kept its old state); the runner re-executes the
    SAME batch with the compression-disabled step.  Numerical correctness
    is therefore unconditional; only that step's speed degrades.
  * **checkpoint/restart** — periodic async checkpoints + automatic resume
    (data pipeline state is one integer, so restart is exact).
  * **straggler detection** — a step slower than ``straggler_factor`` times
    the median of the recent window is counted (and unit-tested through
    injected delays).
  * **preemption** — SIGTERM flushes a synchronous checkpoint before the
    loop stops.
  * **heartbeat** — liveness file for an external watchdog.

The state is anything ``checkpoint.manager.CheckpointManager`` saves: a tree
of tensors, or a ``train.step.TrainState`` (saved through its ``tree()``).
The overflow flag is read on the host once a step, as the reference's
``int(np.asarray(metrics["overflow"]))`` does, so the ``train:step`` span
covers the step's device work.  The reference's ``ElasticController``
(re-placement onto another mesh) comes with ``launch/mesh.py``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager


def write_heartbeat(path: str, step: int) -> None:
    """Atomically publish a liveness file: tmp + ``os.replace``, the same
    pattern as the trace exporter — a watchdog that reads mid-write must
    see the previous heartbeat, never a truncated JSON."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "t": time.time()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def heartbeat_age(path: str) -> Optional[float]:
    """Seconds since the heartbeat at ``path`` was written, or None when
    it is missing or unreadable — the watchdog-side liveness probe
    (age > threshold means the runner is wedged or gone)."""
    try:
        with open(path) as f:
            return max(time.time() - float(json.load(f)["t"]), 0.0)
    except (OSError, ValueError, KeyError, TypeError):
        return None


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0  # step > factor * median -> straggler
    straggler_window: int = 32
    heartbeat_path: Optional[str] = None
    max_retries_per_step: int = 2
    install_sigterm: bool = False


class StepRunner:
    """Drives a train step with retry/checkpoint/straggler logic.

    ``step_fn(state, batch) -> (state, metrics)`` is the compressed step;
    ``fallback_fn`` the compression-disabled twin.  ``metrics`` must contain
    an ``overflow`` int (0 = clean).  :meth:`train` hands the step the
    pipeline's batch as CPU int tensors; the step moves it to its device."""

    def __init__(self, step_fn: Callable, fallback_fn: Optional[Callable],
                 rcfg: RunnerConfig, *, pipeline=None):
        self.step_fn = step_fn
        self.fallback_fn = fallback_fn
        self.rcfg = rcfg
        self.pipeline = pipeline
        self.ckpt = CheckpointManager(rcfg.ckpt_dir, keep=rcfg.keep)
        self.times: list = []
        self.stragglers = 0
        self.retries = 0
        self._stop = False
        if rcfg.install_sigterm:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        self._state_for_preempt = None
        self._step_for_preempt = 0

    def _on_sigterm(self, signum, frame):
        # preemption: flush a synchronous checkpoint, then stop the loop
        if self._state_for_preempt is not None:
            self.ckpt.wait()
            self.ckpt.save(self._step_for_preempt, self._state_for_preempt)
        self._stop = True

    def _heartbeat(self, step: int):
        if self.rcfg.heartbeat_path:
            write_heartbeat(self.rcfg.heartbeat_path, step)

    def _check_straggler(self, dt: float) -> bool:
        self.times.append(dt)
        w = self.times[-self.rcfg.straggler_window:]
        if len(w) < 8:
            return False
        med = float(np.median(w[:-1]))
        if dt > self.rcfg.straggler_factor * med:
            self.stragglers += 1
            return True
        return False

    def run_step(self, state, batch):
        """One fault-tolerant step.  Returns (state, metrics dict)."""
        # the step time stays perf_counter-based (it feeds the straggler
        # check even with obs off); the train:step span mirrors the same
        # interval onto the trace, retries included
        with obs.span("train:step") as sp:
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            overflow = int(metrics["overflow"])
            tries = 0
            while overflow != 0 and tries < self.rcfg.max_retries_per_step:
                # the guarded step kept its old state; redo uncompressed
                self.retries += 1
                tries += 1
                obs.instant("train:retry", attempt=tries)
                obs.metric("train_retries_total").inc()
                if self.fallback_fn is None:
                    break
                state, metrics = self.fallback_fn(state, batch)
                overflow = int(metrics["overflow"])
            dt = time.perf_counter() - t0
            sp.args["retries"] = tries
        metrics = dict(metrics)
        metrics["step_time_s"] = dt
        metrics["straggler"] = self._check_straggler(dt)
        metrics["retries"] = tries
        obs.metric("train_step_seconds").observe(dt)
        if metrics["straggler"]:
            obs.metric("train_stragglers_total").inc()
        return state, metrics

    def train(self, state, *, start_step: int = 0, num_steps: int = 100,
              log_every: int = 10, log_fn=print):
        step = start_step
        history = []
        while step < start_step + num_steps and not self._stop:
            batch = {k: torch.from_numpy(np.asarray(v))
                     for k, v in self.pipeline.batch_at(step).items()}
            state, metrics = self.run_step(state, batch)
            self._state_for_preempt = state
            self._step_for_preempt = step
            self._heartbeat(step)
            history.append(float(metrics["loss"]))
            if step % self.rcfg.ckpt_every == 0 and step > start_step:
                with obs.span("train:checkpoint", step=step):
                    self.ckpt.save_async(step, state)
            if log_every and step % log_every == 0:
                log_fn(f"step {step:6d} loss {history[-1]:.4f} "
                       f"t {metrics['step_time_s']*1e3:.0f}ms "
                       f"retries {metrics['retries']}")
            step += 1
        self.ckpt.wait()
        return state, history

    # -- restart ---------------------------------------------------------------

    def try_resume(self, state_like, *, device="cuda"):
        """Resume from the newest restorable checkpoint, its tensors on
        ``device``.

        A corrupt latest checkpoint (failed sha256, truncated npy,
        mangled manifest — e.g. a disk fault after the atomic rename)
        must not strand the job: the restore falls back through the
        retained older checkpoints newest-first, counting each skip
        (``ckpt_resume_fallbacks_total``), and only reports a cold start
        when every retained checkpoint is unusable."""
        for s in self.ckpt.available_steps():
            try:
                state, step = self.ckpt.restore(state_like, step=s, device=device)
            except (OSError, ValueError, KeyError, EOFError):
                obs.metric("ckpt_resume_fallbacks_total").inc()
                obs.instant("train:resume_fallback", step=s)
                continue
            if self.pipeline is not None:
                self.pipeline.skip_to(step + 1)
            return state, step + 1
        return None, 0
