"""Deterministic, resumable data pipeline (torch port of
``repro.data.pipeline``).

Batch ``t`` is a pure function of ``(seed, t, process_index)``: numpy's
``SeedSequence`` spawns an independent stream per step.  Two backends:
``synthetic`` (Zipf-distributed tokens, matching the skewed statistics real
corpora feed the codec) and ``file`` (a memory-mapped token file of raw
uint16, or uint32 when the vocabulary passes 65535, read at random starts).
The numpy batches are identical to the reference's for the same config and
file.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import kernels


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    kind: str = "synthetic"  # synthetic | file
    path: Optional[str] = None  # token file (uint16/uint32 raw) for kind=file
    zipf_a: float = 1.3  # synthetic token skew (Zipf exponent)


class DataPipeline:
    """Stateless-deterministic LM batch source.

    ``batch_at(step)`` returns this process's slice of the global batch as
    numpy ``{"tokens": (b, S) int32, "labels": (b, S) int32}``, ``labels``
    the next-token shift of ``tokens``; ``tensors_at(step, device)`` the same
    as int64 tensors on ``device``.  Iterating yields the batches from the
    pipeline's position on, which ``state_dict`` reads and ``skip_to`` moves
    (a resumed run skips to the step after its checkpoint)."""

    def __init__(self, cfg: DataConfig, *, process_index: int = 0,
                 process_count: int = 1):
        if cfg.kind not in ("synthetic", "file"):
            raise ValueError(f"unknown data backend {cfg.kind!r}")
        if cfg.global_batch % process_count:
            raise ValueError(f"global_batch={cfg.global_batch} does not split "
                             f"over {process_count} processes")
        self.cfg = cfg
        self.process_index = process_index
        self.local_batch = cfg.global_batch // process_count
        self._step = 0
        self._mmap = None
        if cfg.kind == "file":
            if not cfg.path or not os.path.exists(cfg.path):
                raise FileNotFoundError(cfg.path)
            dtype = np.uint32 if cfg.vocab > 65535 else np.uint16
            self._mmap = np.memmap(cfg.path, dtype=dtype, mode="r")
            if len(self._mmap) < cfg.seq_len + 1:
                raise ValueError("token file shorter than one sequence")
        else:
            ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
            w = ranks ** (-cfg.zipf_a)
            self._cdf = np.cumsum(w / w.sum())

    def _rng_for(self, step: int) -> np.random.Generator:
        ss = np.random.SeedSequence(entropy=self.cfg.seed,
                                    spawn_key=(step, self.process_index))
        return np.random.default_rng(ss)

    def batch_at(self, step: int) -> dict:
        """A file of exactly ``S + 1`` tokens raises ValueError here, as in
        the reference: its starts are drawn from ``[0, n - S - 1)``."""
        b, S = self.local_batch, self.cfg.seq_len
        rng = self._rng_for(step)
        if self._mmap is None:
            u = rng.random((b, S + 1))
            toks = np.searchsorted(self._cdf, u).astype(np.int32)
            np.clip(toks, 0, self.cfg.vocab - 1, out=toks)
        else:
            starts = rng.integers(0, len(self._mmap) - S - 1, size=(b,))
            toks = np.stack([np.asarray(self._mmap[s:s + S + 1])
                             for s in starts]).astype(np.int32)
        return {"tokens": toks[:, :S], "labels": toks[:, 1:]}

    def tensors_at(self, step: int, device="cuda") -> dict:
        dev = kernels.resolve_device(device)
        return {k: torch.from_numpy(v.astype(np.int64)).to(dev)
                for k, v in self.batch_at(step).items()}

    # -- iterator / checkpoint protocol ------------------------------------

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self.batch_at(self._step)
            self._step += 1  # before yield: state_dict() is always exact
            yield b

    def state_dict(self) -> dict:
        return {"step": self._step}

    def load_state_dict(self, state: dict) -> None:
        self._step = int(state["step"])

    def skip_to(self, step: int) -> None:
        self._step = int(step)
