"""Deterministic, resumable data pipeline (torch port of
``repro.data.pipeline``, synthetic backend).

Batch ``t`` is a pure function of ``(seed, t, process_index)``: numpy's
``SeedSequence`` spawns an independent stream per step, and Zipf-distributed
tokens match the skewed statistics real corpora feed the codec.  The numpy
batches are identical to the reference's for the same config.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import kernels


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    kind: str = "synthetic"  # synthetic (the file backend is not ported)
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
        if cfg.kind != "synthetic":
            raise NotImplementedError(f"data backend {cfg.kind!r} is not ported")
        if cfg.global_batch % process_count:
            raise ValueError(f"global_batch={cfg.global_batch} does not split "
                             f"over {process_count} processes")
        self.cfg = cfg
        self.process_index = process_index
        self.local_batch = cfg.global_batch // process_count
        self._step = 0
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_a)
        self._cdf = np.cumsum(w / w.sum())

    def _rng_for(self, step: int) -> np.random.Generator:
        ss = np.random.SeedSequence(entropy=self.cfg.seed,
                                    spawn_key=(step, self.process_index))
        return np.random.default_rng(ss)

    def batch_at(self, step: int) -> dict:
        b, S = self.local_batch, self.cfg.seq_len
        u = self._rng_for(step).random((b, S + 1))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        np.clip(toks, 0, self.cfg.vocab - 1, out=toks)
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

    def skip_to(self, step: int) -> None:
        self._step = int(step)
