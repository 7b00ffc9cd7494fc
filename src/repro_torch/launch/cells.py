"""The (architecture × input-shape) grid: 40 cells (torch port of
``repro.launch.cells``, over the port's ``configs``).

Shapes:
  train_4k     seq 4,096   global_batch 256  — train_step
  prefill_32k  seq 32,768  global_batch 32   — prefill (forward + cache fill)
  decode_32k   seq 32,768  global_batch 128  — serve_step (1 token, KV cache)
  long_500k    seq 524,288 global_batch 1    — long-context decode
                                               (sub-quadratic archs only)

Skips: ``long_500k`` runs only for the SSM/hybrid archs (xlstm, jamba);
the 8 full-attention archs skip it.
All archs decode (whisper is enc-dec; its decoder decodes), so
prefill/decode cells run everywhere.  32 live cells + 8 documented skips.

Per-arch training knobs: partition (fsdp for the three archs whose params
exceed ZeRO-1 replication at model=16), optimizer (adafactor for
deepseek-v3: AdamW states don't fit), microbatches (keeps the remat'd
activation carry in device memory).  ``roofline/model.analytic_cost`` and
``roofline/analysis.model_flops_for`` read the shapes and knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch import configs


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

LONG_OK = {"xlstm_350m", "jamba_v0_1_52b"}  # sub-quadratic archs

# training knobs per arch: (partition, optimizer, microbatches[, dp_only])
# dp_only=True marks the archs whose d_model is too small for tensor
# parallelism at model=16 (smollm, xlstm), trained data-parallel only.
TRAIN_KNOBS = {
    "tinyllama_1_1b": ("zero1", "adamw", 2),
    "mistral_nemo_12b": ("zero1", "adamw", 4),
    "gemma3_27b": ("zero1", "adamw", 8),
    "smollm_135m": ("zero1", "adamw", 1, True),
    "xlstm_350m": ("zero1", "adamw", 1, True),
    "qwen2_vl_72b": ("fsdp", "adamw", 8),
    "deepseek_v2_lite_16b": ("zero1", "adamw", 4),
    "deepseek_v3_671b": ("fsdp", "adafactor", 8),  # §Perf: 16→8 microbatches
    "jamba_v0_1_52b": ("fsdp", "adamw", 8),
    "whisper_small": ("zero1", "adamw", 1),
    "glm4_9b": ("zero1", "adamw", 2),
}


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: Shape
    skip: Optional[str] = None  # reason, if skipped

    @property
    def name(self) -> str:
        return f"{self.arch}:{self.shape.name}"


def all_cells(include_glm: bool = False):
    archs = [a for a in configs.ARCHS if include_glm or a != "glm4_9b"]
    cells = []
    for a in archs:
        for sname, shape in SHAPES.items():
            skip = None
            if sname == "long_500k" and a not in LONG_OK:
                skip = "full-attention arch: 500k decode needs sub-quadratic attention"
            cells.append(Cell(a, shape, skip))
    return cells


def live_cells(include_glm: bool = False):
    return [c for c in all_cells(include_glm) if c.skip is None]
