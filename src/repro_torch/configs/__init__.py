"""Architecture registry (torch port of ``repro.configs``: the reference's
eleven architectures, in its order).  ``get(name)`` returns the full
ArchConfig, ``get_smoke(name)`` a reduced same-family config."""
from __future__ import annotations

import importlib

ARCHS = [
    "tinyllama_1_1b",
    "mistral_nemo_12b",
    "gemma3_27b",
    "smollm_135m",
    "xlstm_350m",
    "qwen2_vl_72b",
    "deepseek_v2_lite_16b",
    "deepseek_v3_671b",
    "jamba_v0_1_52b",
    "whisper_small",
    "glm4_9b",
]

ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; have {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def list_archs():
    return list(ARCHS)
