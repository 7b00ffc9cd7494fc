"""Architecture registry (torch port of ``repro.configs``; only the
architectures whose layers are ported).  ``get(name)`` returns the full
ArchConfig, ``get_smoke(name)`` a reduced same-family config."""
from __future__ import annotations

import importlib

ARCHS = ["smollm_135m"]

ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise ValueError(f"architecture {name!r} is not ported; have {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE
