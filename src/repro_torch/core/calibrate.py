"""Calibrated wire parameters per tensor class (torch port of
``repro.core.calibrate``; only :class:`CompressionProfile` so far)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CompressionProfile:
    """Packed widths per tensor class (paper Table 1: gradients, weights
    and activations have distinct but individually stable distributions)."""

    widths: dict  # class name -> width
    block: int = 512
    exc_frac: float = 0.02
    # extra exponent-width headroom for the all-gather phase of the two-shot
    ag_extra_bits: int = 0

    @staticmethod
    def default(dtype_name: str = "bfloat16") -> "CompressionProfile":
        base = {"bfloat16": 5, "float32": 5, "float16": 4,
                "float8_e4m3fn": 4, "float8_e5m2": 4}[dtype_name]
        return CompressionProfile(
            widths={"gradient": base, "weight": base, "activation": base})

    def width_for(self, tensor_class: str) -> int:
        return self.widths.get(tensor_class, max(self.widths.values()))
