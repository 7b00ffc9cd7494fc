"""Width calibration for the static in-collective codec (paper §3.4);
torch port of ``repro.core.calibrate``.

The packed width ``W`` and the exception capacity are chosen from observed
exponent statistics (:func:`choose_width`, the host ``Compressor``'s probe
when no plan gives the width; :func:`choose_delta_widths` for the XOR-delta
wire; :func:`calibrate_tree` for a tree of live tensors) or taken from a
:class:`CompressionProfile`.
The in-wire ``overflow`` flag catches a width that turned out too small.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import codec, packing
from repro_torch.tree_util import tree_leaves


@dataclasses.dataclass(frozen=True)
class WidthChoice:
    width: int
    exc_frac: float
    est_exc_rate: float  # fraction of blocks expected to escape
    est_ratio: float  # predicted wire ratio vs raw
    entropy_bits: float  # ANS floor for reference


def block_range_stats(x: torch.Tensor, block: int = 512) -> torch.Tensor:
    """Per-block max code values under the zero-escape mapping (int32):
    ``max_nz - min_nz + 1`` over nonzero exponents (0 for all-zero blocks).
    A block packs losslessly at width W iff its stat < 2**W."""
    exp, _ = codec.split_planes(x)
    b = packing._pad_to(exp, block).reshape(-1, block).to(torch.int32)
    nz = b != 0
    base = torch.where(nz, b, 255).amin(-1)
    mx = torch.where(nz, b, 0).amax(-1)
    return torch.where(nz.any(-1), mx - base + 1, 0).to(torch.int32)


def width_cost_curve(x: torch.Tensor, *, block: int = 512,
                     max_exc_frac: float = 0.02) -> tuple:
    """One :class:`WidthChoice` per candidate exponent width ``1..exp_bits``
    (escape rate and wire ratio at that width)."""
    lay = codec.layout_of(x.dtype)
    rngs = block_range_stats(x, block=block).cpu().numpy()
    exp, _ = codec.split_planes(x)
    ent = float(codec.exponent_entropy_bits(exp, lay.exp_bits))
    n_blocks = len(rngs)
    cap = packing.exception_capacity(n_blocks, max_exc_frac)
    curve = []
    for w in range(1, lay.exp_bits + 1):
        ratio = (
            lay.lo_bits
            + w
            + 8.0 / block  # bases
            + (cap * (4 + block) * 8.0) / (n_blocks * block)  # exceptions
        ) / lay.total_bits
        curve.append(WidthChoice(
            width=w,
            exc_frac=max_exc_frac,
            est_exc_rate=float(np.mean(rngs >= (1 << w))),
            est_ratio=ratio,
            entropy_bits=ent,
        ))
    return tuple(curve)


def choose_width(x: torch.Tensor, *, block: int = 512,
                 target_exc_rate: float = 1e-3, margin_bits: int = 0,
                 max_exc_frac: float = 0.02) -> WidthChoice:
    """Smallest W whose expected escape rate stays under target, plus
    ``margin_bits`` of headroom for drift (capped at the exponent width)."""
    curve = width_cost_curve(x, block=block, max_exc_frac=max_exc_frac)
    for c in curve:
        if c.est_exc_rate <= target_exc_rate or c.width == curve[-1].width:
            return curve[min(c.width + margin_bits, curve[-1].width) - 1]
    raise AssertionError("unreachable: the last width always matches")


def choose_delta_widths(x: torch.Tensor, base: torch.Tensor, *, block: int = 512,
                        target_exc_rate: float = 1e-3,
                        max_exc_frac: float = 0.02) -> tuple:
    """Calibrate the XOR-delta wire's ``(exp_width, lo_width)`` from two
    consecutive weight versions (or representative twins), on their device.

    The exponent-delta width is :func:`choose_width` of the delta's bit
    pattern; the lo width is the smallest W whose per-ELEMENT escape rate
    stays under half the exception capacity (the lo packer escapes per
    element).  Store the result in ``CompressionProfile.widths["delta"]`` and
    ``["delta_lo"]`` to drive ``CompressionPolicy.delta_widths``."""
    lay = codec.layout_of(x.dtype)
    d = codec.xor_delta(x.reshape(-1), base.reshape(-1))
    w_exp = choose_width(d, block=block, target_exc_rate=target_exc_rate,
                         max_exc_frac=max_exc_frac).width
    _, lo = codec.split_planes(d)
    budget = max_exc_frac / 2  # leave half the capacity as drift headroom
    n = lo.shape[0]
    w_lo = lay.lo_bits
    for w in range(1, lay.lo_bits + 1):
        # the count over n is the reference's numpy mean of the escape mask
        if int((lo >= (1 << w)).sum()) / n <= budget:
            w_lo = w
            break
    return int(w_exp), int(w_lo)


@dataclasses.dataclass(frozen=True)
class CompressionProfile:
    """Packed widths per tensor class (paper Table 1: gradients, weights
    and activations have distinct but individually stable distributions).
    The keys ``"delta"`` and ``"delta_lo"``, when present, are the XOR-delta
    wire's widths (:func:`choose_delta_widths`)."""

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


def calibrate_tree(tree, *, tensor_class: str = "gradient", block: int = 512,
                   **kw) -> CompressionProfile:
    """One width for ``tensor_class`` from a tree of live tensors (e.g. the
    first step's gradients): the largest :func:`choose_width` over the
    leaves of a codec format (``kw`` passes on to it), 8 when there is
    none."""
    floats = {lay.dtype for lay in codec.LAYOUTS.values()}
    widths = [choose_width(leaf, block=block, **kw).width
              for leaf in tree_leaves(tree)
              if hasattr(leaf, "dtype") and leaf.dtype in floats]
    w = max(widths) if widths else 8
    return CompressionProfile(widths={tensor_class: w}, block=block)
