"""Float split into exponent and lo planes with per-block plain statistics.

Wrapper of the CUDA kernel ``csrc/plane_split.cu``, the port of the TPU
kernel ``repro/kernels/plane_split.py::_split_kernel``.  A CUDA tensor
launches the kernel (or raises); a CPU tensor runs the plain version
``ref.split_with_stats``.  Any whole number of blocks is taken; a ragged n
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import codec
from repro_torch.core.packing import GROUP
from repro_torch.kernels import ref

plain = ref.split_with_stats

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p)


def split_with_stats(x: torch.Tensor, block: int = 512):
    """x float (n,), n a whole number of blocks, block a multiple of 32 <=
    1024.  Returns (exp int32 (n,), lo int32 (n,), base int32 (n_blocks,),
    rng int32 (n_blocks,)): per block ``base = min(exp)`` and ``rng =
    max(exp) - min(exp)``, bit-identical to :func:`plain`."""
    lay = codec.layout_of(x.dtype)
    n = x.shape[0] if x.dim() == 1 else -1
    if n <= 0 or n % block or block % GROUP or not GROUP <= block <= 1024:
        raise ValueError(f"split_with_stats needs a flat tensor of whole blocks, "
                         f"block a multiple of 32 <= 1024; got shape "
                         f"{tuple(x.shape)}, block={block}")
    if x.device.type == "cpu":
        return plain(x, block)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"split_with_stats takes a contiguous CPU or CUDA tensor, "
                         f"got {x.device} contiguous={x.is_contiguous()}")
    nb = n // block
    exp = torch.empty((n,), dtype=torch.int32, device=x.device)
    lo = torch.empty((n,), dtype=torch.int32, device=x.device)
    base = torch.empty((nb,), dtype=torch.int32, device=x.device)
    rng = torch.empty((nb,), dtype=torch.int32, device=x.device)
    err = kernels.launcher("plane_split", _ARGTYPES)(
        x.data_ptr(), exp.data_ptr(), lo.data_ptr(), base.data_ptr(), rng.data_ptr(),
        n, block, kernels.FORMATS.index(lay.name), kernels.stream_of(x))
    if err:
        raise RuntimeError(f"plane_split launch failed: cudaError {err}")
    kernels.count_launch("plane_split")
    return exp, lo, base, rng
