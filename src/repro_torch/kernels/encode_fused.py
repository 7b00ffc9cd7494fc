"""Fused transmit-side encode: split + zero-escape stats + bit-plane pack.

Wrapper of the CUDA kernel ``csrc/encode_fused.cu``, the port of the TPU
kernel ``repro/kernels/encode_fused.py::_encode_kernel``.  A CUDA tensor
launches the kernel (or raises); a CPU tensor runs the plain version
``ref.encode_fused``.  One thread block per compression block, so the
input needs no tile padding beyond the block multiple.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import codec
from repro_torch.core.packing import GROUP
from repro_torch.kernels import ref

plain = ref.encode_fused

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def encode_fused(x: torch.Tensor, width: int, block: int = 512):
    """x float (n,), n % block == 0, block % 32 == 0 and <= 1024,
    1 <= width <= 32.  Returns (payload int32 (n//32, width), lo_planes
    int32 (n//32, lo_bits), bases int32 (n_blocks,), rng int32 (n_blocks,))
    bit-identical to :func:`plain`."""
    lay = codec.layout_of(x.dtype)
    n = x.shape[0] if x.dim() == 1 else -1
    if not 0 < n < 2**31 or n % block or block % GROUP or not GROUP <= block <= 1024:
        raise ValueError(f"encode_fused needs a flat tensor with 0 < n < 2**31, "
                         f"n % block == 0 and block a multiple of 32 <= 1024; "
                         f"got shape {tuple(x.shape)}, block={block}")
    if not 1 <= width <= 32:
        raise ValueError(f"width must be in [1, 32], got {width}")
    if x.device.type == "cpu":
        return plain(x, width, block)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"encode_fused takes a contiguous CPU or CUDA tensor, "
                         f"got {x.device} contiguous={x.is_contiguous()}")
    n_g, nb = n // GROUP, n // block
    pay = torch.empty((n_g, width), dtype=torch.int32, device=x.device)
    lo = torch.empty((n_g, lay.lo_bits), dtype=torch.int32, device=x.device)
    bases = torch.empty((nb,), dtype=torch.int32, device=x.device)
    rng = torch.empty((nb,), dtype=torch.int32, device=x.device)
    launch = kernels.launcher("encode_fused", _ARGTYPES)
    err = launch(x.data_ptr(), pay.data_ptr(), lo.data_ptr(), bases.data_ptr(),
                 rng.data_ptr(), n, block, width,
                 kernels.FORMATS.index(lay.name), kernels.stream_of(x))
    if err:
        raise RuntimeError(f"encode_fused launch failed: cudaError {err}")
    kernels.count_launch("encode_fused")
    return pay, lo, bases, rng
