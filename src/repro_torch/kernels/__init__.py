"""CUDA kernels for Hopper: build, load, launch accounting, device probe.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface (the persistent kernels share the headers ``csrc/staging.cuh``
and ``csrc/bitplane.cuh``).
At first use, :func:`build_kernels` compiles every source that is not yet
built with its own ``nvcc`` (all started together) into a shared
library under ``build/``, keyed by a hash of the source and the flags, and
:func:`launcher` loads it with ``ctypes``.  A source may hold several
kernels (``bitpack.cu``: pack and unpack; ``rans.cu``: encode and decode);
kernel ``name`` is the C function ``<name>_launch`` of source
``KERNELS[name]``.  The Python wrapper of each kernel (``encode_fused.py``,
``decode_reduce.py``, ``bitpack.py``, ``rans.py``, ``plane_split.py``)
launches it on a CUDA
tensor and uses the kernel's plain PyTorch version (``ref.py``) on a CPU
tensor; there is no switch that turns a kernel off and no fallback that
hides a failed build or launch.

Every launch adds one to the kernel's count (:func:`launch_counts`), so a
run can show that its main path went through the kernels; a wrapper whose
kernel runs at several shapes on the paths also tallies each launch under
its shape (:func:`launch_shapes`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily

SOURCES = {
    "encode_fused": "encode_fused.cu",
    "decode_reduce": "decode_reduce.cu",
    "bitpack": "bitpack.cu",
    "rans": "rans.cu",
    "plane_split": "plane_split.cu",
}
# kernel -> the source (key of SOURCES) that holds its launcher
KERNELS = {
    "encode_fused": "encode_fused",
    "decode_reduce": "decode_reduce",
    "pack": "bitpack",
    "unpack": "bitpack",
    "rans_encode": "rans",
    "rans_decode": "rans",
    "plane_split": "plane_split",
}
# Codec format index shared with the ``switch`` of every launcher in csrc/.
FORMATS = ("float32", "float16", "bfloat16", "float8_e4m3fn", "float8_e5m2")

# Hopper (sm_90) limits that a persistent kernel's grid is sized by: the
# shared memory of an SM and of a thread block (227 KB, above 48 KB only as
# dynamic shared memory), the shared bytes the card reserves per thread
# block and its unit of allocation, resident threads and thread blocks an SM.
# :func:`sm_count` checks the ones the card reports.
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
SMEM_RESERVED = 1024
SMEM_UNIT = 128
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32
# Threads a thread block of the persistent kernels: encode_fused at most
# (a warp a compression block); pack, unpack and decode_reduce always (4
# values a thread, so 32 groups a pass).  decode_reduce holds a tile's
# accumulator in registers, so its tiles have at most DECODE_REDUCE_MAX_TILE
# groups (two passes).  nvcc gets them as -D defines, so the sources hold
# no copy.
ENCODE_FUSED_THREADS = 256
PACK_THREADS = 256
UNPACK_THREADS = 256
DECODE_REDUCE_THREADS = 256
DECODE_REDUCE_MAX_TILE = 64

# No fast-math and no flush-to-zero: the f32 accumulate keeps subnormals.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              f"-DSM_THREADS={THREADS_PER_SM}",
              f"-DENCODE_FUSED_THREADS={ENCODE_FUSED_THREADS}",
              f"-DPACK_THREADS={PACK_THREADS}",
              f"-DUNPACK_THREADS={UNPACK_THREADS}",
              f"-DDECODE_REDUCE_THREADS={DECODE_REDUCE_THREADS}",
              f"-DDECODE_REDUCE_MAX_TILE={DECODE_REDUCE_MAX_TILE}")

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

_LIBS: dict = {}
_LAUNCHES = {name: 0 for name in KERNELS}
_SHAPES: dict = {}  # (kernel, shape) -> launches


# ---------------------------------------------------------------------------
# launch accounting
# ---------------------------------------------------------------------------

def count_launch(name: str, shape=None) -> None:
    """Called by a wrapper right after it launched kernel ``name``; a
    ``shape`` (any hashable key, e.g. dtype, length and width) is tallied
    too."""
    _LAUNCHES[name] += 1
    if shape is not None:
        _SHAPES[name, shape] = _SHAPES.get((name, shape), 0) + 1


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def launch_shapes(name: str) -> dict:
    """``{shape: launches}`` of kernel ``name`` since the counts were cleared."""
    return {shape: n for (k, shape), n in _SHAPES.items() if k == name}


def clear_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
    _SHAPES.clear()


# ---------------------------------------------------------------------------
# device probe
# ---------------------------------------------------------------------------

def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``cuda`` (the default) raises
    when no GPU is present instead of carrying on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current CUDA stream on ``t``'s device: the
    ``cuda_stream`` of ``torch.cuda.current_stream(t.device)``, read without
    building a Stream object (a wrapper's host time is most of a launch at
    small sizes)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA ``device`` (a tensor's device
    with its index, or the index, ``t.get_device()``).  Raises if the
    card's per-SM limits are not the ones :func:`resident_blocks` sizes
    persistent grids by."""
    p = torch.cuda.get_device_properties(device)
    card = (p.shared_memory_per_multiprocessor, p.shared_memory_per_block_optin,
            p.max_threads_per_multi_processor)
    if card != (SMEM_PER_SM, SMEM_PER_BLOCK, THREADS_PER_SM):
        raise RuntimeError(f"{p.name}: shared bytes an SM, a thread block and threads an "
                           f"SM are {card}; the kernels' grids are sized for Hopper's "
                           f"{(SMEM_PER_SM, SMEM_PER_BLOCK, THREADS_PER_SM)}")
    return p.multi_processor_count


def resident_blocks(threads: int, smem: int) -> int:
    """Thread blocks of ``threads`` threads and ``smem`` dynamic shared
    bytes that one SM holds at once (the kernels' launch bounds keep
    registers from being the limit).  The only owner of a persistent grid's
    size: the launchers take the grid as given."""
    per_block = -(-(smem + SMEM_RESERVED) // SMEM_UNIT) * SMEM_UNIT
    return min(THREADS_PER_SM // threads, BLOCKS_PER_SM, SMEM_PER_SM // per_block)


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """Launch geometry of a persistent bit-plane kernel (pack, unpack,
    decode_reduce): ``grid`` thread blocks walk over ``n_tiles`` tiles of
    ``tile`` groups (thread block b takes tiles b, b + grid, ...), with
    ``smem`` dynamic shared bytes each."""
    tile: int
    n_tiles: int
    grid: int
    smem: int


def tile_geometry(n_groups: int, t_max: int, threads: int, smem_of, sms: int) -> TileGeometry:
    """The tile rule of the persistent bit-plane kernels, which take 32
    groups a pass of a thread block: tiles of a multiple of 32 groups, at
    most ``t_max``, and small enough that each of the thread blocks the card
    holds at once at ``t_max`` gets two tiles or more where there are groups
    enough (so a block's next tile's copy overlaps its work on this one); as
    many thread blocks of ``threads`` as ``sms`` SMs hold at once, at most
    one a tile.  ``smem_of(tile)``: a thread block's dynamic shared bytes."""
    full = sms * resident_blocks(threads, smem_of(t_max))
    tile = max(32, min(t_max, n_groups // (2 * full) // 32 * 32))
    n_tiles = -(-n_groups // tile)
    grid = min(n_tiles, sms * resident_blocks(threads, smem_of(tile)))
    return TileGeometry(tile, n_tiles, grid, smem_of(tile))


# A kernel that stages its input by 16-byte copies needs it to start on a
# 16-byte boundary.  The bit-plane kernels' wrappers raise otherwise and
# never copy quietly: the entry points above them pass :func:`aligned`
# tensors.  (The rANS wrappers, whose callers hand them views of a stream,
# take :func:`aligned` copies themselves.)
ALIGN = 16


def require_aligned(ptr: int, what: str) -> None:
    if ptr % ALIGN:
        raise ValueError(
            f"{what} starts at {ptr:#x}, {ptr % ALIGN} bytes past a {ALIGN}-byte "
            f"boundary; the kernel stages it by {ALIGN}-byte copies. Pass a tensor "
            f"that starts at a {ALIGN}-byte multiple (e.g. a fresh one)")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it starts on an ALIGN-byte boundary, else a fresh
    contiguous copy (which does): what an entry point hands a kernel wrapper
    for a view into a larger tensor, such as a parameter of a flat bucket.
    A CPU tensor (real or fake) is returned as it is: only a CUDA kernel
    stages by ALIGN-byte copies, and a fake tensor has no address."""
    if t.device.type != "cuda" or t.data_ptr() % ALIGN == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def is_fake(t) -> bool:
    """Whether ``t`` is a ``FakeTensor``: shapes and dtypes, no data, as
    the dry run's rank (``launch/dryrun``) holds every tensor."""
    return isinstance(t, FakeTensor)


def host_int(t: torch.Tensor) -> int:
    """``int(t)`` of a real tensor, also where a ``FakeTensorMode`` is
    active (the dry run's decode cells keep the cache's position a real
    scalar among fake leaves); a fake tensor raises ValueError."""
    if is_fake(t):
        raise ValueError("a fake tensor holds no value to read on the host")
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is None:
        return int(t)
    with unset_fake_temporarily():
        return int(t)


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _artifact(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))  # headers the sources share
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_kernels(names=None) -> dict:
    """Compile every named source (keys of ``SOURCES``) whose library is not
    built yet, one ``nvcc`` per source, all running at once.  Returns
    ``{source: seconds}`` for the sources compiled by this call; raises with the compiler's
    output if any build fails.  ``nvcc``'s ``-Xptxas=-v`` report (registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        out = _artifact(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler report of source ``name``'s current build ('' if none)."""
    log = _artifact(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def launcher(name: str, argtypes: tuple, source: str | None = None):
    """The C launcher ``<name>_launch`` of kernel ``name`` (in ``source``,
    by default ``KERNELS[name]``), built on first use and loaded with
    ``ctypes``.  It returns ``cudaGetLastError()``."""
    fn = _LIBS.get(name)
    if fn is None:
        source = source or KERNELS[name]
        build_kernels([source])
        fn = getattr(ctypes.CDLL(str(_artifact(source))), f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return fn
