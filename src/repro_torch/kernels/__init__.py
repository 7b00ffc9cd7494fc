"""CUDA kernels for Hopper: build, load, launch accounting, device probe.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface.  At first use, :func:`build_kernels` compiles every source that
is not yet built with its own ``nvcc`` (all started together) into a shared
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
run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

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

# No fast-math and no flush-to-zero: the f32 accumulate keeps subnormals.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

_LIBS: dict = {}
_LAUNCHES = {name: 0 for name in KERNELS}


# ---------------------------------------------------------------------------
# launch accounting
# ---------------------------------------------------------------------------

def count_launch(name: str) -> None:
    """Called by a wrapper right after it launched kernel ``name``."""
    _LAUNCHES[name] += 1


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def clear_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


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
    """Handle of PyTorch's current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _artifact(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
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
