"""Build and load the hand-written Hopper kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries are built at first use
from the sources in this package and cached under ``_build/`` by a digest of
the sources and flags, so an edited source is rebuilt. ``build()`` starts one
``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU-only test machine has no ``nvcc``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = [
    "SOURCES", "BUILD_DIR", "COUNTERS", "LAUNCHES", "build", "load", "check", "stream_ptr", "dtype_code", "require_cuda",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("groupnorm", "attention", "avgpool", "interleave", "winograd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launch counters: each wrapper adds one to its name where it launches its
# kernel, and nowhere else (``attention_long``: attention over more than 2048
# keys, the Pallas flash ``_kernel``'s regime)
COUNTERS = ("gn_stats", "gn_apply", "attention", "attention_long", "avg_pool_2x2", "interleave_2x", "winograd")
LAUNCHES: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build, by source name
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every missing library of ``names`` in parallel; seconds taken.
    Raises with the compiler's output when a build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        lib.du_error_string.argtypes = [ctypes.c_int]
        lib.du_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never runs
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.du_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16 tensors, got {t.dtype}")


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """The kernel path takes contiguous tensors on the current CUDA device."""
    dev = torch.cuda.current_device()
    for t in tensors:
        if t.device.type != "cuda" or t.device.index != dev:
            raise ValueError(f"{what}: expected tensors on cuda:{dev}, got {t.device}")
