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
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = [
    "SOURCES", "BUILD_DIR", "COUNTERS", "LAUNCHES", "build", "load", "check", "stream_ptr", "dtype_code", "require_cuda",
    "ptxas_report",
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
# keys, the Pallas flash ``_kernel``'s regime; ``group_norm``: the one-launch
# GroupNorm)
COUNTERS = ("group_norm", "gn_stats", "gn_apply", "attention", "attention_long", "avg_pool_2x2", "interleave_2x", "winograd")
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


_TYPE_NAMES = {
    "f": "float", "13__nv_bfloat16": "bf16", "5uint4": "uint4", "j": "u32", "t": "u16", "i": "int", "x": "i64",
}


def _kernel_name(mangled: str) -> str:
    """'attention_tc_kernel<40,8>' from its mangled name (integer and bool
    literals; float, bf16, uint4, unsigned, int and long long types); the
    mangled name where it does not parse."""
    m = re.search(r"([A-Za-z_]+_kernel)(I?)", mangled)
    if not m:
        return mangled
    rest, args = mangled[m.end():], []
    while m.group(2) and not rest.startswith("E"):
        lit = re.match(r"L[ib](\d+)E", rest)
        name = next((k for k in _TYPE_NAMES if rest.startswith(k)), None)
        if lit:
            args.append(lit.group(1))
            rest = rest[lit.end():]
        elif name:
            args.append(_TYPE_NAMES[name])
            rest = rest[len(name):]
        else:
            return mangled
    return f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)


def ptxas_report(name: str) -> list[str]:
    """'kernel: N registers, spill stores/loads' for each entry function of
    the ptxas report of ``name``'s build in this process (empty when the
    library came from the cache)."""
    out, entry, spill = [], None, ""
    for line in build_logs.get(name, "").splitlines():
        if "Compiling entry function" in line:
            entry, spill = _kernel_name(line.split("'")[1]), ""
        elif entry and "spill stores" in line:
            spill = line.split(",", 1)[1].strip()
        elif entry and "Used" in line and "registers" in line:
            out.append(f"{entry}: {line.split('Used', 1)[1].split(',')[0].strip()}, {spill}")
            entry = None
    return out


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never runs
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.du_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's card, as the raw pointer value."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t) -> int:
    """The kernels' element-type code of a tensor or a dtype."""
    code = _DTYPE_CODES.get(getattr(t, "dtype", t))
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16 tensors, got {getattr(t, 'dtype', t)}")
    return code


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """The kernel path takes contiguous tensors on the current CUDA device."""
    dev = torch.cuda.current_device()
    for t in tensors:
        if t.get_device() != dev:  # -1 on the CPU
            raise ValueError(f"{what}: expected tensors on cuda:{dev}, got {t.device}")
