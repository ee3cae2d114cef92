"""Profiling helpers: a ``torch.profiler`` trace and device-bracketed timing.

JAX counterpart: ``diffusion_uncertainty_tpu/utils/profiling.py``
(``trace``, ``device_timeit``, :23-43). ``trace`` writes a Chrome trace
(``trace.json``, viewable in Perfetto) of the block's host and CUDA
activity; ``device_timeit`` brackets each call with
``torch.cuda.synchronize()`` where JAX calls ``block_until_ready``. There
is no compile to exclude, so it makes no warm-up call: the caller warms up
where a first call builds kernels or plans.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable

import torch

__all__ = ["trace", "device_timeit"]


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block (CPU, and CUDA where a card is present) and write
    ``<log_dir>/trace.json``."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def device_timeit(fn: Callable, *args, repeats: int = 3) -> dict:
    """min / mean wall seconds of ``fn(*args)`` over ``repeats`` calls, each
    bracketed by ``torch.cuda.synchronize()`` (where a card is present)."""
    times = []
    for _ in range(repeats):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return {"min_s": min(times), "mean_s": sum(times) / len(times), "times": times}
