"""Device choice of the port's entry points.

No JAX counterpart: JAX places arrays on its default backend. The port's
entry points (``make_schedule``, ``TorchNoise``, ``build_sd_stack``, the
text-to-image CLI) run on the card unless the caller asks for the CPU; with
no card they raise instead of falling back. ``device_ms``, ``graph_ms`` and
``host_us`` time work on the card for the measurement scripts.
"""

from __future__ import annotations

import statistics
import time

import torch

__all__ = ["resolve_device", "device_ms", "graph_ms", "host_us"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA card is available (pass device='cpu' to run on the CPU)")
    return dev


def device_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Median over ``reps`` of the mean device time (CUDA events) of ``inner``
    back-to-back calls of ``fn``, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return statistics.median(times)


def graph_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """``device_ms`` of ``inner`` calls of ``fn`` captured once in a CUDA graph
    and timed by events around its replays: the device time without the
    host's issue time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return device_ms(graph.replay, reps, 1) / inner


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds a call of ``fn`` takes to return (``calls`` back to
    back after a warm-up call, no synchronize between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6
