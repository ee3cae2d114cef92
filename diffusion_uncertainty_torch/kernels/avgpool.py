"""2×2 stride-2 average pool kernel, NHWC to NHWC, of one tensor or of two of
one shape in one launch. Source: ``csrc/avgpool.cu``.

Replaces ``_kernel`` of ``diffusion_uncertainty_tpu/ops/avgpool.py``.
``avg_pool_2x2_pair`` pools two tensors in one launch (ADM's down ResBlock:
its h and its skip x). Each wrapper takes its plain version for CPU tensors
and launches the kernel for CUDA tensors, by the route ``plan`` picks from the
channel rows' byte width and the pointers: ``wide`` (a thread a 16-byte run
of channels) or ``narrow`` (a thread an element, for channel rows that are
not a multiple of 16 bytes or unaligned pointers). A launch counts once as
``avg_pool_2x2`` in ``_build.LAUNCHES``, once by route in ``ROUTE_LAUNCHES``,
and there as ``pair`` too when it pools two tensors.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build

__all__ = [
    "avg_pool_2x2", "avg_pool_2x2_pair", "avg_pool_2x2_plain", "avg_pool_2x2_pair_plain", "plan", "ROUTES",
    "ROUTE_LAUNCHES",
]

ROUTES = ("wide", "narrow")
# launches by route, and ``pair``: launches that pooled two tensors
ROUTE_LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("avgpool")
    if not getattr(lib, "_typed", False):
        lib.du_avgpool.argtypes = [_I, _I, _P] + [_P] * 4 + [_P]
        lib.du_avgpool.restype = _I
        lib._typed = True
    return lib


def avg_pool_2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """The 6D-reshape form, summed in float32 as ((x00 + x01) + (x10 + x11))·¼."""
    b, h, w, c = x.shape
    xr = x.float().reshape(b, h // 2, 2, w // 2, 2, c)
    s = (xr[:, :, 0, :, 0] + xr[:, :, 0, :, 1]) + (xr[:, :, 1, :, 0] + xr[:, :, 1, :, 1])
    return (s * 0.25).to(x.dtype)


def avg_pool_2x2_pair_plain(a: torch.Tensor, b: torch.Tensor):
    return avg_pool_2x2_plain(a), avg_pool_2x2_plain(b)


def plan(pixel_bytes: int, align: int) -> str:
    """The route of pooling pixels of ``pixel_bytes`` at pointers that are all
    multiples of ``align`` (a power of two, at most 16)."""
    return "wide" if pixel_bytes % 16 == 0 and align >= 16 else "narrow"


@functools.lru_cache(maxsize=None)
def _geometry(shape, dtype, align):
    """(route, the C entry's int array) of pooling a tensor of ``shape`` and
    ``dtype`` at pointers aligned to ``align``."""
    n, h, w, c = shape
    return plan(c * dtype.itemsize, align), (_I * 5)(n, h, w, c, _build.dtype_code(dtype))


def _launch(xs) -> list:
    """Pools of one or two contiguous NHWC CUDA tensors of one shape and type."""
    x = xs[0]
    shape, dtype, dev = x.shape, x.dtype, torch.cuda.current_device()
    b, h, w, c = shape
    if h % 2 or w % 2:
        raise ValueError(f"avg_pool_2x2: needs even H, W, got {tuple(shape)}")
    bits, ptrs, outs = 0, [], []
    for t in xs:
        if not t.is_contiguous() or t.get_device() != dev or (t is not x and (t.shape != shape or t.dtype != dtype)):
            raise ValueError(f"avg_pool_2x2: needs contiguous NHWC tensors of one shape and type on cuda:{dev}")
        y = t.new_empty((b, h // 2, w // 2, c))
        p, q = t.data_ptr(), y.data_ptr()
        bits |= p | q
        ptrs += (p, q)
        outs.append(y)
    ptrs += [None] * (4 - len(ptrs))
    route, geom = _geometry(shape, dtype, min(bits & -bits, 16) if bits else 16)
    lib = _lib()
    _build.check(lib, lib.du_avgpool(route == "wide", len(xs), geom, *ptrs, _build.stream_ptr(x)), "avg_pool_2x2")
    _build.LAUNCHES["avg_pool_2x2"] += 1
    ROUTE_LAUNCHES[route] += 1
    if len(xs) == 2:
        ROUTE_LAUNCHES["pair"] += 1
    return outs


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, C] mean of each 2×2 window."""
    if x.is_cpu:
        return avg_pool_2x2_plain(x)
    return _launch((x,))[0]


def avg_pool_2x2_pair(a: torch.Tensor, b: torch.Tensor):
    """(``avg_pool_2x2(a)``, ``avg_pool_2x2(b)``) in one launch; a and b of one
    shape and type."""
    if a.is_cpu:
        return avg_pool_2x2_pair_plain(a, b)
    return tuple(_launch((a, b)))
