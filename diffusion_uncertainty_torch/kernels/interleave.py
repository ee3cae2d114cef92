"""Phase-interleave / nearest-2× kernel, one or two jobs a launch. Source:
``csrc/interleave.cu``.

Replaces ``_ilv_kernel`` of ``diffusion_uncertainty_tpu/ops/fused_upsample.py``.
A job is a phase interleave, four NHWC tensors y_ab to one tensor twice as
high and wide with out[:, 2i+a, 2j+b] = y_ab[:, i, j] (``interleave_2x``), or
a nearest-2× upsample, one tensor read once (``nearest_2x``);
``interleave_2x_pair`` runs one of each in one launch (ADM's up ResBlock).
Each wrapper takes its plain version for CPU tensors and launches the kernel
for CUDA tensors, by the route ``plan`` picks from the pixels' byte width and
the pointers: ``wide`` (16-byte words) or ``narrow`` (4- or 2-byte words, for
pixels that are not a multiple of 16 bytes or unaligned pointers). A launch
counts once as ``interleave_2x`` in ``_build.LAUNCHES``, once by route in
``ROUTE_LAUNCHES``, and there as ``pair`` too when it serves two jobs.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import _build

__all__ = [
    "interleave_2x", "nearest_2x", "interleave_2x_pair", "interleave_2x_plain", "nearest_2x_plain",
    "interleave_2x_pair_plain", "plan", "ROUTES", "ROUTE_LAUNCHES",
]

ROUTES = ("wide", "narrow")
# launches by route, and ``pair``: launches that served two jobs
ROUTE_LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("interleave")
    if not getattr(lib, "_typed", False):
        lib.du_interleave.argtypes = [_I, _I, _P] + [_P] * 10 + [_P]
        lib.du_interleave.restype = _I
        lib._typed = True
    return lib


def interleave_2x_plain(y00, y01, y10, y11):
    """The stack+transpose form."""
    n, h, w, c = y00.shape
    ys = torch.stack([torch.stack([y00, y01]), torch.stack([y10, y11])])
    return ys.permute(2, 3, 0, 4, 1, 5).reshape(n, 2 * h, 2 * w, c)


def nearest_2x_plain(x):
    """The broadcast form: out[:, 2i+a, 2j+b] = x[:, i, j]."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def interleave_2x_pair_plain(ys, x):
    return interleave_2x_plain(*ys), nearest_2x_plain(x)


@functools.lru_cache(maxsize=None)
def plan(jobs: tuple) -> tuple[str, int]:
    """(route, word bytes) of a launch of ``jobs``, each (pixel_bytes, align):
    pixels of ``pixel_bytes`` at pointers that are all multiples of ``align``
    (a power of two, at most 16). The word is the widest of 16, 4, 2 bytes
    dividing every job's pixel and pointers; ``wide`` for 16. Raises where no
    word divides them."""
    word = min(next((wd for wd in (16, 4, 2) if pb % wd == 0 and al >= wd), 0) for pb, al in jobs)
    if not word:
        raise ValueError(f"interleave_2x: pixels of an odd byte width or odd pointers are not supported: {jobs}")
    return ("wide" if word == 16 else "narrow"), word


@functools.lru_cache(maxsize=None)
def _geometry(keys: tuple):
    """(route, word, the C entry's int array) of a launch whose jobs have the
    keys (nsrc, input shape, dtype, pointer alignment)."""
    route, word = plan(tuple((c * dtype.itemsize, align) for _, (_, _, _, c), dtype, align in keys))
    vals = [v for nsrc, (n, h, w, c), dtype, _ in keys for v in (nsrc, n * h, w, c * dtype.itemsize)]
    return route, word, (_I * len(vals))(*vals)


def _launch(jobs) -> list:
    """Outputs of ``jobs``: one or two tuples of four (phase interleave) or
    one (nearest) contiguous NHWC CUDA tensors of one shape and type."""
    dev = torch.cuda.current_device()
    keys, ptrs, outs = [], [], []
    for srcs in jobs:
        y = srcs[0]
        shape, dtype = y.shape, y.dtype
        n, h, w, c = shape
        out = y.new_empty((n, 2 * h, 2 * w, c))
        q = bits = out.data_ptr()
        for t in srcs:
            if not t.is_contiguous() or t.get_device() != dev or (t is not y and (t.shape != shape or t.dtype != dtype)):
                raise ValueError(f"interleave_2x: needs contiguous NHWC tensors of one shape and type on cuda:{dev}")
            p = t.data_ptr()
            bits |= p
            ptrs.append(p)
        keys.append((len(srcs), shape, dtype, min(bits & -bits, 16) if bits else 16))
        ptrs += [None] * (4 - len(srcs)) + [q]
        outs.append(out)
    ptrs += [None] * (10 - len(ptrs))
    route, word, geom = _geometry(tuple(keys))
    lib = _lib()
    _build.check(lib, lib.du_interleave(word, len(jobs), geom, *ptrs, _build.stream_ptr(jobs[0][0])), "interleave_2x")
    _build.LAUNCHES["interleave_2x"] += 1
    ROUTE_LAUNCHES[route] += 1
    if len(jobs) == 2:
        ROUTE_LAUNCHES["pair"] += 1
    return outs


def interleave_2x(y00: torch.Tensor, y01: torch.Tensor, y10: torch.Tensor, y11: torch.Tensor) -> torch.Tensor:
    """out[:, 2i+a, 2j+b] = y_ab[:, i, j]."""
    if y00.is_cpu:
        return interleave_2x_plain(y00, y01, y10, y11)
    return _launch(((y00, y01, y10, y11),))[0]


def nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """out[:, 2i+a, 2j+b] = x[:, i, j], x read once."""
    if x.is_cpu:
        return nearest_2x_plain(x)
    return _launch(((x,),))[0]


def interleave_2x_pair(ys, x: torch.Tensor):
    """(``interleave_2x(*ys)``, ``nearest_2x(x)``) in one launch."""
    if x.is_cpu:
        return interleave_2x_pair_plain(ys, x)
    return tuple(_launch((tuple(ys), (x,))))
