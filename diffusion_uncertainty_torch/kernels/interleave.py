"""Phase-interleave kernel: four NHWC tensors y_ab -> one tensor twice as high
and wide, out[:, 2i+a, 2j+b] = y_ab[:, i, j]. Source: ``csrc/interleave.cu``.

Replaces ``_ilv_kernel`` of ``diffusion_uncertainty_tpu/ops/fused_upsample.py``.
Nearest-2× upsampling is the same call with one tensor passed four times.
The wrapper takes its plain version for CPU tensors and launches the kernel
for CUDA tensors; its launches are counted in ``_build.LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["interleave_2x", "interleave_2x_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("interleave")
    if not getattr(lib, "_typed", False):
        lib.du_interleave.argtypes = [_P] * 5 + [_I] * 5 + [_P]
        lib.du_interleave.restype = _I
        lib._typed = True
    return lib


def interleave_2x_plain(y00, y01, y10, y11):
    """The stack+transpose form."""
    n, h, w, c = y00.shape
    ys = torch.stack([torch.stack([y00, y01]), torch.stack([y10, y11])])
    return ys.permute(2, 3, 0, 4, 1, 5).reshape(n, 2 * h, 2 * w, c)


def interleave_2x(y00: torch.Tensor, y01: torch.Tensor, y10: torch.Tensor, y11: torch.Tensor) -> torch.Tensor:
    if y00.device.type == "cpu":
        return interleave_2x_plain(y00, y01, y10, y11)
    ys = (y00, y01, y10, y11)
    n, h, w, c = y00.shape
    if any(y.shape != y00.shape or y.dtype != y00.dtype or not y.is_contiguous() for y in ys):
        raise ValueError("interleave_2x: needs four contiguous NHWC tensors of one shape and dtype")
    _build.require_cuda("interleave_2x", *ys)
    out = torch.empty((n, 2 * h, 2 * w, c), dtype=y00.dtype, device=y00.device)
    pixel_bytes = c * y00.element_size()
    word = next(
        wd for wd in (16, 4, 2, 1)
        if pixel_bytes % wd == 0 and all(y.data_ptr() % wd == 0 for y in ys)
    )
    if word == 1:
        raise ValueError("interleave_2x: rows of an odd byte width are not supported")
    lib = _lib()
    err = lib.du_interleave(*(y.data_ptr() for y in ys), out.data_ptr(), n, h, w, pixel_bytes, word, _build.stream_ptr(y00))
    _build.check(lib, err, "interleave_2x")
    _build.LAUNCHES["interleave_2x"] += 1
    return out

