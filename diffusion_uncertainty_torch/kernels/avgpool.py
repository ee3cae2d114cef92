"""2×2 stride-2 average pool kernel, NHWC to NHWC. Source: ``csrc/avgpool.cu``.

Replaces ``_kernel`` of ``diffusion_uncertainty_tpu/ops/avgpool.py``. The
wrapper takes its plain version for CPU tensors and launches the kernel for
CUDA tensors; its launches are counted in ``_build.LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["avg_pool_2x2", "avg_pool_2x2_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("avgpool")
    if not getattr(lib, "_typed", False):
        lib.du_avgpool.argtypes = [_P, _P] + [_I] * 6 + [_P]
        lib.du_avgpool.restype = _I
        lib._typed = True
    return lib


def avg_pool_2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """The 6D-reshape form, summed in float32 as ((x00 + x01) + (x10 + x11))·¼."""
    b, h, w, c = x.shape
    xr = x.float().reshape(b, h // 2, 2, w // 2, 2, c)
    s = (xr[:, :, 0, :, 0] + xr[:, :, 0, :, 1]) + (xr[:, :, 1, :, 0] + xr[:, :, 1, :, 1])
    return (s * 0.25).to(x.dtype)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, C] mean of each 2×2 window."""
    if x.device.type == "cpu":
        return avg_pool_2x2_plain(x)
    b, h, w, c = x.shape
    if h % 2 or w % 2 or not x.is_contiguous():
        raise ValueError(f"avg_pool_2x2: needs a contiguous NHWC tensor with even H, W, got {tuple(x.shape)}")
    _build.require_cuda("avg_pool_2x2", x)
    y = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    vec = (c * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
    lib = _lib()
    err = lib.du_avgpool(x.data_ptr(), y.data_ptr(), b, h, w, c, _build.dtype_code(x), int(vec), _build.stream_ptr(x))
    _build.check(lib, err, "avg_pool_2x2")
    _build.LAUNCHES["avg_pool_2x2"] += 1
    return y

