"""GroupNorm kernel pair: ``gn_stats`` (per-(n, c) coefficients) and
``gn_apply`` (one FMA pass, optional SiLU). Source: ``csrc/groupnorm.cu``.

Replaces the Pallas GroupNorm family of
``diffusion_uncertainty_tpu/ops/groupnorm.py`` (``_kernel``, ``_hwnc_kernel``,
``_stats_kernel``, ``_tiled_kernel``). Each wrapper takes its plain PyTorch
version for a tensor on the CPU and launches its kernel for a CUDA tensor;
its launches are counted in ``_build.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["gn_stats", "gn_apply", "gn_stats_plain", "gn_apply_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = _build.load("groupnorm")
    if not getattr(lib, "_typed", False):
        lib.du_gn_stats.argtypes = [_P] * 7 + [_I] * 4 + [ctypes.c_float, _I, _I, _P]
        lib.du_gn_stats.restype = _I
        lib.du_gn_apply.argtypes = [_P] * 4 + [_L, _I, _L, _I, _I, _I, _P]
        lib.du_gn_apply.restype = _I
        lib._typed = True
    return lib


def gn_stats_plain(x, gamma, beta, num_groups, eps=1e-5, scale=None, shift=None):
    """x [N, H, W, C] -> (A, B) float32 [N, C] with GN(x)·γ+β (·(1+s)+t)
    == x·A + B; statistics as E[x²] − E[x]² in float32."""
    n, h, w, c = x.shape
    gs = c // num_groups
    xf = x.float().reshape(n, h * w, num_groups, gs)
    s1 = xf.mean(dim=(1, 3))
    s2 = (xf * xf).mean(dim=(1, 3))
    inv = torch.rsqrt(s2 - s1 * s1 + eps)  # [N, G]
    a = inv[:, :, None] * gamma.float().reshape(num_groups, gs)
    b = beta.float().reshape(num_groups, gs) - s1[:, :, None] * a
    a, b = a.reshape(n, c), b.reshape(n, c)
    if scale is not None:
        one_s = 1.0 + scale.float().reshape(n, c)
        a = a * one_s
        b = b * one_s + shift.float().reshape(n, c)
    return a, b


def gn_apply_plain(x, a, b, apply_silu=True):
    """y = x·A[n, c] + B[n, c] (+SiLU) in float32, stored in x's type."""
    n, c = a.shape
    y = x.float() * a.reshape(n, 1, 1, c) + b.reshape(n, 1, 1, c)
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _f32(t: torch.Tensor, shape) -> torch.Tensor:
    return t.to(torch.float32).reshape(shape).contiguous()


def gn_stats(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
):
    if x.device.type == "cpu":
        return gn_stats_plain(x, gamma, beta, num_groups, eps, scale, shift)
    n, h, w, c = x.shape
    if c % num_groups or not x.is_contiguous():
        raise ValueError(f"gn_stats: needs a contiguous NHWC tensor with C % G == 0, got {tuple(x.shape)}, G={num_groups}")
    _build.require_cuda("gn_stats", x, gamma, beta)
    g, bt = _f32(gamma, (c,)), _f32(beta, (c,))
    sc = sh = None
    if scale is not None:
        sc, sh = _f32(scale, (n, c)), _f32(shift, (n, c))
    a = torch.empty((n, c), dtype=torch.float32, device=x.device)
    b = torch.empty_like(a)
    gs_bytes = (c // num_groups) * x.element_size()
    vec = gs_bytes % 16 == 0 and (c * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
    lib = _lib()
    err = lib.du_gn_stats(
        x.data_ptr(), g.data_ptr(), bt.data_ptr(),
        None if sc is None else sc.data_ptr(), None if sh is None else sh.data_ptr(),
        a.data_ptr(), b.data_ptr(), n, h * w, c, num_groups, float(eps),
        _build.dtype_code(x), int(vec), _build.stream_ptr(x),
    )
    _build.check(lib, err, "gn_stats")
    _build.LAUNCHES["gn_stats"] += 1
    return a, b



def gn_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, apply_silu: bool = True) -> torch.Tensor:
    if x.device.type == "cpu":
        return gn_apply_plain(x, a, b, apply_silu)
    n, h, w, c = x.shape
    if not x.is_contiguous() or a.shape != (n, c) or b.shape != (n, c):
        raise ValueError("gn_apply: needs a contiguous NHWC tensor and [N, C] coefficients")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("gn_apply: coefficients must be float32")
    _build.require_cuda("gn_apply", x, a, b)
    a, b = a.contiguous(), b.contiguous()
    y = torch.empty_like(x)
    per = 16 // x.element_size()
    vec = c % per == 0 and x.data_ptr() % 16 == 0
    lib = _lib()
    err = lib.du_gn_apply(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(), c, h * w * c,
        int(apply_silu), _build.dtype_code(x), int(vec), _build.stream_ptr(x),
    )
    _build.check(lib, err, "gn_apply")
    _build.LAUNCHES["gn_apply"] += 1
    return y

