"""GroupNorm kernels. Source: ``csrc/groupnorm.cu``.

Replace the Pallas GroupNorm family of
``diffusion_uncertainty_tpu/ops/groupnorm.py`` (``_kernel``, ``_hwnc_kernel``,
``_stats_kernel``, ``_tiled_kernel``). ``group_norm`` is the op's entry: one
launch of the cluster kernel (route ``one_launch``, counted as
``group_norm``) for every group that 8 blocks of ``GN_BLOCK_BYTES`` hold,
else the pair ``gn_stats`` (per-(n, c) coefficients) + ``gn_apply`` (one FMA
pass, optional SiLU), route ``pair``. The route is decided from the shape
before any launch (``route``) and counted per call in ``ROUTE_LAUNCHES``.
Each wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel for a CUDA tensor; launches are counted in
``_build.LAUNCHES``.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from . import _build

__all__ = [
    "group_norm", "group_norm_plain", "gn_stats", "gn_apply", "gn_stats_plain", "gn_apply_plain", "route", "piece_bytes",
    "GN_BLOCK_BYTES", "GN_MAX_CLUSTER", "ROUTES", "ROUTE_LAUNCHES",
]

GN_THREADS = 256  # threads of a one-launch block (csrc kFusedThreads)
# bytes of the group's slab one block holds in shared memory: three blocks
# an SM, and 8 blocks hold ADM-128's largest group (128x128 x 16 channels,
# bf16: 512 KB)
GN_BLOCK_BYTES = 64 * 1024
GN_MAX_CLUSTER = 8  # the portable cluster size
GN_MAX_GROUP_WIDTH = 512  # channels of a group the kernel's coefficient table holds
NUM_SMS = 132  # H100 SXM

ROUTES = ("one_launch", "pair")
# GroupNorm calls by route: ``one_launch`` is one ``group_norm`` launch,
# ``pair`` one ``gn_stats`` and one ``gn_apply``
ROUTE_LAUNCHES: collections.Counter = collections.Counter()

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
        lib.du_group_norm.argtypes = [_P] * 6 + [_I] * 7 + [_L, _L, ctypes.c_float] + [_I] * 5 + [_P]
        lib.du_group_norm.restype = _I
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


def piece_bytes(row_bytes: int, ptr: int) -> int:
    """The widest cp.async piece (16, 8 or 4 bytes) that divides a group's
    row and x's address; 0 where none does."""
    for p in (16, 8, 4):
        if row_bytes % p == 0 and ptr % p == 0:
            return p
    return 0


def route(n: int, hw: int, c: int, groups: int, elem_size: int, ptr: int = 0) -> tuple[str, int]:
    """(route, cluster size) of a GroupNorm over [n, hw, c] in ``groups``
    groups of ``elem_size``-byte elements at address ``ptr``. ``one_launch``
    takes the fewest blocks k that hold the group's slab in
    ``GN_BLOCK_BYTES`` each, raised until the n·groups·k blocks fill the SMs
    (never above ``GN_MAX_CLUSTER`` or hw); ``pair`` where the slab needs
    more than ``GN_MAX_CLUSTER`` blocks, or its rows do not come in 4-byte
    pieces, or a group is wider than the kernel's tables."""
    gs = c // groups
    row = gs * elem_size
    piece = piece_bytes(row, ptr)
    if not piece or row // piece > GN_THREADS or gs > GN_MAX_GROUP_WIDTH:
        return "pair", 0
    k = -(-hw // (GN_BLOCK_BYTES // row))
    if k > GN_MAX_CLUSTER:
        return "pair", 0
    fill = -(-NUM_SMS // (n * groups))
    return "one_launch", max(k, min(fill, GN_MAX_CLUSTER, hw))


def group_norm_plain(x, gamma, beta, num_groups, eps=1e-5, scale=None, shift=None, apply_silu=True):
    """The one-launch kernel's arithmetic in torch ops: the group statistics
    E[x], E[x²] − E[x]² in float32, y = x·A + B with A, B folded from γ, β
    and (1+s), t, optional SiLU; output in x's type."""
    return gn_apply_plain(x, *gn_stats_plain(x, gamma, beta, num_groups, eps, scale, shift), apply_silu)


def _code(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else _build.dtype_code(t)


def _rows(t: torch.Tensor, n: int, c: int) -> torch.Tensor:
    """scale or shift as [n, c] rows with contiguous channels (a view where
    the caller's tensor allows one)."""
    t = t.reshape(n, c)
    return t if t.stride(1) == 1 else t.contiguous()


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    apply_silu: bool = True,
) -> torch.Tensor:
    """GN(x)·γ+β (·(1+s)+t) (+SiLU) of a contiguous NHWC x, in x's type: one
    cluster-kernel launch, or the pair for groups beyond 8 blocks (``route``)."""
    if x.device.type == "cpu":
        return group_norm_plain(x, gamma, beta, num_groups, eps, scale, shift, apply_silu)
    n, h, w, c = x.shape
    if c % num_groups or not x.is_contiguous():
        raise ValueError(f"group_norm: needs a contiguous NHWC tensor with C % G == 0, got {tuple(x.shape)}, G={num_groups}")
    kind, k = route(n, h * w, c, num_groups, x.element_size(), x.data_ptr())
    if kind == "pair":
        ROUTE_LAUNCHES["pair"] += 1
        return gn_apply(x, *gn_stats(x, gamma, beta, num_groups, eps, scale, shift), apply_silu)
    if gamma.numel() != c or beta.numel() != c or not (gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError(f"group_norm: gamma, beta must be contiguous [{c}]")
    sc = sh = None
    if scale is not None:
        sc, sh = _rows(scale, n, c), _rows(shift, n, c)
        if sc.dtype != sh.dtype:
            raise TypeError("group_norm: scale and shift must share a type")
    tensors = (x, gamma, beta) if sc is None else (x, gamma, beta, sc, sh)
    _build.require_cuda("group_norm", *tensors)
    y = torch.empty_like(x)
    row = (c // num_groups) * x.element_size()
    lib = _lib()
    err = lib.du_group_norm(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), None if sc is None else sc.data_ptr(),
        None if sh is None else sh.data_ptr(), y.data_ptr(), n, h * w, c, num_groups, k, -(-(h * w) // k),
        piece_bytes(row, x.data_ptr()), 0 if sc is None else sc.stride(0), 0 if sh is None else sh.stride(0),
        float(eps), _build.dtype_code(x), _build.dtype_code(gamma), _build.dtype_code(beta), _code(sc),
        int(apply_silu), _build.stream_ptr(x),
    )
    _build.check(lib, err, "group_norm")
    _build.LAUNCHES["group_norm"] += 1
    ROUTE_LAUNCHES["one_launch"] += 1
    return y
