"""GroupNorm kernels. Source: ``csrc/groupnorm.cu``.

Replace the Pallas GroupNorm family of
``diffusion_uncertainty_tpu/ops/groupnorm.py`` (``_kernel``, ``_hwnc_kernel``,
``_stats_kernel``, ``_tiled_kernel``). ``group_norm`` is the op's entry: one
launch of the cluster kernel (route ``one_launch``, counted as
``group_norm``) for every group that 8 blocks of ``GN_BLOCK_BYTES`` hold,
else the pair ``gn_stats`` (per-(n, c) coefficients) + ``gn_apply`` (one FMA
pass, optional SiLU), route ``pair``. The route is decided from the shape
before any launch (``route``) and counted per call in ``ROUTE_LAUNCHES``.
The pair's kernels launch by ``plan`` (16-byte words or single elements,
blocks over whole pixel rows of every SM), counted by its route in
``PAIR_ROUTE_LAUNCHES``; ``gn_stats`` folds across blocks in one launch,
through a workspace allocated per call and a count kept per device, so the
pair serves one stream at a time (the port's). Each wrapper takes its plain
PyTorch version for a tensor on the CPU and launches its kernel for a CUDA
tensor; launches are counted in ``_build.LAUNCHES``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build

__all__ = [
    "group_norm", "group_norm_plain", "gn_stats", "gn_apply", "gn_stats_plain", "gn_apply_plain", "route", "piece_bytes",
    "GN_BLOCK_BYTES", "GN_MAX_CLUSTER", "ROUTES", "ROUTE_LAUNCHES", "plan", "PairPlan", "PAIR_ROUTES",
    "PAIR_ROUTE_LAUNCHES",
]

GN_THREADS = 256  # threads of a one-launch block (csrc kFusedThreads)
# bytes of the group's slab one block holds in shared memory: three blocks
# an SM, and 8 blocks hold ADM-128's largest group (128x128 x 16 channels,
# bf16: 512 KB)
GN_BLOCK_BYTES = 64 * 1024
GN_MAX_CLUSTER = 8  # the portable cluster size
GN_MAX_GROUP_WIDTH = 512  # channels of a group the kernel's coefficient table holds
NUM_SMS = 132  # H100 SXM
STATS_THREADS = 512  # threads of a gn_stats block (csrc kStatsThreads)
APPLY_THREADS = 256  # threads of a gn_apply block (csrc kApplyThreads)
PAIR_MAX_C = 16384  # channels the pair takes (csrc kMaxPairC: per-channel sums in shared memory)
PAIR_ROUTES = ("wide", "scalar")
# gn_stats and gn_apply launches by the plan's route
PAIR_ROUTE_LAUNCHES: collections.Counter = collections.Counter()
_COUNTERS: dict = {}  # device -> gn_stats's last-block counts

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
        lib.du_gn_stats.argtypes = [_P] * 9 + [_I] * 7 + [ctypes.c_float] + [_I] * 3 + [_P]
        lib.du_gn_stats.restype = _I
        lib.du_gn_apply.argtypes = [_P] * 4 + [_I] * 10 + [_P]
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


class PairPlan(NamedTuple):
    """The launch geometry of ``gn_stats`` or ``gn_apply`` over [n, hw, c]."""

    route: str  # "wide": 16-byte words; "scalar": one element a load
    vec: int  # elements of a word (16 // elem_size, or 1)
    threads: int  # threads of a block
    chunks: int  # blocks of an image; block k takes rows k·phases + p + j·chunks·phases
    blocks: int  # n · chunks
    tile_w: int  # threads along a row: one word column each
    phases: int  # rows a block covers in one step
    idx32: bool  # offsets within an image fit in 32 bits


# (threads of a block, blocks an SM) of each kernel of the pair
PAIR_GRID = {"gn_stats": (STATS_THREADS, 1), "gn_apply": (APPLY_THREADS, 32)}


@functools.lru_cache(maxsize=None)
def plan(kernel: str, n: int, hw: int, c: int, elem_size: int, ptr_bits: int = 0) -> PairPlan:
    """The plan of ``kernel`` ("gn_stats" or "gn_apply"): ``wide`` where a
    row's bytes and every pointer (``ptr_bits``: their bitwise or) are
    multiples of 16, else ``scalar``; a row's words over ``tile_w`` threads
    (all of them where the row has at most a block's words) and the block's
    threads over ``phases`` rows; ``chunks`` blocks an image, so that the n
    images' blocks fill ``PAIR_GRID``'s blocks on each of the 132 SMs (at
    most one block per ``phases`` rows)."""
    if c > PAIR_MAX_C:
        raise ValueError(f"gn_stats / gn_apply: at most {PAIR_MAX_C} channels, got {c}")
    threads, per_sm = PAIR_GRID[kernel]
    wide = (c * elem_size) % 16 == 0 and ptr_bits % 16 == 0
    vec = 16 // elem_size if wide else 1
    tile_w = min(c // vec, threads)
    phases = threads // tile_w
    chunks = max(1, min(-(-NUM_SMS * per_sm // n), -(-hw // phases)))
    idx32 = (hw + 2 * chunks * phases) * c < 2**31
    return PairPlan("wide" if wide else "scalar", vec, threads, chunks, n * chunks, tile_w, phases, idx32)


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """n zeroed words on the device for gn_stats's last-block count (each
    launch leaves them zero again); kept per device and grown as needed."""
    t = _COUNTERS.get(device)
    if t is None or t.numel() < n:
        t = _COUNTERS[device] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return t


def gn_stats(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
):
    """``gn_stats_plain``'s A, B: one launch of ``plan("gn_stats", ...)``'s
    blocks, which sum their rows and the last of which folds them in a fixed
    order (bit-identical from call to call)."""
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
    p = plan("gn_stats", n, h * w, c, x.element_size(), x.data_ptr() % 16)
    a = torch.empty((n, c), dtype=torch.float32, device=x.device)
    b = torch.empty_like(a)
    ws = torch.empty((n, p.chunks, num_groups, 2), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.du_gn_stats(
        x.data_ptr(), g.data_ptr(), bt.data_ptr(),
        None if sc is None else sc.data_ptr(), None if sh is None else sh.data_ptr(),
        a.data_ptr(), b.data_ptr(), ws.data_ptr(), _counters(x.device, n).data_ptr(),
        n, h * w, c, num_groups, p.chunks, p.tile_w, p.phases, float(eps),
        _build.dtype_code(x), int(p.route == "wide"), int(p.idx32), _build.stream_ptr(x),
    )
    _build.check(lib, err, "gn_stats")
    _build.LAUNCHES["gn_stats"] += 1
    PAIR_ROUTE_LAUNCHES[p.route] += 1
    return a, b


def gn_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, apply_silu: bool = True) -> torch.Tensor:
    """``gn_apply_plain``'s y: one launch of ``plan("gn_apply", ...)``'s
    blocks, walking x's rows in the reverse of ``gn_stats``'s sweep."""
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
    bits = (x.data_ptr() | y.data_ptr() | a.data_ptr() | b.data_ptr()) % 16
    p = plan("gn_apply", n, h * w, c, x.element_size(), bits)
    lib = _lib()
    err = lib.du_gn_apply(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), n, h * w, c, p.chunks, p.tile_w, p.phases,
        int(apply_silu), _build.dtype_code(x), int(p.route == "wide"), int(p.idx32), _build.stream_ptr(x),
    )
    _build.check(lib, err, "gn_apply")
    _build.LAUNCHES["gn_apply"] += 1
    PAIR_ROUTE_LAUNCHES[p.route] += 1
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
