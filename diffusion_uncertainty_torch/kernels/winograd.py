"""Winograd F(2×2, 3×3) conv kernel: 3×3 stride-1 SAME conv of an NHWC tensor
with the bias and an optional residual fused. Source: ``csrc/winograd.cu``.

Replaces ``_kernel`` and ``_compute_tile`` of
``diffusion_uncertainty_tpu/ops/winograd_conv.py``, with the same arithmetic:
V = Bᵀ d B of every 4×4 input patch in float32 rounded to bfloat16, the 16
products V·U with float32 accumulation against weights pre-transformed by
``weight_transform`` (U = G g Gᵀ in float32, stored in bfloat16, as
``_weight_transform``), Y = Aᵀ M A in float32, + bias, + residual. The
operands are bfloat16 for float32 activations too (the TPU kernel's default
``_MXU_DTYPE``). U is stored tiled for the kernel's bulk copies and
``wgmma`` (``weight_transform``; ``unpack_u`` gives back the [16, C, K]
matrices). ``winograd_conv_plain`` is the same arithmetic in torch ops (not
a direct conv); the wrapper takes it for a tensor on the CPU and launches
the kernel for a CUDA tensor; its launches are counted in
``_build.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["winograd_conv", "winograd_conv_plain", "weight_transform", "unpack_u", "u_shape", "K_ALIGN", "C_CHUNK"]

# U is padded with zero columns to a multiple of the 128 output channels of
# the kernel's cluster
K_ALIGN = 128
C_CHUNK = 32  # input channels of one step of the kernel's pipeline

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("winograd")
    if not getattr(lib, "_typed", False):
        lib.du_winograd.argtypes = [_P] * 5 + [_I] * 7 + [_P]
        lib.du_winograd.restype = _I
        lib._typed = True
    return lib


def u_shape(c: int, k: int) -> tuple:
    """The shape of ``weight_transform``'s U for C input and K output channels."""
    return (-(-k // K_ALIGN), c // C_CHUNK, 4, 4, 16, 4, 8, 8)


def weight_transform(w: torch.Tensor) -> torch.Tensor:
    """[K, C, 3, 3] (C % 32 == 0) -> U bfloat16, ``u_shape(C, K)``: the
    matrices U[4a+b, c, k] = (G g_kc Gᵀ)[a, b] computed in float32
    (``_weight_transform``, G from ``winograd_conv.py:74-77``), K padded with
    zero columns to Kp, a multiple of ``K_ALIGN``, and tiled as
    [Kp/128][C/32][b][a][k/8][c/8][k%8][c%8]: one 32 KB tile per (128 output
    channels, 32 input channels, column b) holds the four positions a block
    of the kernel's cluster multiplies, each in the core-matrix order of a
    K-major ``wgmma`` operand (8 rows of 16 bytes)."""
    k, c = w.shape[:2]
    if c % C_CHUNK:
        raise ValueError(f"weight_transform: C={c} is not a multiple of {C_CHUNK}")
    g = torch.tensor([[1.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0.0, 0.0, 1.0]], device=w.device)
    wf = w.detach().float()
    t = torch.einsum("ai,kcij->kcaj", g, wf)
    u = torch.einsum("kcaj,bj->abck", t, g)  # [4, 4, C, K]
    kp = -(-k // K_ALIGN) * K_ALIGN
    u = F.pad(u, (0, kp - k)).reshape(4, 4, c // C_CHUNK, 4, 8, kp // K_ALIGN, 16, 8)  # a b cc cg c8 kb ng n8
    return u.permute(5, 2, 1, 0, 6, 3, 7, 4).to(torch.bfloat16).contiguous()


def unpack_u(u: torch.Tensor, k: int) -> torch.Tensor:
    """``weight_transform``'s tiles back to the [16, C, K] matrices (position
    4a + b, input channel, output channel), in U's type."""
    kb, cc = u.shape[:2]
    return u.permute(3, 2, 1, 5, 7, 0, 4, 6).reshape(16, cc * C_CHUNK, kb * K_ALIGN)[:, :, :k]


def winograd_conv_plain(x, u, bias, res=None):
    """The kernel's arithmetic in torch ops. x [N, H, W, C] (H, W even), u
    from ``weight_transform``, bias [K] float32, res [N, H, W, K] or None ->
    [N, H, W, K] in x's type."""
    n, h, w, c = x.shape
    k = bias.shape[0]
    th, tw = h // 2, w // 2
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    # d[i][j][n, ty, tx] = x[n, 2ty - 1 + i, 2tx - 1 + j], zero outside
    d = [[xp[:, i : i + h : 2, j : j + w : 2] for j in range(4)] for i in range(4)]
    for j in range(4):
        d[0][j], d[1][j], d[2][j], d[3][j] = d[0][j] - d[2][j], d[1][j] + d[2][j], d[2][j] - d[1][j], d[1][j] - d[3][j]
    v = []
    for r in d:
        v += [r[0] - r[2], r[1] + r[2], r[2] - r[1], r[1] - r[3]]
    vm = torch.stack(v).reshape(16, n * th * tw, c).to(torch.bfloat16).float()
    m = torch.bmm(vm, unpack_u(u, k).float()).reshape(16, n, th, tw, k)
    s0 = [m[b] + m[4 + b] + m[8 + b] for b in range(4)]
    s1 = [m[4 + b] - m[8 + b] - m[12 + b] for b in range(4)]
    y = ((s0[0] + s0[1] + s0[2], s0[1] - s0[2] - s0[3]), (s1[0] + s1[1] + s1[2], s1[1] - s1[2] - s1[3]))
    out = torch.stack([torch.stack([y[a][b] + bias for b in range(2)], dim=3) for a in range(2)], dim=2)
    out = out.reshape(n, h, w, k)  # [n, th, 2, tw, 2, k] -> rows 2ty + a, cols 2tx + b
    if res is not None:
        out = out + res.float()
    return out.to(x.dtype)


def winograd_conv(x: torch.Tensor, u: torch.Tensor, bias: torch.Tensor, res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N, H, W, C] float32 or bfloat16 (H, W even, C % 32 == 0), u
    bfloat16 from ``weight_transform``, bias [K] float32 (K % 8 == 0), res
    [N, H, W, K] in x's type or None -> contiguous [N, H, W, K] in x's type."""
    if x.device.type == "cpu":
        return winograd_conv_plain(x, u, bias, res)
    n, h, w, c = x.shape
    k = bias.shape[0]
    if h % 2 or w % 2 or c % 32 or k % 8:
        raise ValueError(f"winograd_conv: x {tuple(x.shape)}, K={k}: needs H, W even, C % 32 == 0, K % 8 == 0")
    want = u_shape(c, k)
    if u.dtype != torch.bfloat16 or tuple(u.shape) != want or bias.dtype != torch.float32:
        raise ValueError(f"winograd_conv: u {u.dtype} {tuple(u.shape)} (want bfloat16 {want}), bias {bias.dtype}")
    if res is not None and (tuple(res.shape) != (n, h, w, k) or res.dtype != x.dtype):
        raise ValueError(f"winograd_conv: res {res.dtype} {tuple(res.shape)}, want {x.dtype} {(n, h, w, k)}")
    tensors = (x, u, bias) if res is None else (x, u, bias, res)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("winograd_conv: needs contiguous tensors")
    if any(t is not None and t.data_ptr() % 16 for t in (x, u, res)):  # TMA, bulk copies, 16-byte epilogue accesses
        raise ValueError("winograd_conv: needs x, u and res on 16-byte boundaries")
    _build.require_cuda("winograd_conv", *tensors)
    out = torch.empty((n, h, w, k), dtype=x.dtype, device=x.device)
    lib = _lib()
    err = lib.du_winograd(
        x.data_ptr(), u.data_ptr(), bias.data_ptr(), None if res is None else res.data_ptr(), out.data_ptr(),
        n, h, w, c, k, want[0] * K_ALIGN, _build.dtype_code(x), _build.stream_ptr(x),
    )
    _build.check(lib, err, "winograd_conv")
    _build.LAUNCHES["winograd"] += 1
    return out
