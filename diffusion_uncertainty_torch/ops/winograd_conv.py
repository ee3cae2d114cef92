"""3×3 stride-1 SAME conv (+bias, + optional residual), routable through the
Winograd F(2×2, 3×3) kernel, with its gradient.

JAX counterpart: ``diffusion_uncertainty_tpu/ops/winograd_conv.py``
(``conv3x3_winograd``, ``supports``, ``_reference_conv``, and ``_conv3x3``
with its VJP ``_conv3x3_bwd``). As there, the kernel is opt-in: with
``use_kernel=False``, or for a shape ``supports`` rejects, the op is the
direct conv plus bias plus residual (``F.conv2d`` on channels_last views,
as ``_reference_conv`` is ``lax.conv``). With ``use_kernel=True`` and a
supported shape it runs ``kernels.winograd.winograd_conv``: the Hopper
kernel for a CUDA tensor, its plain version for a CPU tensor. The route is
decided from shapes before any launch; nothing falls back after one. The
backward is the direct conv's gradient in eager math (``_conv3x3_bwd``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import winograd as _k
from .fused_upsample import conv2d_nhwc

__all__ = ["conv3x3_winograd", "supports", "reference_conv"]


def supports(x_shape, w_shape, stride=(1, 1), dilation=(1, 1)) -> bool:
    """The JAX shape rule (``winograd_conv.py:139-151``) for NHWC x and a
    torch-layout weight [K, C, 3, 3]: a 3×3 stride-1 dilation-1 conv whose
    input channels match, H % 4 == 0, W % 2 == 0 and C % 128 == 0. The
    TPU's VMEM tiling search (``_tile_params``) has no counterpart; in its
    place K % 8 == 0, so U's rows and the output's channel pairs are
    aligned for the kernel's vector loads and stores."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    _, h, w, c = x_shape
    k, ci, kh, kw = w_shape
    if (kh, kw) != (3, 3) or tuple(stride) != (1, 1) or tuple(dilation) != (1, 1):
        return False
    if ci != c:
        return False
    if h % 4 or w % 2 or c % 128:
        return False
    return k % 8 == 0


def reference_conv(x, w, b, res=None):
    """The direct conv: ``conv2d_nhwc(x, w, b) + res``."""
    y = conv2d_nhwc(x, w, b, padding=1)
    return y if res is None else y.add_(res)


class _Conv3x3(torch.autograd.Function):
    """The kernel forward (its plain version on the CPU); backward by
    autograd through ``reference_conv`` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, w, b, res, u):
        ctx.save_for_backward(x, w, b, res)
        return _k.winograd_conv(x, u, b.to(x.dtype).float(), res)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            y = reference_conv(*ins)
            wrt = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
        return tuple(next(got) if n else None for n in need) + (None,)


def conv3x3_winograd(
    x: torch.Tensor,  # [N, H, W, C]
    w: torch.Tensor,  # [K, C, 3, 3]
    b: torch.Tensor,  # [K]
    res: Optional[torch.Tensor] = None,  # [N, H, W, K], added in the epilogue
    use_kernel: bool = False,
    u: Optional[torch.Tensor] = None,  # kernels.winograd.weight_transform(w), when cached by the caller
) -> torch.Tensor:
    """3×3 stride-1 SAME conv + bias (+ res) -> [N, H, W, K] in x's type.
    Differentiable in x, w, b and res."""
    if not (use_kernel and supports(x.shape, w.shape)):
        return reference_conv(x, w, b, res)
    if u is None:
        u = _k.weight_transform(w)
    x = x.contiguous()
    res = None if res is None else res.to(x.dtype).contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b, res)):
        return _Conv3x3.apply(x, w, b, res, u)
    return _k.winograd_conv(x, u, b.to(x.dtype).float(), res)
