"""Fused GroupNorm(+scale-shift)(+SiLU), with its gradient.

JAX counterpart: ``diffusion_uncertainty_tpu/ops/groupnorm.py``
(``group_norm_silu``, ``_pallas_gn`` and its VJP ``_pallas_gn_bwd``). For CPU
tensors the op runs its plain version, ``_reference_impl`` (two-pass float32
statistics); for CUDA tensors ``kernels.groupnorm.group_norm``: one launch of
the Hopper cluster kernel, or the ``gn_stats`` + ``gn_apply`` pair for groups
beyond 8 blocks (the route is chosen from the shape before the launch). The
backward is autograd through ``_reference_impl``, as ``_pallas_gn_bwd`` is
``jax.vjp`` of it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import groupnorm as _k

__all__ = ["group_norm_silu"]


def _reference_impl(x, gamma, beta, num_groups, eps, scale, shift, apply_silu):
    b, h, w, c = x.shape
    gs = c // num_groups
    xf = x.float().reshape(b, h * w, num_groups, gs)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(b, h, w, c) * gamma.float() + beta.float()
    if scale is not None:
        y = y * (1.0 + scale.float().reshape(b, 1, 1, c)) + shift.float().reshape(b, 1, 1, c)
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _forward(x, gamma, beta, scale, shift, num_groups, eps, apply_silu):
    """The kernels on a CUDA tensor, ``_reference_impl`` on the CPU."""
    if x.device.type == "cpu":
        return _reference_impl(x, gamma, beta, num_groups, eps, scale, shift, apply_silu)
    return _k.group_norm(x, gamma, beta, num_groups, eps, scale, shift, apply_silu)


class _GroupNorm(torch.autograd.Function):
    """``_forward``; backward by autograd through ``_reference_impl`` on the
    saved inputs."""

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, num_groups, eps, apply_silu):
        ctx.save_for_backward(x, gamma, beta, scale, shift)
        ctx.args = (num_groups, eps, apply_silu)
        return _forward(x, gamma, beta, scale, shift, num_groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            x, gamma, beta, scale, shift = ins
            if scale is not None:
                b, c = x.shape[0], x.shape[-1]
                scale, shift = scale.reshape(b, 1, 1, c), shift.reshape(b, 1, 1, c)
            y = _reference_impl(x, gamma, beta, *ctx.args[:2], scale, shift, ctx.args[2])
            wrt = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
        return tuple(next(got) if n else None for n in need) + (None, None, None)


def group_norm_silu(
    x: torch.Tensor,  # [B, H, W, C]
    gamma: torch.Tensor,  # [C]
    beta: torch.Tensor,  # [C]
    num_groups: int = 32,
    eps: float = 1e-5,
    scale: Optional[torch.Tensor] = None,  # [B, C] or [B, 1, 1, C]
    shift: Optional[torch.Tensor] = None,
    apply_silu: bool = True,
) -> torch.Tensor:
    """GroupNorm over min(num_groups, C) groups with affine, optional
    (1+scale)·y+shift and optional SiLU; output in x's type."""
    c = x.shape[-1]
    num_groups = min(num_groups, c)
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must be passed together")
    if c % num_groups:
        raise ValueError(f"C={c} is not divisible by num_groups={num_groups}")
    args = (x.contiguous(), gamma, beta, scale, shift, num_groups, eps, apply_silu)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args[:5]):
        return _GroupNorm.apply(*args)
    return _forward(*args)  # no graph to record: skip the autograd.Function's per-call cost
