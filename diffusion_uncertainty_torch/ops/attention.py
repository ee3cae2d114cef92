"""Attention dispatch, with its gradient.

JAX counterpart: ``diffusion_uncertainty_tpu/ops/attention.py``
(``dot_product_attention``, ``_flash_with_xla_grad`` / ``_packed_with_xla_grad``
and their VJP ``_flash_bwd``). For CPU tensors the plain version runs
(float32 logits, exact softmax); for CUDA tensors
``kernels.attention.attention`` serves every head dim and key length the JAX
package split between its whole-row flash, long-key flash and packed-head
kernels, by one of three Hopper kernels (tensor core, wide head, CUDA core). The plain version (the JAX ``_xla_attention``) is
``kernels.attention.attention_plain``. The backward is eager float32 math,
as ``_flash_bwd``. The TPU-only bounded-logit softmax is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import attention as _k

__all__ = ["dot_product_attention", "attention_bwd"]


def attention_bwd(q, k, v, g, kv_len: Optional[int] = None):
    """(dq, dk, dv) of softmax(QKᵀ/√d)V for the output cotangent ``g``:
    ``_flash_bwd``'s float32 math (masked keys get a -1e30 logit), one batch
    item at a time so the [H, S, S_kv] float32 logits of only one item are
    alive at once."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s_kv = k.shape[1]
    mask = None
    if kv_len is not None and kv_len < s_kv:
        mask = torch.arange(s_kv, device=q.device) >= kv_len
    grads = ([], [], [])
    for i in range(q.shape[0]):
        qf, kf, vf, gf = (t[i].float() for t in (q, k, v, g))
        logits = torch.einsum("qhd,khd->hqk", qf, kf) * scale
        if mask is not None:
            logits = logits.masked_fill(mask, -1e30)
        w = torch.softmax(logits, dim=-1)
        del logits
        grads[2].append(torch.einsum("hqk,qhd->khd", w, gf))
        dw = torch.einsum("qhd,khd->hqk", gf, vf)
        ds = w * (dw - torch.sum(dw * w, dim=-1, keepdim=True))
        del w, dw
        grads[0].append(torch.einsum("hqk,khd->qhd", ds, kf) * scale)
        grads[1].append(torch.einsum("hqk,qhd->khd", ds, qf) * scale)
    return tuple(torch.stack(gs).to(t.dtype) for gs, t in zip(grads, (q, k, v)))


class _Attention(torch.autograd.Function):
    """The kernel forward (its plain version on the CPU), ``attention_bwd``
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.kv_len = kv_len
        return _k.attention(q, k, v, kv_len)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, g, ctx.kv_len)
        return dq, dk, dv, None


def dot_product_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S_kv, H, D]
    v: torch.Tensor,  # [B, S_kv, H, D]
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """softmax(QKᵀ/√d)V with float32 logits, output [B, S, H, D] in q's type.
    q, k, v may be strided views (e.g. slices of one qkv projection); keys at
    or past ``kv_len`` get zero weight. Differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, kv_len)
    return _k.attention(q, k, v, kv_len)
