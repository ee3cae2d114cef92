"""Attention dispatch.

JAX counterpart: ``diffusion_uncertainty_tpu/ops/attention.py``
(``dot_product_attention``). For CPU tensors the plain version runs
(float32 logits, exact softmax); for CUDA tensors one
Hopper kernel, ``kernels.attention.attention``, serves every head dim the
JAX package split between its whole-row flash and packed-head kernels. The
plain version (the JAX ``_xla_attention``) is
``kernels.attention.attention_plain``. The TPU-only bounded-logit softmax is
not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import attention as _k

__all__ = ["dot_product_attention"]

def dot_product_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S_kv, H, D]
    v: torch.Tensor,  # [B, S_kv, H, D]
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """softmax(QKᵀ/√d)V with float32 logits, output [B, S, H, D] in q's type.
    q, k, v may be strided views (e.g. slices of one qkv projection); keys at
    or past ``kv_len`` get zero weight."""
    return _k.attention(q, k, v, kv_len)
