"""Exact softmax attention kernel over [B, S, H, D] row-strided views.
Source: ``csrc/attention.cu``.

Replaces ``_kernel_whole_row`` and ``_kernel`` (the online-softmax loop over
key blocks, taken for S_kv > 2048) of
``diffusion_uncertainty_tpu/ops/flash_attention.py`` and ``_kernel`` of
``diffusion_uncertainty_tpu/ops/packed_attention.py``: all compute
softmax(QKᵀ/√d)V with float32 logits. q, k and v may be views into one qkv
projection (any batch/sequence/head strides, last axis contiguous), so
neither attention order needs a copy. Head dims: multiples of 8 up to 512.
The wrapper takes its plain version for CPU tensors and launches the kernel
for CUDA tensors; launches over more than ``LONG_KEYS`` keys count as
``attention_long``, the others as ``attention`` (``_build.LAUNCHES``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["attention", "attention_plain", "MAX_HEAD_DIM", "LONG_KEYS"]

MAX_HEAD_DIM = 512
# key counts above this are the Pallas flash ``_kernel``'s regime
# (``_WHOLE_ROW_MAX_S``, flash_attention.py:119)
LONG_KEYS = 2048

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("attention")
    if not getattr(lib, "_typed", False):
        lib.du_attention.argtypes = [_P] * 4 + [_I] * 6 + [_P, ctypes.c_float, _I, _I, _P]
        lib.du_attention.restype = _I
        lib._typed = True
    return lib


def attention_plain(q, k, v, kv_len: Optional[int] = None):
    """float32 logits, exact softmax, float32 weights @ V; output in q's type
    (``_xla_attention``, with ``kv_len`` masking as in the flash kernel)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_len is not None and kv_len < k.shape[1]:
        mask = torch.arange(k.shape[1], device=q.device) < kv_len
        logits = logits.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: Optional[int] = None) -> torch.Tensor:
    """softmax(QKᵀ/√d)V for q [B, S, H, D], k/v [B, S_kv, H, D] -> contiguous
    [B, S, H, D]. Keys at or past ``kv_len`` get zero weight."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_len)
    b, s, h, d = q.shape
    s_kv = k.shape[1]
    if k.shape != (b, s_kv, h, d) or v.shape != k.shape:
        raise ValueError(f"attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"attention: head dim {d} must be a multiple of 8 and <= {MAX_HEAD_DIM}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("attention: q, k, v must share a dtype")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention: the head axis must be contiguous")
    _build.require_cuda("attention", q, k, v)
    n_keys = s_kv if kv_len is None else min(int(kv_len), s_kv)
    if n_keys < 1:
        raise ValueError("attention: kv_len must be >= 1")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    st = [x for t in (q, k, v) for x in t.stride()[:3]]
    # rows on 16-byte boundaries let the tensor-core path use 16-byte loads
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v)) and all(x % 8 == 0 for x in st)
    strides = (ctypes.c_longlong * 9)(*st)
    lib = _lib()
    err = lib.du_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, s_kv, h, d, n_keys,
        ctypes.cast(strides, _P), 1.0 / math.sqrt(d), _build.dtype_code(q), int(aligned), _build.stream_ptr(q),
    )
    _build.check(lib, err, "attention")
    _build.LAUNCHES["attention_long" if s_kv > LONG_KEYS else "attention"] += 1
    return out
