"""Exact softmax attention kernels over [B, S, H, D] row-strided views.
Source: ``csrc/attention.cu``.

Replaces ``_kernel_whole_row`` and ``_kernel`` (the online-softmax loop over
key blocks, taken for S_kv > 2048) of
``diffusion_uncertainty_tpu/ops/flash_attention.py`` and ``_kernel`` of
``diffusion_uncertainty_tpu/ops/packed_attention.py``: all compute
softmax(QKᵀ/√d)V with float32 logits. q, k and v may be views into one qkv
projection (any batch/sequence/head strides, last axis contiguous), so
neither attention order needs a copy. Head dims: multiples of 8 up to 512.

The wrapper takes its plain version for CPU tensors and launches a kernel
for CUDA tensors, by one of three routes (``route``): ``tensor_core`` (bf16 at
the head dims in ``TC_HEAD_DIMS``, rows on 16 bytes), ``wide`` (256 < D <= 512,
bf16 and float32; its keys split over ``wide_splits`` blocks, merged by a
second kernel, counted as ``split_combine``) and ``cuda_core`` (everything
else up to D=256). Launches over more than ``LONG_KEYS`` keys count as
``attention_long``, the others as ``attention`` (``_build.LAUNCHES``); the
route of each launch counts in ``ROUTE_LAUNCHES``.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = [
    "attention", "attention_plain", "attention_split_plain", "route", "wide_splits", "split_chunk",
    "MAX_HEAD_DIM", "LONG_KEYS", "TC_HEAD_DIMS", "ROUTES", "ROUTE_LAUNCHES",
]

MAX_HEAD_DIM = 512
WIDE_MIN_HEAD_DIM = 257  # head dims from here to MAX_HEAD_DIM take the wide route
# key counts above this are the Pallas flash ``_kernel``'s regime
# (``_WHOLE_ROW_MAX_S``, flash_attention.py:119)
LONG_KEYS = 2048
# bf16 head dims with a tensor-core instance: SD 1.5 (40, 80, 160), ADM-128
# and the CIFAR-10 UNet (64, 128, 192, 256), U-ViT-huge (72)
TC_HEAD_DIMS = (40, 64, 72, 80, 128, 160, 192, 256)
WIDE_Q_TILE = 64  # query rows of a wide-route block (csrc kWQ)
WIDE_KEY_TILE = 16  # keys of a wide-route tile (kWK); a split holds whole tiles
MAX_SPLITS = 16  # kMaxSplits
NUM_SMS = 132  # H100 SXM; a wide-route block fills an SM (219 KB of shared memory in float32)

ROUTES = ("tensor_core", "cuda_core", "wide", "split_combine")
# launches by route: each wrapper call adds one to the route it launched, and
# ``split_combine`` one more where the wide route merged split partials
ROUTE_LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong


def _lib():
    lib = _build.load("attention")
    if not getattr(lib, "_typed", False):
        lib.du_attention_tc.argtypes = [_P] * 4 + [_I] * 5 + [_L] * 9 + [_F, _P]
        lib.du_attention_wide.argtypes = [_P] * 6 + [_I] * 7 + [_L] * 9 + [_F, _I, _P]
        lib.du_attention_cuda_core.argtypes = [_P] * 4 + [_I] * 6 + [_L] * 9 + [_F, _I, _P]
        for fn in (lib.du_attention_tc, lib.du_attention_wide, lib.du_attention_cuda_core):
            fn.restype = _I
        lib._typed = True
    return lib


def route(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The kernel a launch takes: ``aligned`` means every row of q, k and v
    starts on 16 bytes, which the tensor-core and wide kernels' cp.async
    staging needs."""
    if d >= WIDE_MIN_HEAD_DIM:
        if not aligned:
            raise ValueError(f"attention: head dim {d} > 256 needs q, k, v rows on 16-byte boundaries")
        return "wide"
    if dtype == torch.bfloat16 and aligned and d in TC_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def wide_splits(b: int, s: int, h: int, n_keys: int) -> int:
    """Key splits of a wide-route launch: none where the query tiles alone
    fill the SMs; otherwise the count up to ``MAX_SPLITS`` (and the number of
    key tiles) that finishes the grid of one block per SM in the least time,
    ceil(blocks / sms) / splits, the smallest on a tie."""
    base = -(-s // WIDE_Q_TILE) * h * b
    if base >= NUM_SMS:
        return 1
    tiles = -(-n_keys // WIDE_KEY_TILE)
    best, best_t = 1, 1.0
    for n in range(2, min(MAX_SPLITS, tiles) + 1):
        t = -(-base * n // NUM_SMS) / n
        if t < best_t:
            best, best_t = n, t
    return best


def split_chunk(n_keys: int, n_splits: int) -> tuple[int, int]:
    """(keys per split, splits used): whole key tiles per split, every split
    with at least one key below ``n_keys``."""
    tiles = -(-n_keys // WIDE_KEY_TILE)
    chunk = -(-tiles // n_splits) * WIDE_KEY_TILE
    return chunk, -(-n_keys // chunk)


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


def attention_split_plain(q, k, v, kv_len: Optional[int] = None, n_splits: int = 1):
    """The wide route's arithmetic in plain PyTorch: the keys below
    ``min(kv_len, S_kv)`` cut into ``split_chunk`` chunks; per chunk j the
    largest scaled logit m_j, P_j = exp(s - m_j), l_j = sum P_j (float32) and
    O_j = P_j V with P_j rounded to the value type; then the combine,
    out = sum_j w_j O_j / sum_j w_j l_j with w_j = exp(m_j - max_j m_j)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    n_keys = k.shape[1] if kv_len is None else min(int(kv_len), k.shape[1])
    chunk, n = split_chunk(n_keys, n_splits)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k[:, :n_keys].float()) * scale
    ms, ls, os_ = [], [], []
    for j in range(n):
        lo, hi = j * chunk, min(n_keys, (j + 1) * chunk)
        s_j = logits[..., lo:hi]
        m_j = s_j.amax(dim=-1, keepdim=True)
        p_j = torch.exp(s_j - m_j)
        ms.append(m_j)
        ls.append(p_j.sum(dim=-1, keepdim=True))
        os_.append(torch.einsum("bhqk,bkhd->bhqd", p_j.to(v.dtype).float(), v[:, lo:hi].float()))
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(dim=0))
    out = (w * torch.stack(os_)).sum(dim=0) / (w * torch.stack(ls)).sum(dim=0)
    return out.permute(0, 2, 1, 3).to(q.dtype)


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
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("attention: the head axis must be contiguous")
    _build.require_cuda("attention", q, k, v)
    n_keys = s_kv if kv_len is None else min(int(kv_len), s_kv)
    if n_keys < 1:
        raise ValueError("attention: kv_len must be >= 1")
    dtype = _build.dtype_code(q)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    st = q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    per16 = 16 // q.element_size()
    aligned = not ((ptrs[0] | ptrs[1] | ptrs[2]) % 16 or any(x % per16 for x in st))
    which = route(q.dtype, d, aligned)
    scale = 1.0 / math.sqrt(d)
    stream = _build.stream_ptr(q)
    lib = _lib()
    n_splits = 1
    if which == "tensor_core":
        err = lib.du_attention_tc(*ptrs, b, s, h, d, n_keys, *st, scale, stream)
    elif which == "wide":
        chunk, n_splits = split_chunk(n_keys, wide_splits(b, s, h, n_keys))
        ws_o = ws_ml = None
        if n_splits > 1:
            ws_o = torch.empty((n_splits, b, h, s, d), dtype=torch.float32, device=q.device)
            ws_ml = torch.empty((n_splits, b, h, s, 2), dtype=torch.float32, device=q.device)
        err = lib.du_attention_wide(
            *ptrs, None if ws_o is None else ws_o.data_ptr(), None if ws_ml is None else ws_ml.data_ptr(),
            b, s, h, d, n_keys, chunk, n_splits, *st, scale, dtype, stream,
        )
    else:
        err = lib.du_attention_cuda_core(*ptrs, b, s, s_kv, h, d, n_keys, *st, scale, dtype, stream)
    _build.check(lib, err, "attention")
    ROUTE_LAUNCHES[which] += 1
    if n_splits > 1:
        ROUTE_LAUNCHES["split_combine"] += 1
    _build.LAUNCHES["attention_long" if s_kv > LONG_KEYS else "attention"] += 1
    return out
