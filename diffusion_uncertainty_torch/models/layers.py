"""Shared layers of the model zoo, NHWC.

JAX counterpart: ``diffusion_uncertainty_tpu/models/layers.py``. Modules keep
the reference's torch parameter layout (``Conv2d`` weights [K, C, kh, kw],
``Conv1d`` 1×1 attention projections), so reference state dicts load as
they are. Convolutions run on cuDNN through channels_last views of the NHWC
activations; GroupNorm, attention, pooling and the upsample interleave run
through ``ops`` (Hopper kernels for CUDA tensors), and a ``Conv3x3`` built
with ``winograd=True`` through the Winograd kernel op.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..kernels.winograd import weight_transform
from ..ops.attention import dot_product_attention
from ..ops.avgpool import avg_pool_2x2
from ..ops.fused_upsample import conv2d_nhwc, conv3x3_nearest_up2, conv3x3_nearest_up2_phases
from ..ops.groupnorm import group_norm_silu
from ..ops.winograd_conv import conv3x3_winograd, reference_conv, supports

__all__ = [
    "timestep_embedding",
    "GroupNorm32",
    "AttentionBlock",
    "nearest_upsample",
    "avg_pool_2x",
    "Conv2d",
    "Conv3x3",
    "split_qkv",
    "dropout",
]


def timestep_embedding(
    timesteps,
    dim: int,
    max_period: float = 10000.0,
    *,
    cos_first: bool = True,
    freq_shift: float = 0.0,
    device=None,
) -> torch.Tensor:
    """Sinusoidal timestep embedding [B, dim], float32.

    ADM: ``cos_first=True, freq_shift=0`` (output [cos, sin]); DDPM/HF
    ``Timesteps``: ``cos_first=False, freq_shift=1`` (output [sin, cos])."""
    t = torch.as_tensor(timesteps, device=device).float()
    if t.ndim == 0:
        t = t[None]
    half = dim // 2
    denom = max(half - freq_shift, 1.0)
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / denom
    )
    args = t[:, None] * freqs[None, :]
    parts = (torch.cos(args), torch.sin(args)) if cos_first else (torch.sin(args), torch.cos(args))
    emb = torch.cat(parts, dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm over min(32, C) groups with float32 statistics, no SiLU.
    Parameters ``weight``/``bias`` as torch's GroupNorm."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(x, self.weight, self.bias, num_groups=self.num_groups, eps=self.eps, apply_silu=False)


def dropout(h: torch.Tensor, rate: float, noise) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate (one
    ``noise.bernoulli`` mask of h's shape), scale what is kept by
    1 / (1 - rate) in h's type. Identity when ``noise`` is None (the
    deterministic forward) or the rate is 0."""
    if noise is None or rate == 0.0:
        return h
    if rate == 1.0:
        return torch.zeros_like(h)
    keep = 1.0 - rate
    mask = noise.bernoulli(h.shape, keep, h.device)
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour ×factor spatial upsample (NHWC)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 average pool (NHWC), ADM's non-conv downsample."""
    return avg_pool_2x2(x)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC activations, with an optional fused residual
    add: ``conv(x) + res``."""

    def forward(self, x: torch.Tensor, res=None) -> torch.Tensor:
        y = conv2d_nhwc(x, self.weight, self.bias, stride=self.stride[0], padding=self.padding[0])
        return y if res is None else y.add_(res)


class Conv3x3(Conv2d):
    """3×3 stride-1 SAME conv (NHWC). ``up2=True`` computes
    conv3x3(nearest_upsample_2x(x)) as four low-resolution phase convs and one
    interleave (``ops.fused_upsample``). ``winograd=True`` (the port's form
    of the JAX package's ``DU_TPU_WINOGRAD=1``) routes every call whose shape
    ``ops.winograd_conv.supports`` takes through the Winograd kernel op, with
    the residual fused; the transformed weights are computed once and cached
    on the module until the weight changes. The ``up2`` conv never takes it,
    as in the JAX ``Conv3x3``."""

    def __init__(self, in_channels: int, out_channels: int, up2: bool = False, winograd: bool = False):
        super().__init__(in_channels, out_channels, 3, padding=1)
        self.up2 = up2
        self.winograd = winograd and not up2
        self._wino_cache: dict = {}

    def winograd_weights(self, lo: int = 0, hi=None) -> torch.Tensor:
        """``weight_transform`` of input channels [lo, hi), cached until the
        weight is another tensor or its storage, version or type changes."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        hit = self._wino_cache.get((lo, hi))
        if hit is None or hit[0] is not w or hit[1] != key:
            hit = (w, key, weight_transform(w[:, lo:hi]))
            self._wino_cache[(lo, hi)] = hit
        return hit[2]

    def partial(self, x: torch.Tensor, lo: int, hi, bias: torch.Tensor, res=None) -> torch.Tensor:
        """The conv of x with input channels [lo, hi) of the weight, + bias
        (+ res): the Winograd route where the module has it and the shape is
        supported, the direct conv otherwise."""
        w = self.weight[:, lo:hi]
        if self.winograd and supports(x.shape, w.shape):
            return conv3x3_winograd(x, w, bias, res, use_kernel=True, u=self.winograd_weights(lo, hi))
        return reference_conv(x, w, bias, res)

    def phases(self, x: torch.Tensor) -> list:
        """The ``up2`` conv's four low-resolution phase convs, before their
        interleave (``ops.fused_upsample.conv3x3_nearest_up2_phases``)."""
        return conv3x3_nearest_up2_phases(x, self.weight, self.bias)

    def forward(self, x: torch.Tensor, res=None) -> torch.Tensor:
        if self.up2:
            if res is not None:
                raise ValueError("the up2 conv has no fused residual")
            return conv3x3_nearest_up2(x, self.weight, self.bias)
        if self.winograd:
            return self.partial(x, 0, None, self.bias, res)
        return super().forward(x, res)


def split_qkv(qkv: torch.Tensor, heads: int, legacy: bool):
    """Views q, k, v [B, S, H, D] of a [B, S, 3·C] qkv projection, no copy.

    The reference's two weight orders: legacy packs rows per head
    (``[q_h0|k_h0|v_h0|q_h1|…]``), the new order packs qkv-major."""
    b, s, c3 = qkv.shape
    d = c3 // (3 * heads)
    if legacy:
        return qkv.view(b, s, heads, 3, d).unbind(3)
    return qkv.view(b, s, 3, heads, d).unbind(2)


class AttentionBlock(nn.Module):
    """Spatial self-attention over H·W tokens: GroupNorm -> qkv projection ->
    multi-head attention -> output projection -> residual. Parameters as the
    reference's ``AttentionBlock`` (1×1 ``Conv1d`` qkv and proj_out); both
    attention orders read q/k/v straight out of the projection."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1, legacy_order: bool = True):
        super().__init__()
        if num_head_channels > 0:
            assert channels % num_head_channels == 0, (channels, num_head_channels)
            num_heads = channels // num_head_channels
        self.num_heads = num_heads
        self.legacy_order = legacy_order
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.norm(x).reshape(b, h * w, c)
        qkv = torch.nn.functional.linear(y, self.qkv.weight.view(3 * c, c), self.qkv.bias)
        q, k, v = split_qkv(qkv, self.num_heads, self.legacy_order)
        out = dot_product_attention(q, k, v).reshape(b, h * w, c)
        out = torch.nn.functional.linear(out, self.proj_out.weight.view(c, c), self.proj_out.bias)
        return x + out.reshape(b, h, w, c)
