"""Stable-Diffusion conditional UNet (diffusers ``UNet2DConditionModel``) in
PyTorch, NHWC activations.

JAX counterpart: ``diffusion_uncertainty_tpu/models/sd_unet.py``
(``SDUNetConfig``, ``_CrossAttention``, ``_BasicTransformerBlock``,
``Transformer2D``, ``SDUNet``, :37-262). The module tree and parameter names
are diffusers' (``down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q
.weight``, ...), so a diffusers state dict loads with ``load_state_dict``;
``convert.sd_unet_state_dict_from_flax`` gives the same dict from the JAX
package's parameters. The forward follows the JAX model: GroupNorm through
the kernel pair, every attention (self and the 77-token cross-attention)
through the attention kernel, exact-erf GELU in the GEGLU feed-forward,
float32 LayerNorm, the up blocks' upsample fused into their conv
(``Conv3x3(up2=True)``), float32 output. ``remat`` is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from ..ops.groupnorm import group_norm_silu
from .layers import Conv2d, Conv3x3, GroupNorm32, timestep_embedding
from .unet2d import ResnetBlock2D

__all__ = ["SDUNetConfig", "SDUNet", "Transformer2D"]


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    cross_attention_dim: int = 768
    transformer_layers_per_block: int = 1
    # int: the same head count at every level (SD 1.x); tuple: per level
    num_attention_heads: Union[int, Tuple[int, ...]] = 8
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    # route the ResnetBlock2D 3x3 convs through the Winograd kernel op where
    # the shape allows (the JAX package's DU_TPU_WINOGRAD=1); off by default
    winograd: bool = False

    @staticmethod
    def sd15() -> "SDUNetConfig":
        """runwayml/stable-diffusion-v1-5 UNet (859.5M parameters)."""
        return SDUNetConfig()

    @staticmethod
    def sd21() -> "SDUNetConfig":
        """stabilityai/stable-diffusion-2-1-base UNet (865.9M parameters):
        1024-wide context, 64-wide heads, linear transformer projections."""
        return SDUNetConfig(cross_attention_dim=1024, num_attention_heads=(5, 10, 20, 20), use_linear_projection=True)

    @staticmethod
    def tiny() -> "SDUNetConfig":
        """Small test configuration (as the JAX package's)."""
        return SDUNetConfig(
            sample_size=8,
            block_out_channels=(32, 64),
            layers_per_block=1,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            cross_attention_dim=16,
            num_attention_heads=2,
        )

    def heads_at(self, level: int) -> int:
        if isinstance(self.num_attention_heads, tuple):
            return self.num_attention_heads[level]
        return self.num_attention_heads


def _linear_or_1x1(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Linear, or a 1×1 Conv2d applied to tokens as the same matmul."""
    w = layer.weight
    return F.linear(x, w.reshape(w.shape[0], w.shape[1]), layer.bias)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in float32, output in x's type (``nn.LayerNorm(dtype=f32)``
    then the cast back)."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps)
    return y.to(x.dtype)


class _CrossAttention(nn.Module):
    """diffusers ``Attention``: bias-free q/k/v projections, biased output."""

    def __init__(self, c: int, heads: int, c_ctx: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(c, c, bias=False)
        self.to_k = nn.Linear(c_ctx, c, bias=False)
        self.to_v = nn.Linear(c_ctx, c, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        b, l, c = x.shape
        ctx = x if context is None else context
        hd = c // self.heads
        q = self.to_q(x).reshape(b, l, self.heads, hd)
        k = self.to_k(ctx).reshape(b, -1, self.heads, hd)
        v = self.to_v(ctx).reshape(b, -1, self.heads, hd)
        out = dot_product_attention(q, k, v).reshape(b, l, c)
        return self.to_out[0](out)


class _GEGLU(nn.Module):
    def __init__(self, c: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(c, 2 * inner)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        val, gate = self.proj(h).chunk(2, dim=-1)
        return val * F.gelu(gate.float(), approximate="none").to(val.dtype)


class _FeedForward(nn.Module):
    """diffusers ``FeedForward``: ``net`` = [GEGLU, Dropout, Linear]."""

    def __init__(self, c: int):
        super().__init__()
        self.net = nn.ModuleList([_GEGLU(c, 4 * c), nn.Dropout(0.0), nn.Linear(4 * c, c)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](h))


class _BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention, pre-LN cross-attention, pre-LN GEGLU
    feed-forward, each residual."""

    def __init__(self, c: int, heads: int, c_ctx: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(c, eps=1e-5)
        self.attn1 = _CrossAttention(c, heads, c)
        self.norm2 = nn.LayerNorm(c, eps=1e-5)
        self.attn2 = _CrossAttention(c, heads, c_ctx)
        self.norm3 = nn.LayerNorm(c, eps=1e-5)
        self.ff = _FeedForward(c)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(_layer_norm(self.norm1, x))
        x = x + self.attn2(_layer_norm(self.norm2, x), context)
        return x + self.ff(_layer_norm(self.norm3, x))


class Transformer2D(nn.Module):
    """diffusers ``Transformer2DModel``: GroupNorm (eps 1e-6, no SiLU) ->
    proj_in -> transformer blocks -> proj_out -> residual. ``proj_in`` and
    ``proj_out`` are 1×1 convs (SD 1.x) or Linears (``use_linear_projection``);
    either is one matmul over the NHWC tokens."""

    def __init__(self, c: int, heads: int, depth: int, c_ctx: int, groups: int = 32, linear_proj: bool = False):
        super().__init__()
        self.groups = groups
        self.norm = GroupNorm32(c, groups, eps=1e-6)
        proj = (lambda: nn.Linear(c, c)) if linear_proj else (lambda: nn.Conv2d(c, c, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList([_BasicTransformerBlock(c, heads, c_ctx) for _ in range(depth)])
        self.proj_out = proj()

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = group_norm_silu(x, self.norm.weight, self.norm.bias, self.groups, 1e-6, apply_silu=False)
        tokens = _linear_or_1x1(self.proj_in, y.reshape(b, h * w, c))
        for blk in self.transformer_blocks:
            tokens = blk(tokens, context)
        tokens = _linear_or_1x1(self.proj_out, tokens)
        return x + tokens.reshape(b, h, w, c)


class _TimestepEmbedding(nn.Module):
    def __init__(self, c: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(c, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t)))


class _Sampler(nn.Module):
    """Holder of a down- or upsampler's ``conv`` (diffusers key layout)."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


class _Block(nn.Module):
    """A down or up block: ``resnets``, optional ``attentions`` and a
    ``downsamplers``/``upsamplers`` list of one, as diffusers names them."""

    def __init__(self, resnets, attentions, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        if sampler is not None:
            self.add_module(sampler_name, nn.ModuleList([_Sampler(sampler)]))


class _MidBlock(nn.Module):
    def __init__(self, resnets, attentions):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)


class SDUNet(nn.Module):
    """``forward(x [B,H,W,C], t, encoder_hidden_states [B,S,D_ctx])`` ->
    [B,H,W,out_channels] float32 epsilon. ``t`` is an int or a [B] / [1]
    tensor of train timesteps."""

    def __init__(self, cfg: SDUNetConfig):
        super().__init__()
        self.cfg = cfg
        b0 = cfg.block_out_channels[0]
        temb = 4 * b0
        groups, depth, c_ctx = cfg.norm_num_groups, cfg.transformer_layers_per_block, cfg.cross_attention_dim
        n_levels = len(cfg.block_out_channels)

        def xf(c, level):
            return Transformer2D(c, cfg.heads_at(level), depth, c_ctx, groups, cfg.use_linear_projection)

        self.time_embedding = _TimestepEmbedding(b0, temb)
        self.conv_in = Conv3x3(cfg.in_channels, b0)
        ch = b0
        skip_chs = [ch]
        self.down_blocks = nn.ModuleList()
        for bi, (btype, out_ch) in enumerate(zip(cfg.down_block_types, cfg.block_out_channels)):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, temb, groups, winograd=cfg.winograd))
                ch = out_ch
                if btype == "CrossAttnDownBlock2D":
                    attns.append(xf(ch, bi))
                skip_chs.append(ch)
            down = None
            if bi != n_levels - 1:
                down = Conv2d(ch, ch, 3, stride=2, padding=1)
                skip_chs.append(ch)
            self.down_blocks.append(_Block(resnets, attns, "downsamplers", down))

        self.mid_block = _MidBlock(
            [ResnetBlock2D(ch, ch, temb, groups, winograd=cfg.winograd) for _ in range(2)], [xf(ch, n_levels - 1)]
        )

        self.up_blocks = nn.ModuleList()
        for bi, (btype, out_ch) in enumerate(zip(cfg.up_block_types, reversed(cfg.block_out_channels))):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch + skip_chs.pop(), out_ch, temb, groups, winograd=cfg.winograd))
                ch = out_ch
                if btype == "CrossAttnUpBlock2D":
                    attns.append(xf(ch, n_levels - 1 - bi))
            up = Conv3x3(ch, ch, up2=True) if bi != n_levels - 1 else None
            self.up_blocks.append(_Block(resnets, attns, "upsamplers", up))

        self.conv_norm_out = GroupNorm32(ch, groups, eps=1e-5)
        self.conv_out = Conv3x3(ch, cfg.out_channels)

    def forward(self, x: torch.Tensor, t, encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = self.conv_in.weight.dtype
        ctx = encoder_hidden_states.to(dt)
        temb = timestep_embedding(t, cfg.block_out_channels[0], cos_first=True, device=x.device)
        temb = self.time_embedding(temb.to(dt))
        if temb.shape[0] == 1 and x.shape[0] > 1:
            temb = temb.expand(x.shape[0], -1)

        h = self.conv_in(x.to(dt))
        skips = [h]
        for blk in self.down_blocks:
            for li, res in enumerate(blk.resnets):
                h = res(h, temb)
                if blk.attentions is not None:
                    h = blk.attentions[li](h, ctx)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, ctx)
        h = mid.resnets[1](h, temb)

        for blk in self.up_blocks:
            for li, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=-1), temb)
                if blk.attentions is not None:
                    h = blk.attentions[li](h, ctx)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(h)

        h = group_norm_silu(h, self.conv_norm_out.weight, self.conv_norm_out.bias, cfg.norm_num_groups, 1e-5)
        return self.conv_out(h).float()
