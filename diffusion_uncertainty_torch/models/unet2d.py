"""HF-diffusers ``UNet2DModel`` (the DDPM CIFAR-10 UNet) in PyTorch, NHWC.

JAX counterpart: ``diffusion_uncertainty_tpu/models/unet2d.py``
(``UNet2DConfig``, ``ResnetBlock2D``, ``SelfAttention2D``, ``_Down``,
``UNet2D``). Parameter names are those of the diffusers checkpoint
``google/ddpm-cifar10-32`` (``time_embedding.linear_1``,
``down_blocks.1.attentions.0.query``, ``up_blocks.0.upsamplers.0.conv``, ...),
the keys ``convert_unet2d`` reads, so its state dict loads as it is;
``convert.unet2d_state_dict_from_flax`` gives the same dict from the JAX
package's parameters. ``ResnetBlock2D`` is also the block of the SD UNet.

MC dropout: a forward given a noise source (``forward(..., noise=...)``)
applies dropout after each ResnetBlock2D's second GroupNorm+SiLU, as the
JAX model with ``deterministic=False``; without one the forward is
deterministic. ``winograd=True`` routes every ResnetBlock2D 3×3 conv through
the Winograd kernel op where the shape allows (``UNet2DConfig.winograd``, the
port's form of ``DU_TPU_WINOGRAD=1``); ``conv_in``, ``conv_out``, the
stride-2 downsample convs (cuDNN) and the fused upsample convs never take it,
as in the JAX model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from ..ops.fused_upsample import conv2d_nhwc
from ..ops.groupnorm import group_norm_silu
from .layers import Conv2d, Conv3x3, GroupNorm32, dropout, timestep_embedding

__all__ = ["UNet2DConfig", "UNet2D", "ResnetBlock2D", "SelfAttention2D"]


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    sample_size: int = 32
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 256)
    layers_per_block: int = 2
    down_block_types: Tuple[str, ...] = ("DownBlock2D", "AttnDownBlock2D", "DownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = ("UpBlock2D", "UpBlock2D", "AttnUpBlock2D", "UpBlock2D")
    attention_head_dim: Optional[int] = None  # None: one head over all channels
    dropout: float = 0.0
    norm_num_groups: int = 32
    flip_sin_to_cos: bool = False
    freq_shift: float = 1.0
    downsample_padding: int = 0  # 0: DDPM asymmetric (0, 1, 0, 1) padding
    num_class_embeds: Optional[int] = None
    # route the ResnetBlock2D 3x3 convs through the Winograd kernel op
    winograd: bool = False

    @staticmethod
    def ddpm_cifar10(dropout: float = 0.0) -> "UNet2DConfig":
        """google/ddpm-cifar10-32 with the reference's dropout override."""
        return UNet2DConfig(dropout=dropout)

    @staticmethod
    def tiny() -> "UNet2DConfig":
        return UNet2DConfig(
            sample_size=16,
            block_out_channels=(32, 64),
            layers_per_block=1,
            down_block_types=("DownBlock2D", "AttnDownBlock2D"),
            up_block_types=("AttnUpBlock2D", "UpBlock2D"),
        )


class ResnetBlock2D(nn.Module):
    """GN+SiLU -> conv3x3 -> + time projection -> GN+SiLU -> dropout ->
    conv3x3, with the (1×1-projected when the width changes) input added in
    conv2's epilogue. GroupNorm eps 1e-6, as the JAX block. Dropout (rate
    ``dropout``) runs only when the forward is given a noise source."""

    def __init__(self, c_in: int, c_out: int, temb_dim: int, groups: int = 32, dropout: float = 0.0,
                 winograd: bool = False):
        super().__init__()
        self.groups = groups
        self.dropout = dropout
        self.norm1 = GroupNorm32(c_in, groups, eps=1e-6)
        self.conv1 = Conv3x3(c_in, c_out, winograd=winograd)
        self.time_emb_proj = nn.Linear(temb_dim, c_out)
        self.norm2 = GroupNorm32(c_out, groups, eps=1e-6)
        self.conv2 = Conv3x3(c_out, c_out, winograd=winograd)
        self.conv_shortcut = Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor, noise=None) -> torch.Tensor:
        h = group_norm_silu(x, self.norm1.weight, self.norm1.bias, self.groups, 1e-6)
        h = self.conv1(h)
        t = self.time_emb_proj(F.silu(temb))
        h = h + t[:, None, None, :].to(h.dtype)
        h = group_norm_silu(h, self.norm2.weight, self.norm2.bias, self.groups, 1e-6)
        h = dropout(h, self.dropout, noise)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return self.conv2(h, res=x)


class SelfAttention2D(nn.Module):
    """diffusers' legacy attention block: GroupNorm (no SiLU), query / key /
    value projections, attention (one head by default), ``proj_attn``,
    residual."""

    def __init__(self, channels: int, head_dim: Optional[int], groups: int = 32):
        super().__init__()
        self.heads = 1 if head_dim is None else max(channels // head_dim, 1)
        self.group_norm = GroupNorm32(channels, groups, eps=1e-6)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        tokens = self.group_norm(x).reshape(b, h * w, c)
        hd = c // self.heads
        q, k, v = (proj(tokens).reshape(b, h * w, self.heads, hd) for proj in (self.query, self.key, self.value))
        out = self.proj_attn(dot_product_attention(q, k, v).reshape(b, h * w, c))
        return x + out.reshape(b, h, w, c)


class _Downsample(nn.Module):
    """Stride-2 3×3 conv; DDPM padding (0) pads bottom/right by one and runs
    a VALID conv (cuDNN, as ``nn.Conv`` is XLA's in JAX)."""

    def __init__(self, channels: int, padding: int):
        super().__init__()
        self.padding = padding
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == 0:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return conv2d_nhwc(x, self.conv.weight, self.conv.bias, stride=2, padding=self.padding)


class _TimestepEmbedding(nn.Module):
    def __init__(self, c: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(c, dim)
        self.linear_2 = nn.Linear(dim, dim)


class _Block(nn.Module):
    """One resolution level: ``resnets``, optional ``attentions``, and the
    ``downsamplers`` / ``upsamplers`` list (diffusers' module names)."""

    def __init__(self, resnets, attentions, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if down is not None:
            self.downsamplers = nn.ModuleList([down])
        if up is not None:
            self.upsamplers = nn.ModuleList([up])


class _Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels, up2=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UNet2D(nn.Module):
    """``forward(x [B,H,W,C], t (int | [B]), y=None, noise=None)`` -> float32
    epsilon [B, H, W, out_channels]. ``noise`` (a noise source with
    ``bernoulli``) turns MC dropout on for this forward."""

    def __init__(self, cfg: UNet2DConfig):
        super().__init__()
        self.cfg = cfg
        b0 = cfg.block_out_channels[0]
        td = 4 * b0
        g = cfg.norm_num_groups

        def res(c_in, c_out):
            return ResnetBlock2D(c_in, c_out, td, g, cfg.dropout, cfg.winograd)

        def attn(c):
            return SelfAttention2D(c, cfg.attention_head_dim, g)

        self.time_embedding = _TimestepEmbedding(b0, td)
        if cfg.num_class_embeds is not None:
            self.class_embedding = nn.Embedding(cfg.num_class_embeds, td)
        self.conv_in = Conv3x3(cfg.in_channels, b0)

        n = len(cfg.block_out_channels)
        ch = b0
        skip_chs = [b0]
        self.down_blocks = nn.ModuleList()
        for bi, (btype, out_ch) in enumerate(zip(cfg.down_block_types, cfg.block_out_channels)):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(res(ch, out_ch))
                ch = out_ch
                if btype == "AttnDownBlock2D":
                    attns.append(attn(ch))
                skip_chs.append(ch)
            down = None
            if bi != n - 1:
                down = _Downsample(ch, cfg.downsample_padding)
                skip_chs.append(ch)
            self.down_blocks.append(_Block(resnets, attns, down=down))

        self.mid_block = _Block([res(ch, ch), res(ch, ch)], [attn(ch)])

        self.up_blocks = nn.ModuleList()
        for bi, (btype, out_ch) in enumerate(zip(cfg.up_block_types, reversed(cfg.block_out_channels))):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(res(ch + skip_chs.pop(), out_ch))
                ch = out_ch
                if btype == "AttnUpBlock2D":
                    attns.append(attn(ch))
            up = _Upsample(ch) if bi != n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, up=up))

        self.conv_norm_out = GroupNorm32(ch, g, eps=1e-6)
        self.conv_out = Conv3x3(ch, cfg.out_channels)

    def forward(self, x: torch.Tensor, t, y: Optional[torch.Tensor] = None, noise=None) -> torch.Tensor:
        cfg = self.cfg
        te = self.time_embedding
        dtype = te.linear_1.weight.dtype
        temb = timestep_embedding(
            t, cfg.block_out_channels[0], cos_first=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift, device=x.device
        )
        temb = te.linear_2(F.silu(te.linear_1(temb.to(dtype))))
        if cfg.num_class_embeds is not None:
            if y is None:
                raise ValueError("class-conditional model requires y")
            temb = temb + self.class_embedding(y)
        if temb.shape[0] == 1 and x.shape[0] > 1:
            temb = temb.expand(x.shape[0], -1)

        h = self.conv_in(x.to(dtype))
        skips = [h]
        for blk in self.down_blocks:
            for li, rn in enumerate(blk.resnets):
                h = rn(h, temb, noise)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[li](h)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb, noise)
        h = mid.attentions[0](h)
        h = mid.resnets[1](h, temb, noise)

        for blk in self.up_blocks:
            for li, rn in enumerate(blk.resnets):
                h = rn(torch.cat([h, skips.pop()], dim=-1), temb, noise)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[li](h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)

        gn = self.conv_norm_out
        h = group_norm_silu(h, gn.weight, gn.bias, gn.num_groups, 1e-6)
        return self.conv_out(h).float()
