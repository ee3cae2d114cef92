"""KL autoencoder (Stable-Diffusion f8 VAE), decoder side, in PyTorch with
NHWC activations.

JAX counterpart: ``diffusion_uncertainty_tpu/models/autoencoder.py``
(``AutoencoderKLConfig``, ``_ResnetBlock``, ``_AttnBlock``, ``_Decoder`` and
``AutoencoderKL``'s ``decode``, :33-237). Parameter names are the CompVis
layout the JAX converter reads (``decoder.up.1.block.0.norm1.weight``,
``decoder.mid.attn_1.q.weight`` as 1×1 convs, ``post_quant_conv``), so a
full VAE state dict loads with ``load_state_dict``: the encoder's keys
(``encoder.*``, ``quant_conv.*``) are set aside, since the encoder is not
ported yet. GroupNorm (eps 1e-6) runs through the kernel pair and the
single-head mid attention (D = 512 at full width) through the attention
kernel. The decoder's nearest-2× upsample is the plain broadcast copy, as in
the JAX model (no Pallas kernel there), followed by a 3×3 conv.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from ..ops.groupnorm import group_norm_silu
from .layers import Conv2d, Conv3x3, GroupNorm32, nearest_upsample

__all__ = ["AutoencoderKLConfig", "AutoencoderKL"]

# keys of a full VAE state dict that belong to the encoder (not ported yet)
_ENCODER_PREFIXES = ("encoder.", "quant_conv.")


@dataclasses.dataclass(frozen=True)
class AutoencoderKLConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    out_channels: int = 3
    scale_factor: float = 0.18215
    shift_factor: float = 0.0
    use_quant_conv: bool = True

    @staticmethod
    def sd_kl_ema() -> "AutoencoderKLConfig":
        """The SD KL-f8 VAE (``autoencoder_kl_ema.pth``)."""
        return AutoencoderKLConfig()

    @staticmethod
    def sd3_kl() -> "AutoencoderKLConfig":
        """SD3's 16-channel VAE (diffusers sd3 vae config: scaling_factor
        1.5305, shift_factor 0.0609, no quant convs)."""
        return AutoencoderKLConfig(
            z_channels=16, embed_dim=16, scale_factor=1.5305, shift_factor=0.0609, use_quant_conv=False
        )

    @staticmethod
    def flux_kl() -> "AutoencoderKLConfig":
        """Flux's 16-channel VAE (scaling_factor 0.3611, shift_factor 0.1159,
        no quant convs)."""
        return AutoencoderKLConfig(
            z_channels=16, embed_dim=16, scale_factor=0.3611, shift_factor=0.1159, use_quant_conv=False
        )

    @staticmethod
    def tiny() -> "AutoencoderKLConfig":
        return AutoencoderKLConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1)


class _ResnetBlock(nn.Module):
    """GN+SiLU -> conv -> GN+SiLU -> conv, plus the (1×1-projected) input."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.norm1 = GroupNorm32(c_in, eps=1e-6)
        self.conv1 = Conv3x3(c_in, c_out)
        self.norm2 = GroupNorm32(c_out, eps=1e-6)
        self.conv2 = Conv3x3(c_out, c_out)
        self.nin_shortcut = Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = group_norm_silu(x, self.norm1.weight, self.norm1.bias, eps=1e-6)
        h = self.conv1(h)
        h = group_norm_silu(h, self.norm2.weight, self.norm2.bias, eps=1e-6)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return self.conv2(h, res=x)


class _AttnBlock(nn.Module):
    """Single-head self-attention over H·W tokens; q, k, v and proj_out are
    1×1 convs in the state dict and one matmul each here."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm32(c, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(c, c, 1) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = group_norm_silu(x, self.norm.weight, self.norm.bias, eps=1e-6, apply_silu=False)
        tokens = y.reshape(b, h * w, c)
        q, k, v = (F.linear(tokens, m.weight.view(c, c), m.bias)[:, :, None, :] for m in (self.q, self.k, self.v))
        out = dot_product_attention(q, k, v).reshape(b, h * w, c)
        out = F.linear(out, self.proj_out.weight.view(c, c), self.proj_out.bias)
        return x + out.reshape(b, h, w, c)


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = _ResnetBlock(c, c)
        self.attn_1 = _AttnBlock(c)
        self.block_2 = _ResnetBlock(c, c)


class _Sampler(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv3x3(c, c)


class _UpLevel(nn.Module):
    def __init__(self, blocks, upsample: bool, c: int):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if upsample:
            self.upsample = _Sampler(c)


class _Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv3x3(cfg.z_channels, block_in)
        self.mid = _Mid(block_in)
        levels = [None] * len(cfg.ch_mult)
        c = block_in
        for lv in reversed(range(len(cfg.ch_mult))):
            out_ch = cfg.ch * cfg.ch_mult[lv]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(_ResnetBlock(c, out_ch))
                c = out_ch
            levels[lv] = _UpLevel(blocks, lv != 0, c)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(c, eps=1e-6)
        self.conv_out = Conv3x3(c, cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid.block_1(h)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h)
        for lv in reversed(range(len(self.up))):
            level = self.up[lv]
            for blk in level.block:
                h = blk(h)
            if lv != 0:
                h = level.upsample.conv(nearest_upsample(h))
        h = group_norm_silu(h, self.norm_out.weight, self.norm_out.bias, eps=1e-6)
        return self.conv_out(h)


class AutoencoderKL(nn.Module):
    """``decode(z [B,h,w,embed_dim])`` -> images [B,8h,8w,out_channels]
    float32: unscale (and unshift) the latent, ``post_quant_conv``, decoder."""

    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder = _Decoder(cfg)
        self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1) if cfg.use_quant_conv else None

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = self.decoder.conv_in.weight.dtype
        z = (z.float() / cfg.scale_factor + cfg.shift_factor).to(dt)
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z).float()

    forward = decode

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Load a full VAE state dict; the encoder's keys are set aside."""
        kept = {k: v for k, v in state_dict.items() if not k.startswith(_ENCODER_PREFIXES)}
        return super().load_state_dict(kept, strict=strict, assign=assign)
