"""diffusers ``ResnetBlock2D`` in PyTorch, NHWC activations.

JAX counterpart: ``diffusion_uncertainty_tpu/models/unet2d.py``
(``ResnetBlock2D``, :76-109), the block the SD UNet reuses. Parameter names
are diffusers' (``norm1``, ``conv1``, ``time_emb_proj``, ``norm2``,
``conv2``, ``conv_shortcut``), so a diffusers state dict loads as it is.
The rest of ``UNet2D`` (the CIFAR-10 DDPM model) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.groupnorm import group_norm_silu
from .layers import Conv2d, Conv3x3, GroupNorm32

__all__ = ["ResnetBlock2D"]


class ResnetBlock2D(nn.Module):
    """GN+SiLU -> conv3x3 -> + time projection -> GN+SiLU -> conv3x3, with
    the (1×1-projected when the width changes) input added in conv2's
    epilogue. GroupNorm eps 1e-6, as the JAX block. Dropout is not applied
    (the SD UNet runs with rate 0)."""

    def __init__(self, c_in: int, c_out: int, temb_dim: int, groups: int = 32):
        super().__init__()
        self.groups = groups
        self.norm1 = GroupNorm32(c_in, groups, eps=1e-6)
        self.conv1 = Conv3x3(c_in, c_out)
        self.time_emb_proj = nn.Linear(temb_dim, c_out)
        self.norm2 = GroupNorm32(c_out, groups, eps=1e-6)
        self.conv2 = Conv3x3(c_out, c_out)
        self.conv_shortcut = Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = group_norm_silu(x, self.norm1.weight, self.norm1.bias, self.groups, 1e-6)
        h = self.conv1(h)
        t = self.time_emb_proj(F.silu(temb))
        h = h + t[:, None, None, :].to(h.dtype)
        h = group_norm_silu(h, self.norm2.weight, self.norm2.bias, self.groups, 1e-6)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return self.conv2(h, res=x)
