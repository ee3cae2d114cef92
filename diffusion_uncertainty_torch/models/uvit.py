"""U-ViT (the skip-connected ViT diffusion backbone) in PyTorch, NHWC in and
out, tokens [B, S, d] inside.

JAX counterpart: ``diffusion_uncertainty_tpu/models/uvit.py``
(``UViTConfig``, ``_Attention``, ``_SkipJoin``, ``_Block``, ``UViT``,
:35-254). The module tree and parameter names are the reference's
(``uvit/uvit.py``: ``patch_embed.proj``, ``pos_embed``, ``label_emb``,
``time_embed.0/.2``, ``in_blocks.<i>``, ``mid_block``, ``out_blocks.<i>``
with ``norm1``, ``attn.qkv``, ``attn.proj``, ``norm2``, ``mlp.fc1``,
``mlp.fc2`` and ``skip_linear`` [d, 2d], ``norm``, ``decoder_pred``,
``final_layer``), the layout JAX ``convert_uvit`` reads, so a reference
checkpoint loads with ``load_state_dict``;
``convert.uvit_state_dict_from_flax`` gives the same dict from the JAX
package's parameters.

The forward follows the JAX model: token order [label, time, patches] under
one learned ``pos_embed``; pre-LN residual blocks with LayerNorm statistics
in float32 (eps 1e-5) and the result rounded to the run type (PyTorch's
LayerNorm accumulates bf16 inputs in float32, so it runs on the bf16
activations with no cast passes around it); the fused qkv projection
split into q, k, v as views of the one [B, S, 3d] tensor, whose attention
(head dim 72 at U-ViT-huge's width) runs through the attention kernel;
exact-erf GELU in every type, computed in float32 and rounded once (PyTorch's
bf16 GELU does both in one pass; the JAX "auto" mode's tanh GELU in bf16 is
a TPU-only deviation, ``PARITY.md``); the skip join as one GEMM over the
concat of [x, skip]; unpatchify in the reference's (p1, p2, C) order;
float32 output. ``remat`` (the JAX per-block rematerialisation) has no
counterpart: a gradient estimator or guidance on U-ViT keeps every
activation for its backward; the run type is the parameters'
(``model.to(dtype)``), not a config field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from .layers import Conv2d, timestep_embedding

__all__ = ["UViTConfig", "UViT"]


@dataclasses.dataclass(frozen=True)
class UViTConfig:
    img_size: int = 32  # latent side the transformer sees
    patch_size: int = 2
    in_chans: int = 4
    embed_dim: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    qkv_bias: bool = False
    mlp_time_embed: bool = False
    num_classes: Optional[int] = 1001
    final_conv: bool = False  # the reference's ``conv`` argument (the huge checkpoints: False)

    @staticmethod
    def imagenet256() -> "UViTConfig":
        """U-ViT-huge/2 for ImageNet-256 latents (32x32x4)."""
        return UViTConfig(img_size=32, patch_size=2)

    @staticmethod
    def imagenet512() -> "UViTConfig":
        """U-ViT-huge/4 for ImageNet-512 latents (64x64x4)."""
        return UViTConfig(img_size=64, patch_size=4)

    @staticmethod
    def tiny(num_classes: Optional[int] = 16) -> "UViTConfig":
        return UViTConfig(img_size=8, patch_size=2, in_chans=4, embed_dim=32, depth=4, num_heads=2, num_classes=num_classes)


class _Attention(nn.Module):
    """Fused qkv projection (rows q | k | v, head-major within each), q, k,
    v as strided views of it, attention, output projection."""

    def __init__(self, d: int, num_heads: int, qkv_bias: bool):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(d, 3 * d, bias=qkv_bias)
        self.proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b, s, 3, h, d // h)
        out = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(out.reshape(b, s, d))


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _Block(nn.Module):
    """Optional skip join ``skip_linear(cat([x, skip]))``, then the pre-LN
    attention and MLP residuals."""

    def __init__(self, d: int, num_heads: int, mlp_ratio: float, qkv_bias: bool, skip: bool = False):
        super().__init__()
        self.skip_linear = nn.Linear(2 * d, d) if skip else None
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.attn = _Attention(d, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = _Mlp(d, int(d * mlp_ratio))

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.skip_linear is not None:
            x = self.skip_linear(torch.cat([x, skip], dim=-1))
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, d: int, p: int):
        super().__init__()
        self.proj = Conv2d(in_chans, d, p, stride=p)


class UViT(nn.Module):
    """``forward(x [B, H, W, C], t [] or [B], y [B] or None)`` -> epsilon
    [B, H, W, C] float32. Labels of a batch that ``x``'s batch is a multiple
    of are repeated (an ensemble folded into the batch)."""

    def __init__(self, cfg: UViTConfig):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.embed_dim, cfg.patch_size
        self.extras = 2 if cfg.num_classes else 1
        num_patches = (cfg.img_size // p) ** 2
        self.patch_embed = _PatchEmbed(cfg.in_chans, d, p)
        self.time_embed = nn.Sequential(nn.Linear(d, 4 * d), nn.SiLU(), nn.Linear(4 * d, d)) if cfg.mlp_time_embed else None
        self.label_emb = nn.Embedding(cfg.num_classes, d) if cfg.num_classes else None
        self.pos_embed = nn.Parameter(torch.zeros(1, self.extras + num_patches, d))

        def block(skip=False):
            return _Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias, skip=skip)

        self.in_blocks = nn.ModuleList(block() for _ in range(cfg.depth // 2))
        self.mid_block = block()
        self.out_blocks = nn.ModuleList(block(skip=True) for _ in range(cfg.depth // 2))
        self.norm = nn.LayerNorm(d, eps=1e-5)
        self.decoder_pred = nn.Linear(d, p * p * cfg.in_chans)
        self.final_layer = Conv2d(cfg.in_chans, cfg.in_chans, 3, padding=1) if cfg.final_conv else None

    def forward(self, x: torch.Tensor, t, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b = x.shape[0]
        p, d = cfg.patch_size, cfg.embed_dim
        grid = cfg.img_size // p
        dtype = self.pos_embed.dtype
        tokens = self.patch_embed.proj(x.to(dtype)).reshape(b, grid * grid, d)
        temb = timestep_embedding(t, d, cos_first=True, device=x.device).to(dtype)
        if self.time_embed is not None:
            temb = self.time_embed(temb)
        seq = [temb.expand(b, d)[:, None], tokens]
        if self.label_emb is not None:
            if y is None:
                raise ValueError("class-conditional U-ViT requires y")
            if y.shape[0] != b:
                if b % y.shape[0]:
                    raise ValueError(f"batch {b} is not a multiple of the {y.shape[0]} labels")
                y = y.repeat(b // y.shape[0])  # folded ensemble members
            seq.insert(0, self.label_emb(y)[:, None])
        h = torch.cat(seq, dim=1) + self.pos_embed

        skips = []
        for blk in self.in_blocks:
            h = blk(h)
            skips.append(h)
        h = self.mid_block(h)
        for blk in self.out_blocks:
            h = blk(h, skips.pop())

        h = self.decoder_pred(self.norm(h))[:, self.extras:]
        # unpatchify: the reference's token order is (p1, p2, C) within a patch
        h = h.reshape(b, grid, grid, p, p, cfg.in_chans).permute(0, 1, 3, 2, 4, 5)
        h = h.reshape(b, cfg.img_size, cfg.img_size, cfg.in_chans)
        if self.final_layer is not None:
            h = self.final_layer(h.contiguous())
        return h.float()
