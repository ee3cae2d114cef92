"""SD3 MMDiT (the diffusers ``SD3Transformer2DModel`` family) in PyTorch, NHWC
latents in and out, tokens [B, S, d] inside.

JAX counterpart: ``diffusion_uncertainty_tpu/models/mmdit.py``
(``MMDiTConfig``, ``_TimestepTextEmbed``, ``_QKNorm``, ``_JointBlock``,
``MMDiT``). Parameter names are diffusers' ``SD3Transformer2DModel``
state-dict keys (``pos_embed.proj``, ``pos_embed.pos_embed``,
``time_text_embed.timestep_embedder.linear_1``, ``context_embedder``,
``transformer_blocks.<i>.norm1.linear``, ``.attn.to_q``, ``.attn.add_q_proj``,
``.attn.norm_q``, ``.attn.to_out.0``, ``.attn.to_add_out``, ``.ff.net.0.proj``,
``.ff_context.net.2``, ``norm_out.linear``, ``proj_out``), the layout JAX
``convert_sd3_mmdit`` reads, so a diffusers checkpoint loads with
``load_state_dict``; ``convert.mmdit_state_dict_from_flax`` gives the same
dict from the JAX package's parameters.

The forward follows the JAX model: the 2×2 patch embed as a strided conv,
the learned position table centre-cropped from ``pos_embed_max_size``² to
the latent grid (diffusers ``PatchEmbed.cropped_pos_embed``); per block
AdaLN-Zero on both streams (chunk order shift, scale, gate for attention
then MLP), separate q/k/v projections per stream, joint attention over
[image | text] tokens through ``ops.attention`` (the attention kernel on the
card), gated residuals and a tanh-GELU MLP per stream; the last block is
``context_pre_only`` (AdaLN-Continuous on the text stream, which is then
dropped); the final AdaLN-Continuous (chunk order scale, shift), the linear
head and the unpatchify in (p1, p2, C) order; float32 output. LayerNorms have
no affine (eps 1e-6) and compute in float32 (PyTorch's LayerNorm
accumulates bf16 inputs in float32 and rounds once, as JAX's float32 norm
followed by the cast); the tanh-approximate GELU likewise computes in float32
and rounds once; the RMS q/k norm of SD3.5 is float32 math.

The run type is the parameters' (``model.to(dtype)``), not a config field;
``remat`` checkpoints each block (``torch.utils.checkpoint``) while autograd
is on, as the JAX ``nn.remat``. The sequence-parallel ``sp_axis`` is not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention
from .layers import Conv2d, timestep_embedding

__all__ = ["MMDiTConfig", "MMDiT"]


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    sample_size: int = 128  # latent side (1024px / 8)
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24  # width = heads * head_dim = 1536
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192
    qk_norm: Optional[str] = None  # "rms_norm" for SD3.5
    remat: bool = False

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @staticmethod
    def sd3_medium() -> "MMDiTConfig":
        """stabilityai/stable-diffusion-3-medium transformer (2.0B)."""
        return MMDiTConfig()

    @staticmethod
    def sd35_large() -> "MMDiTConfig":
        """SD3.5-large: 38 layers, width 2432, RMS-normed q/k (8.1B)."""
        return MMDiTConfig(num_layers=38, num_attention_heads=38, qk_norm="rms_norm")

    @staticmethod
    def tiny() -> "MMDiTConfig":
        return MMDiTConfig(
            sample_size=8,
            num_layers=2,
            attention_head_dim=8,
            num_attention_heads=4,
            joint_attention_dim=24,
            pooled_projection_dim=20,
            pos_embed_max_size=16,
        )


def _ln(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis without affine, eps 1e-6, float32
    statistics, in x's type."""
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, float32 math rounded once to x's type."""
    return F.gelu(x, approximate="tanh")


def _modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return _ln(x) * (1 + scale) + shift


class _Mlp(nn.Module):
    """diffusers ``FeedForward`` (gelu-approximate): ``net.0.proj``, tanh
    GELU, ``net.2``."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([_Proj(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](_gelu(self.net[0].proj(x)))


class _Proj(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out)


class _AdaLN(nn.Module):
    """The ``norm*.linear`` of an AdaLN (its SiLU is applied once a block)."""

    def __init__(self, dim: int, chunks: int):
        super().__init__()
        self.linear = nn.Linear(dim, chunks * dim)
        self.chunks = chunks

    def forward(self, silu_t: torch.Tensor):
        return self.linear(silu_t).unsqueeze(1).chunk(self.chunks, dim=-1)


class _QKNorm(nn.Module):
    """RMSNorm over the head dim (SD3.5 and Flux q/k norms), float32 math,
    eps 1e-6, output in the input's type; ``weight`` as diffusers'
    ``RMSNorm``."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + 1e-6)
        return (x32 * self.weight.float()).to(x.dtype)


class _JointAttention(nn.Module):
    """diffusers ``Attention`` with the joint processor: q/k/v projections
    per stream, optional RMS q/k norms, the output projections."""

    def __init__(self, dim: int, heads: int, head_dim: int, qk_norm: Optional[str], context_pre_only: bool):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, n, nn.Linear(dim, dim))
        if qk_norm == "rms_norm":
            for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
                setattr(self, n, _QKNorm(head_dim))
        elif qk_norm is not None:
            raise ValueError(f"unknown qk_norm {qk_norm!r}")
        self.qk_norm = qk_norm
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        self.to_add_out = None if context_pre_only else nn.Linear(dim, dim)

    def forward(self, h_n: torch.Tensor, c_n: torch.Tensor):
        b, s_img, dim = h_n.shape
        split = lambda a: a.view(a.shape[0], a.shape[1], self.heads, self.head_dim)  # noqa: E731
        q, k, v = split(self.to_q(h_n)), split(self.to_k(h_n)), split(self.to_v(h_n))
        cq, ck, cv = split(self.add_q_proj(c_n)), split(self.add_k_proj(c_n)), split(self.add_v_proj(c_n))
        if self.qk_norm is not None:
            q, k = self.norm_q(q), self.norm_k(k)
            cq, ck = self.norm_added_q(cq), self.norm_added_k(ck)
        # joint sequence order: [image tokens | text tokens]
        out = dot_product_attention(torch.cat([q, cq], 1), torch.cat([k, ck], 1), torch.cat([v, cv], 1))
        out = out.reshape(b, out.shape[1], dim)
        return out[:, :s_img], out[:, s_img:]


class _JointBlock(nn.Module):
    """diffusers ``JointTransformerBlock`` (AdaLN-Zero chunk order: shift_msa,
    scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp)."""

    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool = False):
        super().__init__()
        dim = cfg.dim
        self.context_pre_only = context_pre_only
        self.norm1 = _AdaLN(dim, 6)
        # AdaLN-Continuous on the final text stream (chunk order scale, shift)
        self.norm1_context = _AdaLN(dim, 2 if context_pre_only else 6)
        self.attn = _JointAttention(dim, cfg.num_attention_heads, cfg.attention_head_dim, cfg.qk_norm, context_pre_only)
        self.ff = _Mlp(dim)
        self.ff_context = None if context_pre_only else _Mlp(dim)

    def forward(self, h: torch.Tensor, ctx: torch.Tensor, temb: torch.Tensor):
        silu_t = F.silu(temb)
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = self.norm1(silu_t)
        h_n = _modulate(h, sc_msa, sh_msa)
        if self.context_pre_only:
            sc_c, sh_c = self.norm1_context(silu_t)
            c_n = _modulate(ctx, sc_c, sh_c)
        else:
            csh_msa, csc_msa, cg_msa, csh_mlp, csc_mlp, cg_mlp = self.norm1_context(silu_t)
            c_n = _modulate(ctx, csc_msa, csh_msa)
        attn_h, attn_c = self.attn(h_n, c_n)

        h = h + g_msa * self.attn.to_out[0](attn_h)
        h = h + g_mlp * self.ff(_modulate(h, sc_mlp, sh_mlp))
        if self.context_pre_only:
            return h, None
        ctx = ctx + cg_msa * self.attn.to_add_out(attn_c)
        ctx = ctx + cg_mlp * self.ff_context(_modulate(ctx, csc_mlp, csh_mlp))
        return h, ctx


class _TimestepTextEmbed(nn.Module):
    """``CombinedTimestepTextProjEmbeddings``: 256-dim cos-first sincos ->
    2-layer SiLU MLP, plus the pooled text's 2-layer MLP, summed."""

    def __init__(self, dim: int, pooled_dim: int):
        super().__init__()
        self.timestep_embedder = _LinearPair(256, dim)
        self.text_embedder = _LinearPair(pooled_dim, dim)

    def forward(self, t, pooled: torch.Tensor) -> torch.Tensor:
        dtype = self.timestep_embedder.linear_1.weight.dtype
        te = self.timestep_embedder(timestep_embedding(t, 256, cos_first=True, device=pooled.device).to(dtype))
        pe = self.text_embedder(pooled.to(dtype))
        if te.shape[0] == 1 and pe.shape[0] > 1:
            te = te.expand(pe.shape[0], -1)
        return te + pe


class _LinearPair(nn.Module):
    """``linear_2(silu(linear_1(x)))`` (diffusers ``TimestepEmbedding`` /
    ``PixArtAlphaTextProjection`` with SiLU)."""

    def __init__(self, d_in: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class _PatchEmbed(nn.Module):
    """The p×p patch conv and the learned [1, max², d] position table."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = Conv2d(cfg.in_channels, cfg.dim, p, stride=p)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.pos_embed_max_size**2, cfg.dim))


def run_blocks(blocks, remat: bool, carry, *args):
    """Each block on ``(*carry, *args)``, checkpointed (the JAX ``nn.remat``)
    when ``remat`` is set and autograd is on."""
    ckpt = remat and torch.is_grad_enabled()
    for blk in blocks:
        carry = checkpoint(blk, *carry, *args, use_reentrant=False) if ckpt else blk(*carry, *args)
        if not isinstance(carry, tuple):
            carry = (carry,)
    return carry


class MMDiT(nn.Module):
    """``forward(x [B, H, W, C], t [] or [B], encoder_hidden_states [B, L,
    joint_dim], pooled_projections [B, pooled_dim])`` -> velocity [B, H, W,
    out_channels] float32. ``t`` is the raw train-timestep value (σ·1000
    under flow matching)."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.dim
        self.pos_embed = _PatchEmbed(cfg)
        self.time_text_embed = _TimestepTextEmbed(dim, cfg.pooled_projection_dim)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, dim)
        self.transformer_blocks = nn.ModuleList(
            _JointBlock(cfg, context_pre_only=i == cfg.num_layers - 1) for i in range(cfg.num_layers)
        )
        self.norm_out = _AdaLN(dim, 2)
        self.proj_out = nn.Linear(dim, cfg.patch_size**2 * cfg.out_channels)

    def forward(self, x, t, encoder_hidden_states, pooled_projections) -> torch.Tensor:
        cfg = self.cfg
        b, hh, ww, _ = x.shape
        p, dim = cfg.patch_size, cfg.dim
        gh, gw = hh // p, ww // p
        dtype = self.context_embedder.weight.dtype
        tokens = self.pos_embed.proj(x.to(dtype)).reshape(b, gh * gw, dim)
        # learned table over the max grid, centre-cropped to (gh, gw)
        m = cfg.pos_embed_max_size
        top, left = (m - gh) // 2, (m - gw) // 2
        pos = self.pos_embed.pos_embed.view(m, m, dim)[top : top + gh, left : left + gw]
        h = tokens + pos.reshape(1, gh * gw, dim).to(dtype)

        temb = self.time_text_embed(t, pooled_projections)
        ctx = self.context_embedder(encoder_hidden_states.to(dtype))
        h, _ = run_blocks(self.transformer_blocks, cfg.remat, (h, ctx), temb)

        sc, sh = self.norm_out(F.silu(temb))
        h = self.proj_out(_modulate(h, sc, sh))
        h = h.reshape(b, gh, gw, p, p, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
        return h.reshape(b, hh, ww, cfg.out_channels).float()
