"""Flux transformer (the diffusers ``FluxTransformer2DModel`` family) in
PyTorch, NHWC latents in and out, tokens [B, S, d] inside.

JAX counterpart: ``diffusion_uncertainty_tpu/models/flux.py``
(``FluxConfig``, ``_rope_cos_sin``, ``_apply_rope``, ``_rms_qk``,
``_DoubleBlock``, ``_SingleBlock``, ``FluxTransformer``). Parameter names are
diffusers' ``FluxTransformer2DModel`` state-dict keys (``x_embedder``,
``context_embedder``, ``time_text_embed.{timestep,guidance,text}_embedder
.linear_{1,2}``, ``transformer_blocks.<i>`` with ``norm1.linear``,
``norm1_context.linear``, ``attn.to_q``, ``attn.norm_q``, ``attn.add_q_proj``,
``attn.norm_added_q``, ``attn.to_out.0``, ``attn.to_add_out``, ``ff.net.0.proj``,
``ff_context.net.2``; ``single_transformer_blocks.<i>`` with ``norm.linear``,
``attn.to_q``, ``attn.norm_q``, ``proj_mlp``, ``proj_out``; ``norm_out.linear``,
``proj_out``), so a diffusers checkpoint loads with ``load_state_dict``.

The model packs each 2×2 latent patch into one token channel-major,
``(c, p1, p2)``, as diffusers ``_pack_latents`` does (so ``x_embedder`` and
``proj_out`` are diffusers' own), where the JAX model packs patch-major and
permutes those two weights in its converter (``_flux_token_perm``);
``convert.flux_state_dict_from_flax`` undoes that permutation.

The forward follows the JAX model: RoPE ids with the text tokens at the
origin and the image tokens on the (row, col) packed grid, per-axis rotary
tables (interleaved pairs, float32); 19 double-stream blocks (AdaLN-Zero on
both streams, RMS q/k norms, joint attention over [text | image] with RoPE,
gated residuals, tanh-GELU MLPs), then 38 single-stream blocks over the
concatenated sequence (one gated output projection over [attention | MLP]),
the final AdaLN-Continuous head and the unpacking; float32 output. Attention
runs through ``ops.attention`` (the attention kernel on the card, head dim
128 at full width). Norm and GELU numerics as ``models.mmdit``. The run type
is the parameters'; ``remat`` checkpoints each block while autograd is on.
The sequence-parallel ``sp_axis`` is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from .layers import timestep_embedding
from .mmdit import _AdaLN, _gelu, _LinearPair, _Mlp, _modulate, _QKNorm, run_blocks

__all__ = ["FluxConfig", "FluxTransformer"]


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 16  # latent channels before the 2x2 packing (token dim 64)
    num_layers: int = 19  # double-stream blocks
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24  # width 3072
    joint_attention_dim: int = 4096  # T5 context width
    pooled_projection_dim: int = 768  # CLIP pooled width
    guidance_embeds: bool = True  # flux-dev; schnell has False
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    remat: bool = False

    @property
    def dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @staticmethod
    def flux_dev() -> "FluxConfig":
        """black-forest-labs/FLUX.1-dev (11.9B)."""
        return FluxConfig()

    @staticmethod
    def flux_schnell() -> "FluxConfig":
        return FluxConfig(guidance_embeds=False)

    @staticmethod
    def tiny() -> "FluxConfig":
        return FluxConfig(
            in_channels=4,
            num_layers=2,
            num_single_layers=2,
            attention_head_dim=8,
            num_attention_heads=2,
            joint_attention_dim=24,
            pooled_projection_dim=16,
            axes_dims_rope=(4, 2, 2),
        )


def _rope_cos_sin(ids: torch.Tensor, axes_dims, theta: float = 10000.0):
    """diffusers ``FluxPosEmbed``: per-axis rotary tables, concatenated over
    channels. ids [S, n_axes]; (cos, sin) [S, sum(axes_dims)] float32, each
    frequency twice (interleaved pairs)."""
    parts_cos, parts_sin = [], []
    for a, d in enumerate(axes_dims):
        freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=ids.device) / d))
        ang = ids[:, a : a + 1].float() * freqs[None, :]
        parts_cos.append(torch.repeat_interleave(torch.cos(ang), 2, dim=-1))
        parts_sin.append(torch.repeat_interleave(torch.sin(ang), 2, dim=-1))
    return torch.cat(parts_cos, dim=-1), torch.cat(parts_sin, dim=-1)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, d]: x·cos + rotate_pairs(x)·sin in float32, in x's type
    (``apply_rotary_emb`` use_real, unbind_dim=-1)."""
    x32 = x.float()
    rotated = torch.stack([-x32[..., 1::2], x32[..., 0::2]], dim=-1).reshape(x32.shape)
    return (x32 * cos[None, :, None, :] + rotated * sin[None, :, None, :]).to(x.dtype)


def _rms_qk(attn: nn.Module, q, k, added: bool = False):
    """The RMS q/k norms of a Flux attention (``norm_q``/``norm_k``, or
    ``norm_added_q``/``norm_added_k`` for the text stream)."""
    if added:
        return attn.norm_added_q(q), attn.norm_added_k(k)
    return attn.norm_q(q), attn.norm_k(k)


class _Attention(nn.Module):
    """diffusers ``Attention`` of a Flux block: q/k/v projections with RMS
    q/k norms; the double block adds the text stream's projections, norms
    and output projections."""

    def __init__(self, dim: int, head_dim: int, double: bool):
        super().__init__()
        for n in ("to_q", "to_k", "to_v"):
            setattr(self, n, nn.Linear(dim, dim))
        self.norm_q, self.norm_k = _QKNorm(head_dim), _QKNorm(head_dim)
        if double:
            for n in ("add_q_proj", "add_k_proj", "add_v_proj"):
                setattr(self, n, nn.Linear(dim, dim))
            self.norm_added_q, self.norm_added_k = _QKNorm(head_dim), _QKNorm(head_dim)
            self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
            self.to_add_out = nn.Linear(dim, dim)


class _DoubleBlock(nn.Module):
    """diffusers ``FluxTransformerBlock``."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        dim = cfg.dim
        self.heads, self.head_dim = cfg.num_attention_heads, cfg.attention_head_dim
        self.norm1 = _AdaLN(dim, 6)
        self.norm1_context = _AdaLN(dim, 6)
        self.attn = _Attention(dim, cfg.attention_head_dim, double=True)
        self.ff = _Mlp(dim)
        self.ff_context = _Mlp(dim)

    def forward(self, h, ctx, temb, cos, sin):
        b, s_img, dim = h.shape
        s_txt = ctx.shape[1]
        silu_t = F.silu(temb)
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = self.norm1(silu_t)
        csh_msa, csc_msa, cg_msa, csh_mlp, csc_mlp, cg_mlp = self.norm1_context(silu_t)
        h_n = _modulate(h, sc_msa, sh_msa)
        c_n = _modulate(ctx, csc_msa, csh_msa)

        a = self.attn
        split = lambda t: t.view(t.shape[0], t.shape[1], self.heads, self.head_dim)  # noqa: E731
        q, k = _rms_qk(a, split(a.to_q(h_n)), split(a.to_k(h_n)))
        cq, ck = _rms_qk(a, split(a.add_q_proj(c_n)), split(a.add_k_proj(c_n)), added=True)
        # joint order [text | image]
        qj = _apply_rope(torch.cat([cq, q], 1), cos, sin)
        kj = _apply_rope(torch.cat([ck, k], 1), cos, sin)
        vj = torch.cat([split(a.add_v_proj(c_n)), split(a.to_v(h_n))], 1)
        out = dot_product_attention(qj, kj, vj).reshape(b, s_txt + s_img, dim)
        attn_c, attn_h = out[:, :s_txt], out[:, s_txt:]

        h = h + g_msa * a.to_out[0](attn_h)
        h = h + g_mlp * self.ff(_modulate(h, sc_mlp, sh_mlp))
        ctx = ctx + cg_msa * a.to_add_out(attn_c)
        ctx = ctx + cg_mlp * self.ff_context(_modulate(ctx, csc_mlp, csh_mlp))
        return h, ctx


class _SingleBlock(nn.Module):
    """diffusers ``FluxSingleTransformerBlock``: attention and MLP side by
    side over the whole [text | image] sequence, one gated output projection."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        dim = cfg.dim
        self.heads, self.head_dim = cfg.num_attention_heads, cfg.attention_head_dim
        self.norm = _AdaLN(dim, 3)
        self.attn = _Attention(dim, cfg.attention_head_dim, double=False)
        self.proj_mlp = nn.Linear(dim, 4 * dim)
        self.proj_out = nn.Linear(5 * dim, dim)

    def forward(self, x, temb, cos, sin):
        b, s, dim = x.shape
        sh, sc, gate = self.norm(F.silu(temb))
        x_n = _modulate(x, sc, sh)
        a = self.attn
        split = lambda t: t.view(b, s, self.heads, self.head_dim)  # noqa: E731
        q, k = _rms_qk(a, split(a.to_q(x_n)), split(a.to_k(x_n)))
        attn = dot_product_attention(_apply_rope(q, cos, sin), _apply_rope(k, cos, sin), split(a.to_v(x_n)))
        mlp = _gelu(self.proj_mlp(x_n))
        return x + gate * self.proj_out(torch.cat([attn.reshape(b, s, dim), mlp], dim=-1))


class _FluxTimeTextEmbed(nn.Module):
    """diffusers ``CombinedTimestep(Guidance)TextProjEmbeddings``."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.timestep_embedder = _LinearPair(256, cfg.dim)
        self.guidance_embedder = _LinearPair(256, cfg.dim) if cfg.guidance_embeds else None
        self.text_embedder = _LinearPair(cfg.pooled_projection_dim, cfg.dim)


class FluxTransformer(nn.Module):
    """``forward(x [B, h, w, C], t [] or [B], encoder_hidden_states [B, L,
    joint_dim], pooled_projections [B, pooled_dim], guidance [] or [B] or
    None)`` -> velocity [B, h, w, C] float32. ``t`` and ``guidance`` are raw
    train-timestep-scale values (diffusers' forward multiplies its /1000
    inputs back by 1000); h and w must be even."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.dim
        self.x_embedder = nn.Linear(4 * cfg.in_channels, dim)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, dim)
        self.time_text_embed = _FluxTimeTextEmbed(cfg)
        self.transformer_blocks = nn.ModuleList(_DoubleBlock(cfg) for _ in range(cfg.num_layers))
        self.single_transformer_blocks = nn.ModuleList(_SingleBlock(cfg) for _ in range(cfg.num_single_layers))
        self.norm_out = _AdaLN(dim, 2)
        self.proj_out = nn.Linear(dim, 4 * cfg.in_channels)

    def forward(self, x, t, encoder_hidden_states, pooled_projections, guidance=None) -> torch.Tensor:
        cfg = self.cfg
        b, hh, ww, c = x.shape
        gh, gw = hh // 2, ww // 2
        dim = cfg.dim
        s_txt = encoder_hidden_states.shape[1]
        dtype = self.x_embedder.weight.dtype
        dev = x.device

        # 2x2 packing, channel-major (c, p1, p2) as diffusers _pack_latents
        tokens = x.reshape(b, gh, 2, gw, 2, c).permute(0, 1, 3, 5, 2, 4).reshape(b, gh * gw, 4 * c)
        h = self.x_embedder(tokens.to(dtype))
        ctx = self.context_embedder(encoder_hidden_states.to(dtype))

        emb = self.time_text_embed
        temb = emb.timestep_embedder(timestep_embedding(t, 256, cos_first=True, device=dev).to(dtype))
        if cfg.guidance_embeds:
            if guidance is None:
                raise ValueError("guidance_embeds=True requires a guidance value")
            temb = temb + emb.guidance_embedder(timestep_embedding(guidance, 256, cos_first=True, device=dev).to(dtype))
        temb = temb + emb.text_embedder(pooled_projections.to(dtype))
        if temb.shape[0] == 1 and b > 1:
            temb = temb.expand(b, dim)

        # RoPE ids: text tokens at the origin, image tokens on the (row, col) grid
        rows = torch.arange(gh, dtype=torch.float32, device=dev).repeat_interleave(gw)
        cols = torch.arange(gw, dtype=torch.float32, device=dev).repeat(gh)
        img_ids = torch.stack([torch.zeros_like(rows), rows, cols], dim=-1)
        txt_ids = torch.zeros(s_txt, 3, device=dev)
        cos, sin = _rope_cos_sin(torch.cat([txt_ids, img_ids]), cfg.axes_dims_rope)

        h, ctx = run_blocks(self.transformer_blocks, cfg.remat, (h, ctx), temb, cos, sin)
        (seq,) = run_blocks(self.single_transformer_blocks, cfg.remat, (torch.cat([ctx, h], 1),), temb, cos, sin)
        h = seq[:, s_txt:]

        sc, sh = self.norm_out(F.silu(temb))
        h = self.proj_out(_modulate(h, sc, sh))
        h = h.reshape(b, gh, gw, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
        return h.reshape(b, hh, ww, c).float()
