"""CLIP vision transformer (the SD 1.5 safety checker's backbone) in
PyTorch, float32.

JAX counterpart: ``diffusion_uncertainty_tpu/models/clip_vision.py``
(``CLIPVisionConfig``, ``CLIPVisionOutput``, ``CLIPVisionEncoder``,
:30-124). The parameter names are transformers'
``CLIPVisionModel[WithProjection]`` keys (``vision_model.embeddings
.patch_embedding.weight``, ..., ``visual_projection.weight``), so
``convert.clip_vision_state_dict_from_flax`` gives the state dict from the
JAX package's parameters. Class token + bias-free patch conv + learned
position embeddings, ``pre_layrnorm``, the text tower's layers
(``clip_text.CLIPLayer``) with no mask, ``post_layernorm`` of the class
token as the pooled output, and the bias-free ``visual_projection``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn as nn

from .clip_text import CLIPLayer, CLIPTextConfig, _drop_position_ids

__all__ = ["CLIPVisionConfig", "CLIPVisionEncoder", "CLIPVisionOutput"]


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768  # 0: no projection

    @staticmethod
    def vit_l_14() -> "CLIPVisionConfig":
        """openai/clip-vit-large-patch14's vision tower, the backbone of
        diffusers' ``StableDiffusionSafetyChecker`` (304.0M parameters)."""
        return CLIPVisionConfig()

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(
            hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, image_size=16, patch_size=4,
            projection_dim=24,
        )

    def as_text_cfg(self) -> CLIPTextConfig:
        """The encoder layers' hyperparameters in the text config's type (the
        layers are the text tower's; only the mask differs)."""
        return CLIPTextConfig(
            hidden_size=self.hidden_size, num_layers=self.num_layers, num_heads=self.num_heads,
            intermediate_size=self.intermediate_size, hidden_act=self.hidden_act, layer_norm_eps=self.layer_norm_eps,
        )


class CLIPVisionOutput(NamedTuple):
    last_hidden: torch.Tensor  # [B, 1 + P, D] float32, no post-LN
    pooled: torch.Tensor  # [B, D] post_layernorm of the class token
    image_embeds: torch.Tensor  # [B, projection_dim] (the pooled output when not projected)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d, grid = cfg.hidden_size, cfg.image_size // cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, d, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(grid * grid + 1, d)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([
            CLIPLayer(cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, cfg.hidden_act, cfg.layer_norm_eps)
            for _ in range(cfg.num_layers)
        ])


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg.as_text_cfg())
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionEncoder(nn.Module):
    """``forward(pixel_values [B, H, W, 3] NHWC, CLIP-normalised) ->
    CLIPVisionOutput``, float32."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionTransformer(cfg)
        if cfg.projection_dim > 0:
            self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
        self._register_load_state_dict_pre_hook(_drop_position_ids)

    def forward(self, pixel_values: torch.Tensor) -> CLIPVisionOutput:
        vm = self.vision_model
        emb = vm.embeddings
        patches = emb.patch_embedding(pixel_values.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)  # [B, P, D]
        cls = emb.class_embedding.expand(patches.shape[0], 1, -1)
        x = vm.pre_layrnorm(torch.cat([cls, patches], dim=1) + emb.position_embedding.weight)
        for layer in vm.encoder.layers:
            x = layer(x, None)  # bidirectional
        pooled = vm.post_layernorm(x[:, 0])
        embeds = self.visual_projection(pooled) if self.cfg.projection_dim > 0 else pooled
        return CLIPVisionOutput(x, pooled, embeds)
