"""CLIP text encoder (the SD 1.x conditioning tower and SD3 / Flux's CLIP
towers) in PyTorch, float32.

JAX counterpart: ``diffusion_uncertainty_tpu/models/clip_text.py``
(``CLIPTextConfig``, ``CLIPTextOutput``, ``_act``, ``_CLIPAttention``,
``_CLIPLayer``, ``CLIPTextEncoder``, :28-167). The parameter names are
transformers' ``CLIPTextModel[WithProjection]`` keys (``text_model.encoder
.layers.0.self_attn.q_proj.weight``, ..., ``text_projection.weight``), so a
transformers state dict loads with ``load_state_dict`` (its
``position_ids`` buffer dropped) and ``convert.clip_text_state_dict_from_flax``
gives the same dict from the JAX package's parameters.

Token + learned position embeddings, pre-LN causal transformer layers
(quick-GELU for ViT-L, exact-erf GELU for OpenCLIP bigG), final LN. The
causal mask fills with ``finfo(float32).min``, not ``-inf``, as JAX does.
``penultimate`` is the input of the last layer (transformers'
``hidden_states[-2]``, no final LN); ``pooled`` is the final state at the
first ``eos_token_id``, or at the highest id when ``eos_token_id < 0``
(legacy pooling), projected by the bias-free ``text_projection`` when
``projection_dim > 0``. Attention is plain float32 ``matmul`` + softmax: the
JAX tower computes it with einsums outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["CLIPTextConfig", "CLIPTextEncoder", "CLIPTextOutput", "CLIPLayer"]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # ViT-L/14; OpenCLIP bigG: "gelu" (exact erf)
    eos_token_id: int = -1  # -1: legacy argmax pooling (eos is the highest id)
    layer_norm_eps: float = 1e-5
    projection_dim: int = 0  # > 0: the bias-free text projection of the pooled state

    @staticmethod
    def vit_l_14() -> "CLIPTextConfig":
        """openai/clip-vit-large-patch14 text tower (SD 1.5; 123.1M parameters)."""
        return CLIPTextConfig()

    @staticmethod
    def vit_l_14_projected() -> "CLIPTextConfig":
        """SD3 / Flux text_encoder: CLIP ViT-L with a 768-d projection (123.7M)."""
        return CLIPTextConfig(eos_token_id=49407, projection_dim=768)

    @staticmethod
    def vit_bigg_14() -> "CLIPTextConfig":
        """SD3 text_encoder_2: OpenCLIP bigG/14 with a 1280-d projection (694.7M)."""
        return CLIPTextConfig(
            hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120, hidden_act="gelu",
            eos_token_id=49407, projection_dim=1280,
        )

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=99, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, max_position_embeddings=16,
        )


class CLIPTextOutput(NamedTuple):
    last_hidden: torch.Tensor  # [B, L, D] float32, after the final LN
    pooled: torch.Tensor  # [B, D], or [B, projection_dim] when projected
    penultimate: torch.Tensor  # [B, L, D] the last layer's input, no final LN


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":  # transformers' "gelu": the exact erf form
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(name)


class _CLIPAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, n, nn.Linear(d, d))

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        b, length, d = x.shape
        hd = d // self.heads
        split = lambda a: a.view(b, length, self.heads, hd).transpose(1, 2)  # noqa: E731 -> [B, H, L, hd]
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, length, d))


class _MLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, inner), nn.Linear(inner, d)


class CLIPLayer(nn.Module):
    """Pre-LN attention and MLP, each residual. ``mask`` [L, L] bool (True:
    attend), or None for all keys."""

    def __init__(self, d: int, heads: int, inner: int, act: str, eps: float):
        super().__init__()
        self.self_attn = _CLIPAttention(d, heads)
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.mlp = _MLP(d, inner)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.act = _act(act)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp.fc2(self.act(self.mlp.fc1(self.layer_norm2(x))))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder([
            CLIPLayer(cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, cfg.hidden_act, cfg.layer_norm_eps)
            for _ in range(cfg.num_layers)
        ])
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextEncoder(nn.Module):
    """``forward(input_ids [B, L] int) -> CLIPTextOutput``, float32."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)
        if cfg.projection_dim > 0:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
        self._register_load_state_dict_pre_hook(_drop_position_ids)

    def forward(self, input_ids: torch.Tensor) -> CLIPTextOutput:
        tm, cfg = self.text_model, self.cfg
        b, length = input_ids.shape
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[:length]
        mask = torch.ones(length, length, dtype=torch.bool, device=x.device).tril()
        penultimate = x
        for i, layer in enumerate(tm.encoder.layers):
            if i == cfg.num_layers - 1:
                penultimate = x
            x = layer(x, mask)
        x = tm.final_layer_norm(x)
        ids = input_ids.long()
        eot = (ids == cfg.eos_token_id).int().argmax(-1) if cfg.eos_token_id >= 0 else ids.argmax(-1)
        pooled = x[torch.arange(b, device=x.device), eot]
        if cfg.projection_dim > 0:
            pooled = self.text_projection(pooled)
        return CLIPTextOutput(x, pooled, penultimate)


def _drop_position_ids(state_dict, prefix, *args):
    """transformers registers an ``embeddings.position_ids`` buffer in some
    versions; the port computes positions, so a checkpoint's copy is dropped."""
    for key in [k for k in state_dict if k.startswith(prefix) and k.endswith("embeddings.position_ids")]:
        del state_dict[key]
