"""The SD 1.5 safety checker, run after the VAE decode: flagged images are
blacked out.

JAX counterpart: ``diffusion_uncertainty_tpu/pipelines/safety_checker.py``
(``SafetyCheckerParams``, ``clip_preprocess``, ``safety_scores``,
``run_safety_checker``, :37-110). ``SafetyChecker`` holds diffusers'
``StableDiffusionSafetyChecker`` state dict as it is (the CLIP ViT-L/14
vision tower under ``vision_model.vision_model``, ``visual_projection`` and
the 17 concept and 3 special-care embeddings with their thresholds), so a
diffusers checkpoint loads with ``load_state_dict`` and
``convert.safety_checker_state_dict_from_flax`` gives the same dict from the
JAX package's parameters. Everything runs in float32.

``clip_preprocess`` resizes as ``jax.image.resize(..., "bicubic")`` does,
not as ``F.interpolate``: Keys' cubic with a = -0.5, the kernel widened by
the scale when it shrinks (antialiasing, 512 -> 224), the weights normalised
per output sample and zeroed where the sample falls outside the input; per
axis a weight matrix, applied as two matrix products.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
from ..models.convert import SAFETY_HEADS
from ..utils.device import resolve_device

__all__ = [
    "SafetyChecker", "clip_preprocess", "load_safety_checker", "safety_scores", "run_safety_checker",
]

# transformers CLIPImageProcessor defaults (OPENAI_CLIP_MEAN / STD)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
N_CONCEPTS, N_SPECIAL = 17, 3


class SafetyChecker(nn.Module):
    """diffusers ``StableDiffusionSafetyChecker``: ``forward(clip_input
    [B, size, size, 3]) -> image_embeds [B, projection_dim]``, the
    heads' parameters beside it."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        proj = cfg.projection_dim
        self.vision_model = CLIPVisionEncoder(dataclasses.replace(cfg, projection_dim=0))
        self.visual_projection = nn.Linear(cfg.hidden_size, proj, bias=False)
        self.concept_embeds = nn.Parameter(torch.empty(N_CONCEPTS, proj))
        self.special_care_embeds = nn.Parameter(torch.empty(N_SPECIAL, proj))
        self.concept_embeds_weights = nn.Parameter(torch.empty(N_CONCEPTS))
        self.special_care_embeds_weights = nn.Parameter(torch.empty(N_SPECIAL))

    def forward(self, clip_input: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(clip_input).pooled)


def _resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_in, n_out] float32 weights of one axis of ``jax.image.resize``'s
    bicubic resize (``compute_weight_mat`` with the Keys kernel, antialias
    on, no translation)."""
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None]).abs() / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, 0.0, w)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps), w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def clip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] images in [0, 1] -> CLIP-normalised [B, size, size, 3]:
    the bicubic resize of the shortest side to ``size``, the centre crop, the
    clip to [0, 1] and the mean / std normalisation (``CLIPImageProcessor``)."""
    b, h, w, c = images.shape
    scale = size / min(h, w)
    nh, nw = max(int(round(h * scale)), size), max(int(round(w * scale)), size)
    x = images.float()
    if nh != h:
        x = torch.einsum("bhwc,hy->bywc", x, _resize_weights(h, nh, x.device))
    if nw != w:
        x = torch.einsum("bywc,wx->byxc", x, _resize_weights(w, nw, x.device))
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, top:top + size, left:left + size, :].clamp(0.0, 1.0)
    mean, std = (torch.tensor(v, dtype=torch.float32, device=x.device) for v in (CLIP_MEAN, CLIP_STD))
    return (x - mean) / std


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def safety_scores(checker: SafetyChecker, clip_input: torch.Tensor, adjustment: float = 0.0):
    """(has_nsfw [B] bool, concept_scores [B, 17], special_scores [B, 3]) of
    CLIP-preprocessed inputs, diffusers' head: a special-care hit lowers
    every concept threshold by 0.01."""
    with torch.no_grad():
        img = _normalize(checker(clip_input).float())
        s_dist = img @ _normalize(checker.special_care_embeds.float()).T
        c_dist = img @ _normalize(checker.concept_embeds.float()).T
        special_scores = s_dist - checker.special_care_embeds_weights[None] + adjustment
        special_adj = torch.where(torch.any(special_scores > 0, dim=-1), 0.01, 0.0)[:, None]
        concept_scores = c_dist - checker.concept_embeds_weights[None] + special_adj
    return torch.any(concept_scores > 0, dim=-1), concept_scores, special_scores


def run_safety_checker(
    checker: Optional[SafetyChecker], images: torch.Tensor, adjustment: float = 0.0
) -> Tuple[torch.Tensor, Optional[np.ndarray]]:
    """(filtered images, has_nsfw_concept) for [B, H, W, 3] images in [0, 1]
    (after the decode): flagged images black. ``checker=None`` skips the
    stage (``has_nsfw_concept`` None), the pipeline's documented
    ``safety_checker=None`` mode."""
    if checker is None:
        return images, None
    has_nsfw, _, _ = safety_scores(checker, clip_preprocess(images, size=checker.cfg.image_size), adjustment)
    filtered = torch.where(has_nsfw[:, None, None, None], torch.zeros_like(images), images)
    return filtered, has_nsfw.cpu().numpy()


def load_safety_checker(state_dict, cfg: Optional[CLIPVisionConfig] = None, device="cuda") -> SafetyChecker:
    """A ``SafetyChecker`` (default: ViT-L/14) with a diffusers state dict,
    float32 on ``device`` (default: the card), no autograd."""
    dev = resolve_device(device)
    with torch.device("meta"):
        checker = SafetyChecker(cfg or CLIPVisionConfig.vit_l_14())
    missing = [k for k in SAFETY_HEADS if k not in state_dict]
    if missing:
        raise KeyError(f"safety checker heads missing: {missing}")
    checker.load_state_dict({k: torch.as_tensor(v).float() for k, v in state_dict.items()}, assign=True)
    return checker.to(dev).eval().requires_grad_(False)
