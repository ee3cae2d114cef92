"""Text-to-image latent diffusion with uncertainty-guided denoising.

JAX counterpart: ``diffusion_uncertainty_tpu/pipelines/text_to_image.py``
(``cfg_combine``, ``T2IPipelineConfig``, ``TextToImageUncertaintyPipeline``).
A classifier-free-guided DDIM loop that, on the steps
``[start_step_uc, start_step_uc + num_steps_uc)``, hands pred_epsilon to the
percentile guidance (M re-noised forwards, per-image quantile mask,
posterior reweighting or the lr-gradient step), then decodes through the
VAE. The denoiser is one ``denoise_fn(z, t, cond, noise) -> eps`` contract;
the CFG double batch lives here, so any SD-class UNet plugs in.

Draws from the noise source, in order: the initial latents (unless the
caller passes them), then the sampler's (see ``utils.rng``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..diffusion.ddim import DiffusionConfig
from ..diffusion.sampler import SamplerConfig, sample_ddim
from ..diffusion.schedule import NoiseSchedule
from ..uncertainty.guidance import make_percentile_guidance
from ..utils.rng import NoiseSource

__all__ = ["T2IPipelineConfig", "T2IResult", "TextToImageUncertaintyPipeline", "cfg_combine"]


def cfg_combine(eps_uncond: torch.Tensor, eps_cond: torch.Tensor, scale: float) -> torch.Tensor:
    """Classifier-free guidance recombination."""
    return eps_uncond + scale * (eps_cond - eps_uncond)


@dataclasses.dataclass(frozen=True)
class T2IPipelineConfig:
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    # uncertainty window and percentile-guidance knobs
    start_step_uc: int = 0
    num_steps_uc: int = 0
    percentile: float = 0.9
    use_posterior: bool = True
    lr: float = 1.0
    M: int = 5
    latent_channels: int = 4
    latent_size: int = 64  # 512 px / 8
    eta: float = 0.0
    timestep_spacing: str = "leading"
    steps_offset: int = 1  # SD convention


class T2IResult(NamedTuple):
    images: torch.Tensor  # decoded [B, H, W, 3] float in [-1, 1]
    latents: torch.Tensor
    uncertainty: Optional[torch.Tensor]  # [B, num_steps_uc, h, w, c] float32


class TextToImageUncertaintyPipeline:
    """CFG denoiser wrap -> windowed percentile guidance -> DDIM loop -> VAE
    decode. The denoiser and the decoder are injected."""

    def __init__(
        self,
        denoise_fn: Callable,  # (z [B,h,w,c], t, embeds [B,L,D], noise) -> eps
        schedule: NoiseSchedule,
        decode_fn: Optional[Callable] = None,  # latents -> images
        cfg: T2IPipelineConfig = T2IPipelineConfig(),
    ):
        self.denoise_fn = denoise_fn
        self.schedule = schedule
        self.decode_fn = decode_fn
        self.cfg = cfg

    def _cfg_model_fn(self, cond, uncond):
        scale = self.cfg.guidance_scale

        def model_fn(z, t, noise):
            if uncond is None or scale <= 1.0:
                return self.denoise_fn(z, t, cond, noise)
            # one folded forward over [uncond | cond]; the conditioning is
            # tiled to the batch of z (a folded ensemble has M x B rows)
            reps = z.shape[0] // cond.shape[0]
            emb2 = torch.cat([uncond.repeat(reps, 1, 1), cond.repeat(reps, 1, 1)])
            eps2 = self.denoise_fn(torch.cat([z, z]), t, emb2, noise)
            eps_u, eps_c = eps2.chunk(2)
            return cfg_combine(eps_u, eps_c, scale)

        return model_fn

    def __call__(
        self,
        cond_embeds: torch.Tensor,  # [B, L, D] text-encoder output
        noise: NoiseSource,
        uncond_embeds: Optional[torch.Tensor] = None,
        latents: Optional[torch.Tensor] = None,
    ) -> T2IResult:
        c = self.cfg
        b = cond_embeds.shape[0]
        if latents is None:
            shape = (b, c.latent_size, c.latent_size, c.latent_channels)
            latents = noise.normal(shape, torch.float32, cond_embeds.device)

        model_fn = self._cfg_model_fn(cond_embeds, uncond_embeds)
        scfg = SamplerConfig(
            num_inference_steps=c.num_inference_steps,
            num_train_timesteps=self.schedule.num_train_timesteps,
            diffusion=DiffusionConfig(
                clip_sample=False,  # SD latents are unclipped
                eta=c.eta,
                timestep_spacing=c.timestep_spacing,
                steps_offset=c.steps_offset,
            ),
            after_step=c.start_step_uc,
            num_steps_uc=c.num_steps_uc,
        )
        guidance = None
        if c.num_steps_uc > 0:
            guidance = make_percentile_guidance(
                M=c.M, percentile=c.percentile, use_posterior=c.use_posterior, lr=c.lr, dcfg=scfg.diffusion
            )
        res = sample_ddim(model_fn, self.schedule, latents, noise, scfg, guidance=guidance)
        with torch.no_grad():
            images = self.decode_fn(res.sample) if self.decode_fn else res.sample
        u = res.uncertainty.transpose(0, 1) if res.uncertainty is not None else None
        return T2IResult(images=images, latents=res.sample, uncertainty=u)
