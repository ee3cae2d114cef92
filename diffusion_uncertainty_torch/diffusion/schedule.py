"""Noise schedules and timestep spacing.

JAX counterpart: ``diffusion_uncertainty_tpu/diffusion/schedule.py``. The beta
families and the spacing are host-side numpy (float64, as there); the tables
the sampler reads are float32 tensors on the caller's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = [
    "NoiseSchedule",
    "make_betas",
    "betas_for_alpha_bar",
    "make_schedule",
    "cosine_schedule",
    "spaced_timesteps",
    "uncertainty_window",
]


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Float32 schedule tables on one device.

    ``final_alpha_cumprod`` is what ``alpha_bar`` returns past t=0: 1.0 when
    the final step reaches the clean image (diffusers ``set_alpha_to_one``),
    else ``alphas_cumprod[0]``.
    """

    betas: torch.Tensor  # [T] float32
    alphas_cumprod: torch.Tensor  # [T] float32
    final_alpha_cumprod: torch.Tensor  # 0-d float32

    @property
    def num_train_timesteps(self) -> int:
        return self.betas.shape[0]

    @property
    def device(self) -> torch.device:
        return self.betas.device

    def alpha_bar(self, t) -> torch.Tensor:
        """alpha_bar_t, with ``final_alpha_cumprod`` for t < 0. ``t`` is an int
        or an integer tensor (per-sample timesteps)."""
        if isinstance(t, (int, np.integer)):
            return self.alphas_cumprod[int(t)] if t >= 0 else self.final_alpha_cumprod
        t = torch.as_tensor(t, device=self.device)
        safe_t = t.clamp(0, self.num_train_timesteps - 1).long()
        return torch.where(t >= 0, self.alphas_cumprod[safe_t], self.final_alpha_cumprod)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """q(x_t | x_0): sqrt(ab_t) x0 + sqrt(1-ab_t) eps, in float32, cast
        back to ``x0.dtype``. Scalar or per-sample ``t``."""
        ab = self.alpha_bar(t).float()
        while ab.ndim < x0.ndim:
            ab = ab[..., None]
        out = torch.sqrt(ab) * x0.float() + torch.sqrt(1.0 - ab) * noise.float()
        return out.to(x0.dtype)


def betas_for_alpha_bar(
    num_train_timesteps: int,
    alpha_bar_fn: Callable[[float], float],
    max_beta: float = 0.999,
) -> np.ndarray:
    """Discretize a continuous alpha-bar function into betas."""
    betas = []
    for i in range(num_train_timesteps):
        t1 = i / num_train_timesteps
        t2 = (i + 1) / num_train_timesteps
        betas.append(min(1.0 - alpha_bar_fn(t2) / alpha_bar_fn(t1), max_beta))
    return np.asarray(betas, dtype=np.float64)


def cosine_schedule(num_train_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """Improved-DDPM cosine schedule."""
    return betas_for_alpha_bar(
        num_train_timesteps,
        lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        max_beta=max_beta,
    )


def make_betas(
    kind: str,
    num_train_timesteps: int,
    beta_start: float = 0.0001,
    beta_end: float = 0.02,
) -> np.ndarray:
    """linear, scaled_linear, squaredcos_cap_v2 (cosine) or sigmoid, float64."""
    if kind == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if kind == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
    if kind in ("squaredcos_cap_v2", "cosine"):
        return cosine_schedule(num_train_timesteps)
    if kind == "sigmoid":
        x = np.linspace(-6.0, 6.0, num_train_timesteps, dtype=np.float64)
        return 1.0 / (1.0 + np.exp(-x)) * (beta_end - beta_start) + beta_start
    raise ValueError(f"unknown beta schedule kind: {kind!r}")


def make_schedule(
    kind: str = "linear",
    num_train_timesteps: int = 1000,
    beta_start: float = 0.0001,
    beta_end: float = 0.02,
    trained_betas: Optional[Sequence[float]] = None,
    set_alpha_to_one: bool = True,
    rescale_betas_zero_snr: bool = False,
    device="cuda",
) -> NoiseSchedule:
    """Float32 schedule tables on ``device`` (the card unless the caller asks
    for the CPU; raises without a card); ``trained_betas`` overrides
    ``kind``; ``rescale_betas_zero_snr`` is the terminal-SNR rescale."""
    device = resolve_device(device)
    if trained_betas is not None:
        betas = np.asarray(trained_betas, dtype=np.float64)
    else:
        betas = make_betas(kind, num_train_timesteps, beta_start, beta_end)

    alphas_cumprod = np.cumprod(1.0 - betas)
    if rescale_betas_zero_snr:
        ab_sqrt = np.sqrt(alphas_cumprod)
        ab0, abT = ab_sqrt[0], ab_sqrt[-1]
        ab_sqrt = (ab_sqrt - abT) * ab0 / (ab0 - abT)
        alphas_cumprod = ab_sqrt**2
        alphas = np.concatenate([alphas_cumprod[:1], alphas_cumprod[1:] / alphas_cumprod[:-1]])
        betas = 1.0 - alphas

    final = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
    return NoiseSchedule(betas=f32(betas), alphas_cumprod=f32(alphas_cumprod), final_alpha_cumprod=f32(final))


def spaced_timesteps(
    num_train_timesteps: int,
    num_inference_steps: int,
    spacing: str = "leading",
    steps_offset: int = 0,
) -> np.ndarray:
    """Descending int32 inference timesteps (linspace / leading / trailing)."""
    if num_inference_steps > num_train_timesteps:
        raise ValueError(
            f"num_inference_steps={num_inference_steps} > num_train_timesteps={num_train_timesteps}"
        )
    if spacing == "linspace":
        ts = np.linspace(0, num_train_timesteps - 1, num_inference_steps).round()[::-1]
    elif spacing == "leading":
        ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio).round()[::-1] + steps_offset
    elif spacing == "trailing":
        ratio = num_train_timesteps / num_inference_steps
        ts = np.round(np.arange(num_train_timesteps, 0, -ratio)) - 1
    else:
        raise ValueError(f"unknown timestep spacing: {spacing!r}")
    return ts.astype(np.int32).copy()


def uncertainty_window(after_step: int, num_steps_uc: int, num_inference_steps: int):
    """The [start, stop) step-index window in which uncertainty is estimated:
    timesteps descend strictly, so the reference's timestep-value check is
    the contiguous range [after_step, after_step + num_steps_uc)."""
    start = max(0, after_step)
    stop = min(num_inference_steps, after_step + num_steps_uc)
    if stop < start:
        raise ValueError(f"empty uncertainty window: [{start}, {stop})")
    return start, stop
