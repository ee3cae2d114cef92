"""Noise sources for the sampler and the estimators.

JAX counterpart: ``diffusion_uncertainty_tpu/utils/rng.py`` (threefry keys
split per step and member). Torch cannot reproduce threefry streams, so the
port draws every Gaussian from an object with one method,
``normal(shape, dtype, device) -> Tensor``. ``TorchNoise`` wraps a
``torch.Generator`` on the target device; a test can pass any object with
that method, e.g. one that replays the draws a JAX run made.

Order of draws on the main path (``diffusion.sampler.sample_ddim`` with an
estimator): ``x_T`` is the caller's and is not drawn here. Then, step by
step, the DDIM eta noise of that step (only when ``eta > 0``, shape of x),
and, for each step inside the uncertainty window, the estimator's draws:
``uncertainty_zigzag_centered`` draws member by member, zig by zig, one
float32 tensor of the sample's shape each (M · num_zigzag draws per step);
``uncertainty_centered`` draws one [M, *shape] tensor per step. With a
guidance in place of the estimator (``uncertainty.guidance``), each window
step draws one [M, *shape] tensor for the guidance's ensemble.
"""

from __future__ import annotations

from typing import Protocol, Sequence

import torch

from .device import resolve_device

__all__ = ["NoiseSource", "TorchNoise"]


class NoiseSource(Protocol):
    def normal(self, shape: Sequence[int], dtype: torch.dtype, device) -> torch.Tensor: ...


class TorchNoise:
    """Standard normal draws from a seeded ``torch.Generator`` on ``device``
    (the card unless the caller asks for the CPU; raises without a card)."""

    def __init__(self, seed: int, device="cuda"):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def normal(self, shape, dtype=torch.float32, device=None) -> torch.Tensor:
        out = torch.randn(tuple(shape), generator=self.generator, dtype=dtype, device=self.device)
        return out if device is None else out.to(device)
