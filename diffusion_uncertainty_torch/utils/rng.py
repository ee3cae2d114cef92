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

``diffusion.sampler.sample_ddpm`` draws, at every step, one float32 tensor
of x's shape for the ancestral noise first (the last step too, where the
step masks it off, as JAX draws it and masks it), and then, for each step
inside the window, the estimator's draws as above. ``diffusion.kdpm2``'s
chain is deterministic and draws nothing.

Dropout keep-masks come from ``bernoulli(shape, p, device) -> bool Tensor``
(True with probability ``p``, the keep probability 1 - rate, as flax's
``nn.Dropout``). The ``mc_dropout`` estimator folds its M members into one
[M·B, ...] batch and calls the model once per window step with the noise
source; the model draws one mask of the folded activation at each dropout
site, site by site in forward order (the ``ResnetBlock2D``s of ``UNet2D``,
the ``ResBlock``s of ``ADMUNet``). The trajectory forward draws none.
"""

from __future__ import annotations

from typing import Protocol, Sequence

import torch

from .device import resolve_device

__all__ = ["NoiseSource", "TorchNoise", "batch_seed"]


def batch_seed(seed: int, batch_index: int) -> int:
    """The seed of one batch of a resumable run: ``seed * 2**32 +
    batch_index`` (the JAX ``batch_key`` folds the batch index into the run
    key). Distinct for every (seed, batch) with batch_index < 2**32, and the
    same whichever batches ran before, so a resumed run redraws nothing."""
    if not 0 <= batch_index < 2**32:
        raise ValueError(f"batch index {batch_index} out of range")
    return (int(seed) * 2**32 + int(batch_index)) % 2**63


class NoiseSource(Protocol):
    def normal(self, shape: Sequence[int], dtype: torch.dtype, device) -> torch.Tensor: ...

    def bernoulli(self, shape: Sequence[int], p: float, device) -> torch.Tensor: ...


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

    def bernoulli(self, shape, p: float, device=None) -> torch.Tensor:
        """Bool mask, True with probability ``p``."""
        out = torch.rand(tuple(shape), generator=self.generator, device=self.device) < p
        return out if device is None else out.to(device)
