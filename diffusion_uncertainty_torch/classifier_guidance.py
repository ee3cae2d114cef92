"""ADM classifier guidance as a wrapper of the conditioned forward.

JAX counterpart: ``diffusion_uncertainty_tpu/classifier_guidance.py``
(``with_classifier_guidance``). Per step the guided output is

    eps' = eps - sqrt(1 - alpha_bar_t) * scale * grad_x sum_b log_softmax(logits_b)[y_b]

with the noisy classifier's logits taken in float32 from ``x.float()``. The
sampler runs without autograd (``sample_ddim`` is ``torch.no_grad``), so the
wrapper turns it on around the classifier alone and returns a detached
float32 tensor (the type JAX's promotion gives).
"""

from __future__ import annotations

from typing import Callable

import torch

from .diffusion.schedule import NoiseSchedule

__all__ = ["with_classifier_guidance"]


def with_classifier_guidance(
    apply_fn: Callable,  # (x, t, y, noise) -> eps
    classifier_apply: Callable,  # (x, t) -> logits [B, num_classes]
    schedule: NoiseSchedule,
    classifier_scale: float = 1.0,
) -> Callable:
    def guided(x, t, y, noise):
        eps = apply_fn(x, t, y, noise)
        with torch.enable_grad():
            xi = x.detach().float().requires_grad_(True)
            logp = torch.log_softmax(classifier_apply(xi, t).float(), dim=-1)
            selected = logp[torch.arange(xi.shape[0], device=xi.device), y].sum()
            (grad,) = torch.autograd.grad(selected, xi)
        ab = schedule.alpha_bar(t)
        return eps.float() - torch.sqrt(1.0 - ab) * classifier_scale * grad

    return guided
