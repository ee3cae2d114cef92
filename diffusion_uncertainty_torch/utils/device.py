"""Device choice of the port's entry points.

No JAX counterpart: JAX places arrays on its default backend. The port's
entry points (``make_schedule``, ``TorchNoise``, ``build_sd_stack``, the
text-to-image CLI) run on the card unless the caller asks for the CPU; with
no card they raise instead of falling back.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA card is available (pass device='cpu' to run on the CPU)")
    return dev
