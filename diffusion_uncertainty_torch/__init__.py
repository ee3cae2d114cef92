"""PyTorch / CUDA port of ``diffusion_uncertainty_tpu`` for one NVIDIA H100.

The package mirrors the JAX package file for file (``diffusion/``,
``uncertainty/``, ``models/``, ``ops/``, ``utils/``); each module's docstring
names its JAX counterpart, which stays the reference the port is held
against. Activations keep the JAX layout (NHWC images, [B, S, H, D]
attention). Hand-written Hopper kernels live under ``kernels/`` and are
built with ``nvcc`` at first use; for tensors on the CPU every kernel wrapper
takes its plain PyTorch version.

Precision: the port sets ``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` to False, so float32 convolutions
and matmuls run in full float32 on the card, as the float32 JAX reference
does. The main path itself runs in bfloat16 (weights and activations), with
GroupNorm statistics, timestep embeddings and sampler arithmetic in float32.
"""

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"
