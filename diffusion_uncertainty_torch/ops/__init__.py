"""Kernel-backed ops of the port (JAX counterpart: ``diffusion_uncertainty_tpu/ops/``).
Each op runs its plain PyTorch version for CPU tensors and a Hopper kernel
for CUDA tensors."""

from .attention import dot_product_attention  # noqa: F401
from .avgpool import avg_pool_2x2, avg_pool_2x2_pair  # noqa: F401
from .fused_upsample import (  # noqa: F401
    conv3x3_nearest_up2,
    interleave_and_upsample_2x,
    interleave_phases_2x,
    nearest_upsample_2x,
)
from .groupnorm import group_norm_silu  # noqa: F401
from .winograd_conv import conv3x3_winograd  # noqa: F401
