"""Hand-written Hopper (sm_90a) CUDA kernels of the port.

One module per kernel: the ctypes wrapper, its plain PyTorch version (taken
for CPU tensors only) and its launch counter. ``_build`` compiles
``csrc/*.cu`` with ``nvcc`` at first use.
"""

from . import attention, avgpool, groupnorm, interleave  # noqa: F401
from ._build import SOURCES, build  # noqa: F401

# (module, wrapper name) of every kernel launch the main path makes
WRAPPERS = (
    (groupnorm, "gn_stats"),
    (groupnorm, "gn_apply"),
    (attention, "attention"),
    (avgpool, "avg_pool_2x2"),
    (interleave, "interleave_2x"),
)


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, name).launches for mod, name in WRAPPERS}


def reset_launch_counts() -> None:
    for mod, name in WRAPPERS:
        getattr(mod, name).launches = 0
