"""Hand-written Hopper (sm_90a) CUDA kernels of the port.

One module per kernel: the ctypes wrapper and its plain PyTorch version
(taken for CPU tensors only); launches are counted by name in
``_build.LAUNCHES`` (``launch_counts``), attention launches also by route
(``route_counts``), GroupNorm calls by route (``gn_route_counts``), the
GroupNorm pair's launches by word width (``gn_pair_route_counts``), and
avg-pool and interleave launches by route and pairing (``resample_counts``).
``_build`` compiles ``csrc/*.cu`` with ``nvcc`` at first
use.
"""

from . import attention, avgpool, groupnorm, interleave, winograd  # noqa: F401
from ._build import COUNTERS, SOURCES, build  # noqa: F401
from ._build import LAUNCHES as _LAUNCHES


def launch_counts() -> dict[str, int]:
    """Kernel launches by counter name since the last reset."""
    return {name: _LAUNCHES[name] for name in COUNTERS}


def route_counts() -> dict[str, int]:
    """Attention launches by route since the last reset."""
    return {name: attention.ROUTE_LAUNCHES[name] for name in attention.ROUTES}


def gn_route_counts() -> dict[str, int]:
    """GroupNorm calls by route (one_launch / pair) since the last reset."""
    return {name: groupnorm.ROUTE_LAUNCHES[name] for name in groupnorm.ROUTES}


def gn_pair_route_counts() -> dict[str, int]:
    """gn_stats and gn_apply launches by their plan's route (wide: 16-byte
    words; scalar: one element a load) since the last reset."""
    return {name: groupnorm.PAIR_ROUTE_LAUNCHES[name] for name in groupnorm.PAIR_ROUTES}


def resample_counts() -> dict[str, dict[str, int]]:
    """avg-pool and interleave launches by route (wide / narrow) and those
    that served two jobs (pair), since the last reset."""
    return {counter: {name: k.ROUTE_LAUNCHES[name] for name in (*k.ROUTES, "pair")}
            for counter, k in (("avg_pool_2x2", avgpool), ("interleave_2x", interleave))}


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
    for k in (attention, groupnorm, avgpool, interleave):
        k.ROUTE_LAUNCHES.clear()
    groupnorm.PAIR_ROUTE_LAUNCHES.clear()
