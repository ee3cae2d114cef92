"""Models of the port (JAX counterpart: ``diffusion_uncertainty_tpu/models/``).
Parameters use the reference's torch state-dict layout."""

from .adm_unet import ADMUNet, ADMUNetConfig  # noqa: F401
from .convert import adm_state_dict_from_flax  # noqa: F401
