"""Models of the port (JAX counterpart: ``diffusion_uncertainty_tpu/models/``).
Parameters use the reference's torch state-dict layout."""

from .adm_unet import ADMClassifier, ADMClassifierConfig, ADMUNet, ADMUNetConfig  # noqa: F401
from .autoencoder import AutoencoderKL, AutoencoderKLConfig  # noqa: F401
from .convert import (  # noqa: F401
    adm_classifier_state_dict_from_flax,
    adm_state_dict_from_flax,
    autoencoder_kl_state_dict_from_flax,
    flux_state_dict_from_flax,
    mmdit_state_dict_from_flax,
    sd_unet_state_dict_from_flax,
    unet2d_state_dict_from_flax,
    uvit_state_dict_from_flax,
)
from .flux import FluxConfig, FluxTransformer  # noqa: F401
from .mmdit import MMDiT, MMDiTConfig  # noqa: F401
from .sd_unet import SDUNet, SDUNetConfig  # noqa: F401
from .unet2d import UNet2D, UNet2DConfig  # noqa: F401
from .uvit import UViT, UViTConfig  # noqa: F401
