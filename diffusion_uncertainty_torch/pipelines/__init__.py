"""Pipelines of the port (JAX counterpart: ``diffusion_uncertainty_tpu/pipelines/``)."""

from .text_encoder import pseudo_text_embeddings  # noqa: F401
from .text_to_image import T2IPipelineConfig, T2IResult, TextToImageUncertaintyPipeline, cfg_combine  # noqa: F401
