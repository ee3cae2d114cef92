"""Pipelines of the port (JAX counterpart: ``diffusion_uncertainty_tpu/pipelines/``)."""

from .safety_checker import (  # noqa: F401
    SafetyChecker,
    clip_preprocess,
    load_safety_checker,
    run_safety_checker,
    safety_scores,
)
from .text_encoder import (  # noqa: F401
    T2ITowers,
    encode_prompts,
    encode_prompts_ex,
    encode_tokens,
    pseudo_text_embeddings,
    pseudo_token_ids,
)
from .text_to_image import T2IPipelineConfig, T2IResult, TextToImageUncertaintyPipeline, cfg_combine  # noqa: F401
