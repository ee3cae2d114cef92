"""Host-side stand-in text conditioning.

JAX counterpart: ``diffusion_uncertainty_tpu/pipelines/text_encoder.py``
(``pseudo_text_embeddings``, :38-53, a numpy copy with the same bits). The
CLIP text tower and its tokenizer are not ported yet; without CLIP weights
the JAX CLI conditions on these embeddings too.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

__all__ = ["pseudo_text_embeddings", "SD15_TEXT_DIM", "SD15_TEXT_LEN"]

SD15_TEXT_DIM = 768  # CLIP ViT-L/14 hidden size
SD15_TEXT_LEN = 77


def pseudo_text_embeddings(
    prompts: Sequence[str], seq_len: int = SD15_TEXT_LEN, dim: int = SD15_TEXT_DIM
) -> np.ndarray:
    """[len(prompts), seq_len, dim] float32 unit Gaussians seeded by a stable
    hash of each prompt: identical prompts get identical conditioning."""
    out = np.empty((len(prompts), seq_len, dim), np.float32)
    for i, p in enumerate(prompts):
        seed = int.from_bytes(hashlib.sha256(p.encode()).digest()[:4], "little")
        out[i] = np.random.RandomState(seed).randn(seq_len, dim).astype(np.float32)
    return out
