"""T5 v1.1 text encoder (SD3's ``text_encoder_3``, Flux's ``text_encoder_2``)
in PyTorch, float32.

JAX counterpart: ``diffusion_uncertainty_tpu/models/t5_text.py``
(``T5Config``, ``_rel_pos_bucket``, ``_T5LayerNorm``, ``_T5Attention``,
``_T5Block``, ``T5Encoder``, :31-163). The parameter names are transformers'
``T5EncoderModel`` keys (``shared.weight``, ``encoder.block.0.layer.0
.SelfAttention.q.weight``, ..., ``encoder.final_layer_norm.weight``), so a
transformers state dict loads with ``load_state_dict`` (its
``encoder.embed_tokens.weight``, an alias of ``shared.weight``, dropped) and
``convert.t5_state_dict_from_flax`` gives the same dict from the JAX
package's parameters.

Shared token embedding, pre-RMS-norm blocks of self-attention (no bias, no
1/sqrt(d_kv) on the logits; a bucketed relative position bias owned by block
0 and shared by every block) and a gated tanh-GELU (``gelu_new``) or ReLU
feed-forward, final RMS norm with float32 variance. The buckets are computed
in numpy exactly as JAX computes them. ``mask=None`` attends to every key (the
SD3 / Flux pipelines encode max-length-padded ids without a mask).
Attention is plain float32 ``matmul`` + softmax, as in the JAX tower.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["T5Config", "T5Encoder", "init_t5_", "rel_pos_bucket"]


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    feed_forward_proj: str = "gated-gelu"  # v1.1; the original T5: "relu"
    layer_norm_eps: float = 1e-6

    @staticmethod
    def v1_1_xxl() -> "T5Config":
        """google/t5-v1_1-xxl (the SD3 / Flux tower; 4.76B parameters)."""
        return T5Config()

    @staticmethod
    def tiny() -> "T5Config":
        return T5Config(
            vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4, relative_attention_num_buckets=8,
            relative_attention_max_distance=20,
        )


def rel_pos_bucket(rel_pos: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5's bidirectional relative-position buckets (numpy, bit-equal to
    JAX ``_rel_pos_bucket``)."""
    nb = num_buckets // 2
    buckets = np.where(rel_pos > 0, nb, 0).astype(np.int64)
    rel = np.abs(rel_pos)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(is_small, rel, large)


class T5LayerNorm(nn.RMSNorm):
    """RMS norm, no mean and no bias, the variance in float32 (or wider)
    (``weight`` as transformers')."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.reciprocal(torch.sqrt(var + self.eps)) * self.weight.to(xf.dtype)).to(x.dtype)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q, self.k, self.v = (nn.Linear(cfg.d_model, inner, bias=False) for _ in range(3))
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor, mask) -> torch.Tensor:
        b, length, _ = x.shape
        split = lambda a: a.view(b, length, self.heads, self.d_kv).transpose(1, 2)  # noqa: E731 -> [B, H, L, d_kv]
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        logits = torch.matmul(q, k.transpose(-1, -2)) + position_bias  # no 1/sqrt(d_kv)
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :], torch.finfo(torch.float32).min)
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.o(out.transpose(1, 2).reshape(b, length, self.heads * self.d_kv))


class _LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = _SelfAttention(cfg, has_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)


class _DenseReluDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gated = cfg.feed_forward_proj == "gated-gelu"
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.gated:  # transformers' "gelu_new": the tanh form
            return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))
        return self.wo(F.relu(self.wi(h)))


class _LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _DenseReluDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)


class _Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_LayerSelfAttention(cfg, has_bias), _LayerFF(cfg)])

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor, mask) -> torch.Tensor:
        att, ff = self.layer
        x = x + att.SelfAttention(att.layer_norm(x), position_bias, mask)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([_Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)


class T5Encoder(nn.Module):
    """``forward(input_ids [B, L] int, mask [B, L] bool or None) -> last
    hidden [B, L, d_model]`` float32."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg)
        self._register_load_state_dict_pre_hook(_drop_embed_alias)

    def position_bias(self, length: int) -> torch.Tensor:
        """[1, heads, L, L] float32: block 0's table at the numpy buckets."""
        cfg = self.cfg
        rel = np.arange(length)[None, :] - np.arange(length)[:, None]  # key - query
        buckets = rel_pos_bucket(rel, cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        return table[torch.from_numpy(buckets).to(table.device)].permute(2, 0, 1)[None].float()

    def forward(self, input_ids: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.shared(input_ids.long())
        position_bias = self.position_bias(input_ids.shape[1])
        for blk in self.encoder.block:
            x = blk(x, position_bias, mask)
        return self.encoder.final_layer_norm(x).float()


def init_t5_(module: T5Encoder, gen: torch.Generator) -> T5Encoder:
    """Seeded random weights in place at transformers' T5 init scales
    (``T5PreTrainedModel._init_weights``, factor 1): the embedding N(0, 1),
    q N(0, 1/(d_model·d_kv)) (the 1/sqrt(d_kv) that the logits lack is
    folded in here), k, v, wi and the position table N(0, 1/d_model), o
    N(0, 1/(heads·d_kv)), wo N(0, 1/d_ff), the norm scales 1. With N(0, 0.02)
    everywhere, T5-XXL's logits would have a standard deviation near 13: a
    near-argmax softmax in every block, so ill-conditioned that float32 runs
    summed in two orders differ by 7e-4."""
    c = module.cfg
    std = {"shared": 1.0, "q": (c.d_model * c.d_kv) ** -0.5, "k": c.d_model**-0.5, "v": c.d_model**-0.5,
           "o": (c.num_heads * c.d_kv) ** -0.5, "wi": c.d_model**-0.5, "wi_0": c.d_model**-0.5, "wi_1": c.d_model**-0.5,
           "wo": c.d_ff**-0.5, "relative_attention_bias": c.d_model**-0.5}
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner = name.rsplit(".", 2)[-2]
            if owner in ("layer_norm", "final_layer_norm"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std[owner], generator=gen)
    return module


def _drop_embed_alias(state_dict, prefix, *args):
    """transformers' ``encoder.embed_tokens.weight`` is ``shared.weight``."""
    state_dict.pop(prefix + "encoder.embed_tokens.weight", None)
