"""Weights carried across between the JAX package and the port.

JAX counterpart: ``diffusion_uncertainty_tpu/models/convert.py``. The port's
modules use the reference's torch state-dict layout, so a reference
checkpoint loads directly. ``adm_state_dict_from_flax`` goes the other way
from ``convert_adm_unet``: it takes the JAX ``ADMUNet`` parameters (nested
dicts of arrays) and returns the reference-layout state dict, undoing every
transpose and the legacy qkv row permutation exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["adm_state_dict_from_flax", "legacy_qkv_permutation"]


def legacy_qkv_permutation(channels: int, heads: int) -> np.ndarray:
    """Row permutation from legacy per-head qkv rows (``h*3d + s*d + j``) to
    qkv-major rows (``s*C + h*d + j``): qkv_major = legacy[perm]."""
    d = channels // heads
    s, h, j = np.meshgrid(np.arange(3), np.arange(heads), np.arange(d), indexing="ij")
    perm = np.empty(3 * channels, np.int64)
    perm[(s * channels + h * d + j).ravel()] = (h * 3 * d + s * d + j).ravel()
    return perm


def _heads(cfg, ch: int, upsample: bool) -> int:
    if cfg.num_head_channels > 0:
        return ch // cfg.num_head_channels
    if upsample and cfg.num_heads_upsample > 0:
        return cfg.num_heads_upsample
    return cfg.num_heads


class _Out:
    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, a) -> None:
        self.sd[key] = torch.from_numpy(np.array(a, dtype=np.float32))

    def conv(self, pfx: str, p: dict) -> None:
        self.put(f"{pfx}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        self.put(f"{pfx}.bias", p["bias"])

    def dense(self, pfx: str, p: dict) -> None:
        self.put(f"{pfx}.weight", np.asarray(p["kernel"]).T)
        self.put(f"{pfx}.bias", p["bias"])

    def resblock(self, pfx: str, p: dict) -> None:
        self.put(f"{pfx}.in_layers.0.weight", p["in_norm_scale"])
        self.put(f"{pfx}.in_layers.0.bias", p["in_norm_bias"])
        self.conv(f"{pfx}.in_layers.2", p["in_conv"])
        self.dense(f"{pfx}.emb_layers.1", p["emb_proj"])
        self.put(f"{pfx}.out_layers.0.weight", p["out_norm_scale"])
        self.put(f"{pfx}.out_layers.0.bias", p["out_norm_bias"])
        self.conv(f"{pfx}.out_layers.3", p["out_conv"])
        if "skip" in p:
            self.conv(f"{pfx}.skip_connection", p["skip"])

    def attention(self, pfx: str, p: dict, channels: int, heads: int, legacy: bool) -> None:
        w = np.asarray(p["qkv"]["kernel"]).T  # [3C, C], qkv-major rows
        b = np.asarray(p["qkv"]["bias"])
        if legacy:
            perm = legacy_qkv_permutation(channels, heads)
            w_l, b_l = np.empty_like(w), np.empty_like(b)
            w_l[perm], b_l[perm] = w, b
            w, b = w_l, b_l
        norm = p["norm"]["GroupNorm_0"]
        self.put(f"{pfx}.norm.weight", norm["scale"])
        self.put(f"{pfx}.norm.bias", norm["bias"])
        self.put(f"{pfx}.qkv.weight", w.reshape(3 * channels, channels, 1))
        self.put(f"{pfx}.qkv.bias", b)
        self.put(f"{pfx}.proj_out.weight", np.asarray(p["proj_out"]["kernel"]).T.reshape(channels, channels, 1))
        self.put(f"{pfx}.proj_out.bias", p["proj_out"]["bias"])


def adm_state_dict_from_flax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``ADMUNet`` params (with or without the ``{"params": ...}``
    wrapper) -> reference-layout torch state dict (float32, on the CPU).
    Walks the same block program as ``convert_adm_unet``."""
    P = params.get("params", params)
    out = _Out()
    legacy = not cfg.use_new_attention_order
    mc = cfg.model_channels
    out.dense("time_embed.0", P["time_dense_0"])
    out.dense("time_embed.2", P["time_dense_1"])
    out.conv("input_blocks.0.0", P["conv_in"])
    if cfg.num_classes is not None:
        out.put("label_emb.weight", P["label_emb"]["embedding"])

    ds, ch, idx = 1, mc, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            out.resblock(f"input_blocks.{idx}.0", P[f"in_{idx}_res"])
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                out.attention(f"input_blocks.{idx}.1", P[f"in_{idx}_attn"], ch, _heads(cfg, ch, False), legacy)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                out.resblock(f"input_blocks.{idx}.0", P[f"in_{idx}_down"])
            else:
                out.conv(f"input_blocks.{idx}.0.op", P[f"in_{idx}_down"]["op"])
            idx += 1
            ds *= 2

    out.resblock("middle_block.0", P["mid_res_0"])
    out.attention("middle_block.1", P["mid_attn"], ch, _heads(cfg, ch, False), legacy)
    out.resblock("middle_block.2", P["mid_res_1"])

    idx = 0
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            out.resblock(f"output_blocks.{idx}.0", P[f"out_{idx}_res"])
            ch = mult * mc
            sub = 1
            if ds in cfg.attention_resolutions:
                out.attention(f"output_blocks.{idx}.{sub}", P[f"out_{idx}_attn"], ch, _heads(cfg, ch, True), legacy)
                sub += 1
            if level and i == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    out.resblock(f"output_blocks.{idx}.{sub}", P[f"out_{idx}_up"])
                else:
                    out.conv(f"output_blocks.{idx}.{sub}.conv", P[f"out_{idx}_up"]["op"])
                ds //= 2
            idx += 1

    out.put("out.0.weight", P["out_norm_scale"])
    out.put("out.0.bias", P["out_norm_bias"])
    out.conv("out.2", P["conv_out"])
    return out.sd
