"""Weights carried across between the JAX package and the port.

JAX counterpart: ``diffusion_uncertainty_tpu/models/convert.py``. The port's
modules use the reference's torch state-dict layout, so a reference
checkpoint loads directly. Each function here goes the other way from one
JAX converter: it takes the JAX model's parameters (nested dicts of arrays,
with or without the ``{"params": ...}`` wrapper) and returns the
reference-layout state dict (float32, on the CPU), undoing every transpose
exactly:

* ``adm_state_dict_from_flax`` inverts ``convert_adm_unet`` (and its legacy
  qkv row permutation);
* ``adm_classifier_state_dict_from_flax`` inverts ``convert_adm_classifier``
  (the reference ``EncoderUNetModel`` layout: new-order attention, the
  ``AttentionPool2d`` head, or the "adaptive" 1×1-conv head that the JAX
  model's mean pool computes);
* ``unet2d_state_dict_from_flax`` inverts ``convert_unet2d`` (the diffusers
  ``UNet2DModel`` layout of ``google/ddpm-cifar10-32``);
* ``sd_unet_state_dict_from_flax`` inverts ``convert_sd_unet`` (diffusers
  ``UNet2DConditionModel`` layout, 1×1-conv or linear transformer
  projections);
* ``autoencoder_kl_state_dict_from_flax`` inverts ``convert_autoencoder_kl``
  (CompVis KL-f8 layout; the encoder and quant convs when the parameters
  have them);
* ``uvit_state_dict_from_flax`` inverts ``convert_uvit`` (the reference
  ``uvit/uvit.py`` layout; the fused qkv rows need no permutation);
* ``mmdit_state_dict_from_flax`` inverts ``convert_sd3_mmdit`` (diffusers
  ``SD3Transformer2DModel`` layout; the last block has no text-stream
  output projection or MLP);
* ``flux_state_dict_from_flax`` inverts ``convert_flux`` (diffusers
  ``FluxTransformer2DModel`` layout), undoing its token permutation of the
  ``x_embedder`` rows and ``proj_out`` columns;
* ``clip_text_state_dict_from_flax``, ``t5_state_dict_from_flax`` and
  ``clip_vision_state_dict_from_flax`` invert ``convert_clip_text``,
  ``convert_t5_encoder`` and ``convert_clip_vision`` (transformers
  ``CLIPTextModel[WithProjection]``, ``T5EncoderModel`` and
  ``CLIPVisionModelWithProjection`` layouts);
* ``safety_checker_state_dict_from_flax`` inverts ``convert_safety_checker``
  (diffusers ``StableDiffusionSafetyChecker``: the vision tower under the
  doubled ``vision_model.vision_model`` prefix, ``visual_projection`` and the
  concept / special-care heads).

The text and vision tower converters are strict as JAX's are: a missing
parameter raises ``KeyError("missing ...")`` and a leftover one
``KeyError("extra ...")``, so weights read from a file
(``pipelines.text_encoder.T2ITowers.load``) never load partly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

__all__ = [
    "adm_state_dict_from_flax",
    "adm_classifier_state_dict_from_flax",
    "unet2d_state_dict_from_flax",
    "sd_unet_state_dict_from_flax",
    "autoencoder_kl_state_dict_from_flax",
    "uvit_state_dict_from_flax",
    "mmdit_state_dict_from_flax",
    "flux_state_dict_from_flax",
    "clip_text_state_dict_from_flax",
    "t5_state_dict_from_flax",
    "clip_vision_state_dict_from_flax",
    "safety_checker_state_dict_from_flax",
    "load_any_state_dict",
    "flux_token_permutation",
    "legacy_qkv_permutation",
]


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
        if "bias" in p:
            self.put(f"{pfx}.bias", p["bias"])

    def conv1x1(self, pfx: str, p: dict) -> None:
        """A Dense stored as a 1×1 Conv2d [out, in, 1, 1]."""
        self.put(f"{pfx}.weight", np.asarray(p["kernel"]).T[:, :, None, None])
        self.put(f"{pfx}.bias", p["bias"])

    def norm(self, pfx: str, scale, bias) -> None:
        self.put(f"{pfx}.weight", scale)
        self.put(f"{pfx}.bias", bias)

    def hf_resnet(self, pfx: str, p: dict) -> None:
        self.norm(f"{pfx}.norm1", p["norm1_scale"], p["norm1_bias"])
        self.conv(f"{pfx}.conv1", p["conv1"])
        self.dense(f"{pfx}.time_emb_proj", p["time_emb_proj"])
        self.norm(f"{pfx}.norm2", p["norm2_scale"], p["norm2_bias"])
        self.conv(f"{pfx}.conv2", p["conv2"])
        if "conv_shortcut" in p:
            self.conv(f"{pfx}.conv_shortcut", p["conv_shortcut"])

    def hf_attention(self, pfx: str, p: dict) -> None:
        self.norm(f"{pfx}.group_norm", p["norm_scale"], p["norm_bias"])
        for torch_name, flax_name in (("query", "to_q"), ("key", "to_k"), ("value", "to_v"), ("proj_attn", "to_out")):
            self.dense(f"{pfx}.{torch_name}", p[flax_name])

    def sd_transformer(self, pfx: str, p: dict, depth: int, linear_proj: bool) -> None:
        proj = self.dense if linear_proj else self.conv1x1
        self.norm(f"{pfx}.norm", p["norm_scale"], p["norm_bias"])
        proj(f"{pfx}.proj_in", p["proj_in"])
        proj(f"{pfx}.proj_out", p["proj_out"])
        for k in range(depth):
            b, blk = f"{pfx}.transformer_blocks.{k}", p[f"block_{k}"]
            for n in ("norm1", "norm2", "norm3"):
                self.norm(f"{b}.{n}", blk[n]["scale"], blk[n]["bias"])
            for a in ("attn1", "attn2"):
                for w in ("to_q", "to_k", "to_v"):
                    self.dense(f"{b}.{a}.{w}", blk[a][w])
                self.dense(f"{b}.{a}.to_out.0", blk[a]["to_out"])
            self.dense(f"{b}.ff.net.0.proj", blk["ff_proj"])
            self.dense(f"{b}.ff.net.2", blk["ff_out"])

    def vae_resblock(self, pfx: str, p: dict) -> None:
        self.norm(f"{pfx}.norm1", p["norm1_scale"], p["norm1_bias"])
        self.conv(f"{pfx}.conv1", p["conv1"])
        self.norm(f"{pfx}.norm2", p["norm2_scale"], p["norm2_bias"])
        self.conv(f"{pfx}.conv2", p["conv2"])
        if "nin_shortcut" in p:
            self.conv(f"{pfx}.nin_shortcut", p["nin_shortcut"])

    def vae_attn(self, pfx: str, p: dict) -> None:
        self.norm(f"{pfx}.norm", p["norm_scale"], p["norm_bias"])
        for w in ("q", "k", "v", "proj_out"):
            self.conv1x1(f"{pfx}.{w}", p[w])

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


def adm_classifier_state_dict_from_flax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``ADMClassifier`` params -> reference ``EncoderUNetModel`` state
    dict. Walks the same block program as ``convert_adm_classifier``; the
    pool's positional embedding goes back to [C, H·W+1] and its projections
    to 1×1 Conv1d weights."""
    P = params.get("params", params)
    out = _Out()
    mc = cfg.model_channels
    out.dense("time_embed.0", P["time_dense_0"])
    out.dense("time_embed.2", P["time_dense_1"])
    out.conv("input_blocks.0.0", P["conv_in"])
    ds, ch, idx = 1, mc, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            out.resblock(f"input_blocks.{idx}.0", P[f"in_{idx}_res"])
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                out.attention(f"input_blocks.{idx}.1", P[f"in_{idx}_attn"], ch, ch // cfg.num_head_channels, False)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                out.resblock(f"input_blocks.{idx}.0", P[f"in_{idx}_down"])
            else:
                out.conv(f"input_blocks.{idx}.0.op", P[f"in_{idx}_down"]["op"])
            idx += 1
            ds *= 2

    out.resblock("middle_block.0", P["mid_res_0"])
    out.attention("middle_block.1", P["mid_attn"], ch, ch // cfg.num_head_channels, False)
    out.resblock("middle_block.2", P["mid_res_1"])
    out.put("out.0.weight", P["out_norm_scale"])
    out.put("out.0.bias", P["out_norm_bias"])
    if "pool" in P:
        pool = P["pool"]
        out.put("out.2.positional_embedding", np.asarray(pool["positional_embedding"]).T)
        out.put("out.2.qkv_proj.weight", np.asarray(pool["qkv"]["kernel"]).T[:, :, None])
        out.put("out.2.qkv_proj.bias", pool["qkv"]["bias"])
        out.put("out.2.c_proj.weight", np.asarray(pool["proj"]["kernel"]).T[:, :, None])
        out.put("out.2.c_proj.bias", pool["proj"]["bias"])
    else:
        out.conv1x1("out.3", P["head"])
    return out.sd


def unet2d_state_dict_from_flax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``UNet2D`` params -> diffusers ``UNet2DModel`` state dict (the
    checkpoint's legacy attention names). Walks the same block program as
    ``convert_unet2d``."""
    P = params.get("params", params)
    out = _Out()
    n_levels = len(cfg.block_out_channels)
    out.dense("time_embedding.linear_1", P["time_dense_0"])
    out.dense("time_embedding.linear_2", P["time_dense_1"])
    out.conv("conv_in", P["conv_in"])
    for bi, btype in enumerate(cfg.down_block_types):
        for li in range(cfg.layers_per_block):
            out.hf_resnet(f"down_blocks.{bi}.resnets.{li}", P[f"down_{bi}_res_{li}"])
            if btype == "AttnDownBlock2D":
                out.hf_attention(f"down_blocks.{bi}.attentions.{li}", P[f"down_{bi}_attn_{li}"])
        if bi != n_levels - 1:
            out.conv(f"down_blocks.{bi}.downsamplers.0.conv", P[f"down_{bi}_downsample"]["conv"])
    out.hf_resnet("mid_block.resnets.0", P["mid_res_0"])
    out.hf_attention("mid_block.attentions.0", P["mid_attn"])
    out.hf_resnet("mid_block.resnets.1", P["mid_res_1"])
    for bi, btype in enumerate(cfg.up_block_types):
        for li in range(cfg.layers_per_block + 1):
            out.hf_resnet(f"up_blocks.{bi}.resnets.{li}", P[f"up_{bi}_res_{li}"])
            if btype == "AttnUpBlock2D":
                out.hf_attention(f"up_blocks.{bi}.attentions.{li}", P[f"up_{bi}_attn_{li}"])
        if bi != n_levels - 1:
            out.conv(f"up_blocks.{bi}.upsamplers.0.conv", P[f"up_{bi}_upsample"])
    out.norm("conv_norm_out", P["out_norm_scale"], P["out_norm_bias"])
    out.conv("conv_out", P["conv_out"])
    return out.sd


def sd_unet_state_dict_from_flax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``SDUNet`` params -> diffusers ``UNet2DConditionModel`` state dict.
    Walks the same block program as ``convert_sd_unet``."""
    P = params.get("params", params)
    out = _Out()
    depth, lin = cfg.transformer_layers_per_block, cfg.use_linear_projection
    out.dense("time_embedding.linear_1", P["time_dense_0"])
    out.dense("time_embedding.linear_2", P["time_dense_1"])
    out.conv("conv_in", P["conv_in"])
    n_levels = len(cfg.block_out_channels)
    for bi, btype in enumerate(cfg.down_block_types):
        for li in range(cfg.layers_per_block):
            out.hf_resnet(f"down_blocks.{bi}.resnets.{li}", P[f"down_{bi}_res_{li}"])
            if btype == "CrossAttnDownBlock2D":
                out.sd_transformer(f"down_blocks.{bi}.attentions.{li}", P[f"down_{bi}_attn_{li}"], depth, lin)
        if bi != n_levels - 1:
            out.conv(f"down_blocks.{bi}.downsamplers.0.conv", P[f"down_{bi}_downsample"])
    out.hf_resnet("mid_block.resnets.0", P["mid_res_0"])
    out.sd_transformer("mid_block.attentions.0", P["mid_attn_0"], depth, lin)
    out.hf_resnet("mid_block.resnets.1", P["mid_res_1"])
    for bi, btype in enumerate(cfg.up_block_types):
        for li in range(cfg.layers_per_block + 1):
            out.hf_resnet(f"up_blocks.{bi}.resnets.{li}", P[f"up_{bi}_res_{li}"])
            if btype == "CrossAttnUpBlock2D":
                out.sd_transformer(f"up_blocks.{bi}.attentions.{li}", P[f"up_{bi}_attn_{li}"], depth, lin)
        if bi != n_levels - 1:
            out.conv(f"up_blocks.{bi}.upsamplers.0.conv", P[f"up_{bi}_upsample"])
    out.norm("conv_norm_out", P["out_norm_scale"], P["out_norm_bias"])
    out.conv("conv_out", P["conv_out"])
    return out.sd


def autoencoder_kl_state_dict_from_flax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``AutoencoderKL`` params -> CompVis KL-f8 state dict. Parameters
    made by a decode-only ``init`` have no encoder or ``quant_conv``; the
    dict then has none either."""
    P = params.get("params", params)
    out = _Out()
    n_levels = len(cfg.ch_mult)
    if "encoder" in P:
        E = P["encoder"]
        out.conv("encoder.conv_in", E["conv_in"])
        for lv in range(n_levels):
            for i in range(cfg.num_res_blocks):
                out.vae_resblock(f"encoder.down.{lv}.block.{i}", E[f"down_{lv}_block_{i}"])
            if lv != n_levels - 1:
                out.conv(f"encoder.down.{lv}.downsample.conv", E[f"down_{lv}_downsample"])
        out.vae_resblock("encoder.mid.block_1", E["mid_block_1"])
        out.vae_attn("encoder.mid.attn_1", E["mid_attn_1"])
        out.vae_resblock("encoder.mid.block_2", E["mid_block_2"])
        out.norm("encoder.norm_out", E["norm_out_scale"], E["norm_out_bias"])
        out.conv("encoder.conv_out", E["conv_out"])
    D = P["decoder"]
    out.conv("decoder.conv_in", D["conv_in"])
    out.vae_resblock("decoder.mid.block_1", D["mid_block_1"])
    out.vae_attn("decoder.mid.attn_1", D["mid_attn_1"])
    out.vae_resblock("decoder.mid.block_2", D["mid_block_2"])
    for lv in reversed(range(n_levels)):
        for i in range(cfg.num_res_blocks + 1):
            out.vae_resblock(f"decoder.up.{lv}.block.{i}", D[f"up_{lv}_block_{i}"])
        if lv != 0:
            out.conv(f"decoder.up.{lv}.upsample.conv", D[f"up_{lv}_upsample"])
    out.norm("decoder.norm_out", D["norm_out_scale"], D["norm_out_bias"])
    out.conv("decoder.conv_out", D["conv_out"])
    for name in ("quant_conv", "post_quant_conv"):
        if name in P:
            out.conv(name, P[name])
    return out.sd


def uvit_state_dict_from_flax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``UViT`` params -> reference U-ViT state dict (``_uvit_block`` and
    ``convert_uvit`` read backwards)."""
    P = params.get("params", params)
    out = _Out()
    out.conv("patch_embed.proj", P["patch_embed"])
    out.put("pos_embed", P["pos_embed"])
    if cfg.num_classes:
        out.put("label_emb.weight", P["label_emb"]["embedding"])
    if cfg.mlp_time_embed:
        out.dense("time_embed.0", P["time_dense_0"])
        out.dense("time_embed.2", P["time_dense_1"])

    def block(pfx: str, p: dict) -> None:
        for name in ("norm1", "norm2"):
            out.norm(f"{pfx}.{name}", p[name]["scale"], p[name]["bias"])
        out.dense(f"{pfx}.attn.qkv", p["attn"]["qkv"])
        out.dense(f"{pfx}.attn.proj", p["attn"]["proj"])
        out.dense(f"{pfx}.mlp.fc1", p["mlp_fc1"])
        out.dense(f"{pfx}.mlp.fc2", p["mlp_fc2"])
        if "skip_linear" in p:
            out.dense(f"{pfx}.skip_linear", p["skip_linear"])

    for i in range(cfg.depth // 2):
        block(f"in_blocks.{i}", P[f"in_block_{i}"])
        block(f"out_blocks.{i}", P[f"out_block_{i}"])
    block("mid_block", P["mid_block"])
    out.norm("norm", P["norm"]["scale"], P["norm"]["bias"])
    out.dense("decoder_pred", P["decoder_pred"])
    if cfg.final_conv:
        out.conv("final_layer", P["final_layer"])
    return out.sd


def mmdit_state_dict_from_flax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``MMDiT`` params -> diffusers ``SD3Transformer2DModel`` state dict
    (``convert_sd3_mmdit`` read backwards)."""
    P = params.get("params", params)
    out = _Out()
    out.conv("pos_embed.proj", P["patch_embed"])
    out.put("pos_embed.pos_embed", np.asarray(P["pos_embed"]).reshape(1, cfg.pos_embed_max_size**2, cfg.dim))
    te = P["time_text_embed"]
    out.dense("time_text_embed.timestep_embedder.linear_1", te["timestep_dense_0"])
    out.dense("time_text_embed.timestep_embedder.linear_2", te["timestep_dense_1"])
    out.dense("time_text_embed.text_embedder.linear_1", te["text_dense_0"])
    out.dense("time_text_embed.text_embedder.linear_2", te["text_dense_1"])
    out.dense("context_embedder", P["context_embedder"])
    out.dense("norm_out.linear", P["norm_out_linear"])
    out.dense("proj_out", P["proj_out"])
    for i in range(cfg.num_layers):
        t, blk = f"transformer_blocks.{i}", P[f"block_{i}"]
        out.dense(f"{t}.norm1.linear", blk["norm1_linear"])
        out.dense(f"{t}.norm1_context.linear", blk["norm1_context_linear"])
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            out.dense(f"{t}.attn.{n}", blk[n])
        out.dense(f"{t}.attn.to_out.0", blk["to_out"])
        out.dense(f"{t}.ff.net.0.proj", blk["ff_proj"])
        out.dense(f"{t}.ff.net.2", blk["ff_out"])
        if cfg.qk_norm == "rms_norm":
            out.put(f"{t}.attn.norm_q.weight", blk["qk_norm"]["q_scale"])
            out.put(f"{t}.attn.norm_k.weight", blk["qk_norm"]["k_scale"])
            out.put(f"{t}.attn.norm_added_q.weight", blk["qk_norm_added"]["added_q_scale"])
            out.put(f"{t}.attn.norm_added_k.weight", blk["qk_norm_added"]["added_k_scale"])
        if i != cfg.num_layers - 1:
            out.dense(f"{t}.attn.to_add_out", blk["to_add_out"])
            out.dense(f"{t}.ff_context.net.0.proj", blk["ff_context_proj"])
            out.dense(f"{t}.ff_context.net.2", blk["ff_context_out"])
    return out.sd


def flux_token_permutation(channels: int) -> np.ndarray:
    """The JAX model's patch-major ``(p1, p2, c)`` token features against the
    channel-major ``(c, p1, p2)`` of diffusers and the port: feature ``i`` of
    a JAX token is feature ``perm[i]`` of the port's (JAX
    ``_flux_token_perm``)."""
    p1, p2, c = np.meshgrid(np.arange(2), np.arange(2), np.arange(channels), indexing="ij")
    return (c * 4 + p1 * 2 + p2).ravel()


def flux_state_dict_from_flax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``FluxTransformer`` params -> diffusers ``FluxTransformer2DModel``
    state dict (``convert_flux`` read backwards, its token permutation of
    the ``x_embedder`` rows and ``proj_out`` columns undone)."""
    P = params.get("params", params)
    out = _Out()
    perm = flux_token_permutation(cfg.in_channels)
    k_in = np.asarray(P["x_embedder"]["kernel"])
    x_kernel = np.empty_like(k_in)
    x_kernel[perm] = k_in
    k_out, b_out = np.asarray(P["proj_out"]["kernel"]), np.asarray(P["proj_out"]["bias"])
    head_kernel, head_bias = np.empty_like(k_out), np.empty_like(b_out)
    head_kernel[:, perm], head_bias[perm] = k_out, b_out
    out.dense("x_embedder", {"kernel": x_kernel, "bias": P["x_embedder"]["bias"]})
    out.dense("proj_out", {"kernel": head_kernel, "bias": head_bias})
    out.dense("context_embedder", P["context_embedder"])
    for n in ("timestep", "guidance", "text"):  # flux-schnell has no guidance embedder
        if f"{n}_dense_0" in P:
            out.dense(f"time_text_embed.{n}_embedder.linear_1", P[f"{n}_dense_0"])
            out.dense(f"time_text_embed.{n}_embedder.linear_2", P[f"{n}_dense_1"])
    out.dense("norm_out.linear", P["norm_out_linear"])

    def qk(pfx: str, blk: dict, added: bool) -> None:
        a = "added_" if added else ""
        out.put(f"{pfx}.attn.norm_{a}q.weight", blk[f"{a}q_scale"])
        out.put(f"{pfx}.attn.norm_{a}k.weight", blk[f"{a}k_scale"])

    for i in range(cfg.num_layers):
        t, blk = f"transformer_blocks.{i}", P[f"block_{i}"]
        out.dense(f"{t}.norm1.linear", blk["norm1_linear"])
        out.dense(f"{t}.norm1_context.linear", blk["norm1_context_linear"])
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out"):
            out.dense(f"{t}.attn.{n}", blk[n])
        qk(t, blk, False)
        qk(t, blk, True)
        out.dense(f"{t}.attn.to_out.0", blk["to_out"])
        out.dense(f"{t}.ff.net.0.proj", blk["ff_proj"])
        out.dense(f"{t}.ff.net.2", blk["ff_out"])
        out.dense(f"{t}.ff_context.net.0.proj", blk["ff_context_proj"])
        out.dense(f"{t}.ff_context.net.2", blk["ff_context_out"])
    for i in range(cfg.num_single_layers):
        t, blk = f"single_transformer_blocks.{i}", P[f"single_block_{i}"]
        out.dense(f"{t}.norm.linear", blk["norm_linear"])
        for n in ("to_q", "to_k", "to_v"):
            out.dense(f"{t}.attn.{n}", blk[n])
        qk(t, blk, False)
        out.dense(f"{t}.proj_mlp", blk["proj_mlp"])
        out.dense(f"{t}.proj_out", blk["proj_out"])
    return out.sd


class _Leaves:
    """JAX parameters (with or without the ``{"params": ...}`` wrapper) as
    '/'-joined leaves, each taken once into an ``_Out``; ``finish`` raises on
    a leaf never taken."""

    def __init__(self, params):
        self.flat: Dict[str, np.ndarray] = {}
        self._walk(params.get("params", params), "")
        self.out = _Out()

    def _walk(self, tree, pfx: str) -> None:
        for k, v in tree.items():
            if hasattr(v, "items"):
                self._walk(v, f"{pfx}{k}/")
            else:
                self.flat[f"{pfx}{k}"] = v

    def leaf(self, path: str):
        if path not in self.flat:
            raise KeyError(f"missing flax parameter: {path}")
        return self.flat.pop(path)

    def put(self, key: str, path: str) -> None:
        self.out.put(key, self.leaf(path))

    def dense(self, key: str, path: str, bias: bool = True) -> None:
        self.out.put(f"{key}.weight", np.asarray(self.leaf(f"{path}/kernel")).T)
        if bias:
            self.put(f"{key}.bias", f"{path}/bias")

    def norm(self, key: str, path: str) -> None:
        self.put(f"{key}.weight", f"{path}/scale")
        self.put(f"{key}.bias", f"{path}/bias")

    def clip_layer(self, key: str, path: str) -> None:
        self.norm(f"{key}.layer_norm1", f"{path}/layer_norm1")
        self.norm(f"{key}.layer_norm2", f"{path}/layer_norm2")
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.dense(f"{key}.self_attn.{n}", f"{path}/self_attn/{n}")
        self.dense(f"{key}.mlp.fc1", f"{path}/fc1")
        self.dense(f"{key}.mlp.fc2", f"{path}/fc2")

    def finish(self) -> Dict[str, torch.Tensor]:
        if self.flat:
            raise KeyError(f"extra flax parameters: {sorted(self.flat)[:5]}")
        return self.out.sd


def clip_text_state_dict_from_flax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPTextEncoder`` params -> transformers ``CLIPTextModel`` state
    dict, with ``text_projection`` when ``cfg.projection_dim > 0``
    (``convert_clip_text`` read backwards)."""
    P = _Leaves(params)
    t = "text_model"
    P.put(f"{t}.embeddings.token_embedding.weight", "token_embedding/embedding")
    P.put(f"{t}.embeddings.position_embedding.weight", "position_embedding")
    for i in range(cfg.num_layers):
        P.clip_layer(f"{t}.encoder.layers.{i}", f"layer_{i}")
    P.norm(f"{t}.final_layer_norm", "final_layer_norm")
    if cfg.projection_dim > 0:
        P.dense("text_projection", "text_projection", bias=False)
    return P.finish()


def t5_state_dict_from_flax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``T5Encoder`` params -> transformers ``T5EncoderModel`` state dict
    without the ``encoder.embed_tokens`` alias (``convert_t5_encoder`` read
    backwards; the relative-position table goes to block 0)."""
    P = _Leaves(params)
    P.put("shared.weight", "token_embedding/embedding")
    P.put("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight", "relative_attention_bias")
    for i in range(cfg.num_layers):
        b, p = f"encoder.block.{i}", f"block_{i}"
        P.put(f"{b}.layer.0.layer_norm.weight", f"{p}/attn_norm/weight")
        for n in ("q", "k", "v", "o"):
            P.dense(f"{b}.layer.0.SelfAttention.{n}", f"{p}/attention/{n}", bias=False)
        P.put(f"{b}.layer.1.layer_norm.weight", f"{p}/ff_norm/weight")
        for n in ("wi_0", "wi_1", "wo") if cfg.feed_forward_proj == "gated-gelu" else ("wi", "wo"):
            P.dense(f"{b}.layer.1.DenseReluDense.{n}", f"{p}/{n}", bias=False)
    P.put("encoder.final_layer_norm.weight", "final_layer_norm/weight")
    return P.finish()


def clip_vision_state_dict_from_flax(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPVisionEncoder`` params -> transformers
    ``CLIPVisionModel[WithProjection]`` state dict (``convert_clip_vision``
    read backwards; the patch conv back to [D, 3, p, p])."""
    P = _Leaves(params)
    v = "vision_model"
    P.put(f"{v}.embeddings.class_embedding", "class_embedding")
    P.out.put(f"{v}.embeddings.patch_embedding.weight", np.asarray(P.leaf("patch_embedding/kernel")).transpose(3, 2, 0, 1))
    P.put(f"{v}.embeddings.position_embedding.weight", "position_embedding")
    P.norm(f"{v}.pre_layrnorm", "pre_layrnorm")
    for i in range(cfg.num_layers):
        P.clip_layer(f"{v}.encoder.layers.{i}", f"layer_{i}")
    P.norm(f"{v}.post_layernorm", "post_layernorm")
    if cfg.projection_dim > 0:
        P.dense("visual_projection", "visual_projection", bias=False)
    return P.finish()


SAFETY_HEADS = ("concept_embeds", "special_care_embeds", "concept_embeds_weights", "special_care_embeds_weights")


def safety_checker_state_dict_from_flax(sc, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``SafetyCheckerParams`` (the vision tower with its projection and
    the four heads) -> diffusers ``StableDiffusionSafetyChecker`` state dict
    (``convert_safety_checker`` read backwards)."""
    tower = clip_vision_state_dict_from_flax(sc.vision, cfg)
    sd = {k if k == "visual_projection.weight" else f"vision_model.{k}": w for k, w in tower.items()}
    sd.update({name: torch.from_numpy(np.array(getattr(sc, name), dtype=np.float32)) for name in SAFETY_HEADS})
    return sd


def load_any_state_dict(path) -> Dict[str, torch.Tensor]:
    """A file, or a diffusers / transformers model folder (every
    ``*.safetensors``, else every ``*.bin`` / ``*.pt`` / ``*.pth``), as one
    {key: float32 CPU tensor} dict (JAX ``load_any_state_dict``)."""

    def load(f: Path) -> dict:
        if f.suffix == ".safetensors":
            from safetensors.torch import load_file

            return load_file(str(f))
        obj = torch.load(f, map_location="cpu", weights_only=True)
        return obj["state_dict"] if isinstance(obj.get("state_dict"), dict) else obj

    p = Path(path)
    files = [p] if p.is_file() else sorted(p.glob("*.safetensors")) or [
        f for ext in ("*.bin", "*.pt", "*.pth") for f in sorted(p.glob(ext))]
    if not files:
        raise FileNotFoundError(f"no weight files under {p}")
    return {k: v.float() for f in files for k, v in load(f).items()}
