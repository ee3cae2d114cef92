"""ADM (guided-diffusion) UNet in PyTorch, NHWC activations.

JAX counterpart: ``diffusion_uncertainty_tpu/models/adm_unet.py`` (``ADMUNet``,
``ResBlock``, ``_SplitInputConv``, ``_Downsample``, ``_Upsample``,
``ADMClassifierConfig``, ``_AttentionPool``, ``ADMClassifier``). The module
tree and parameter names are the reference's torch ``UNetModel``
(``input_blocks.N.0.in_layers.0.weight``, ...), so a reference state dict
loads with ``load_state_dict``; ``convert.adm_state_dict_from_flax`` gives the
same dict from the JAX package's parameters. The forward follows the JAX
model: fused upsample+conv in the up ResBlocks, concat-free split-skip
decoder blocks, float32 output. An up or down ResBlock resamples in one
kernel launch: a down block pools h and its skip x together, an up block
interleaves its four phase convs and upsamples its skip x together (only
independent work is reordered, so the values are those of the separate
calls).

MC dropout: a forward given a noise source (``forward(..., noise=...)``)
applies dropout (rate ``ADMUNetConfig.dropout``) after each ResBlock's output
GroupNorm+SiLU, as the JAX model with ``deterministic=False``; without one
it is deterministic. ``winograd=True`` routes the ResBlocks' 3×3 convs
(``in_conv`` unless it upsamples, ``out_conv``, and both partials of the
split-skip ``in_conv``, the second fusing the first as its residual, as
``_SplitInputConv``) through the Winograd kernel op where the shape allows;
``conv_in``, ``conv_out`` and the up/down-sampling convs never take it, as
in the JAX model.

``ADMClassifier`` is the noisy classifier of classifier guidance, the
reference's ``EncoderUNetModel``: the UNet encoder (``ResBlock`` with
``down=True``, new-order ``AttentionBlock``) and a pooled 1000-way head, with
the reference's state-dict keys (``convert.adm_classifier_state_dict_from_flax``
gives the same dict from the JAX parameters).

Activation noise (the original ``uncertainty`` estimator): a forward given
``act_noise=`` adds N(0, ``activation_noise_std``²) at the output of the
plain ResBlock of each input or output block named in
``activation_noise_blocks`` (``in_k`` is ``input_blocks[k]``, ``out_k`` is
``output_blocks[k]``, as JAX's block index), before the block's attention;
no down, up or middle block is a site. Each site draws one float32
standard-normal tensor of the activation's full (folded) shape, in block
order, casts it to the activation's type and scales it, as JAX's
``_maybe_noise``. Gradient taps (``flip_grad``): a forward given a dict
``taps=`` adds a zero tensor that requires a gradient at the same place in
every such block, ``taps[tag]``, made on first use with the activation's
shape and type, so ``torch.autograd.grad`` reaches ∂loss/∂(each ResBlock
output) as JAX's ``perturb`` taps (``grad_taps=True``) do. Neither adds a
parameter.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from ..ops.avgpool import avg_pool_2x2_pair
from ..ops.fused_upsample import conv2d_nhwc, interleave_and_upsample_2x
from ..ops.groupnorm import group_norm_silu
from .layers import (
    AttentionBlock,
    Conv2d,
    Conv3x3,
    GroupNorm32,
    avg_pool_2x,
    dropout,
    nearest_upsample,
    split_qkv,
    timestep_embedding,
)

__all__ = ["ADMUNetConfig", "ADMUNet", "ResBlock", "ADMClassifierConfig", "ADMClassifier"]


@dataclasses.dataclass(frozen=True)
class ADMUNetConfig:
    image_size: int = 64
    in_channels: int = 3
    model_channels: int = 192
    out_channels: int = 6
    num_res_blocks: int = 3
    attention_resolutions: Tuple[int, ...] = (2, 4, 8)  # downsample factors
    dropout: float = 0.1  # applied only in a forward given a noise source
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    num_classes: Optional[int] = 1000
    num_heads: int = 4
    num_head_channels: int = -1
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    conv_resample: bool = True
    # the reference's qkv weight order: legacy (per head) or qkv-major
    use_new_attention_order: bool = False
    # route the ResBlock 3x3 convs through the Winograd kernel op
    winograd: bool = False
    # blocks whose plain ResBlock output gets N(0, std²) in a forward given
    # ``act_noise``; the defaults are the reference's four hook sites
    activation_noise_blocks: Tuple[str, ...] = ("in_8", "out_1", "out_4", "out_12")
    activation_noise_std: float = 0.01

    @staticmethod
    def imagenet128() -> "ADMUNetConfig":
        """guided-diffusion ImageNet-128 (421M parameters)."""
        return ADMUNetConfig(
            image_size=128,
            model_channels=256,
            num_res_blocks=2,
            attention_resolutions=(4, 8, 16),
            dropout=0.0,
            channel_mult=(1, 1, 2, 3, 4),
            num_heads=4,
            num_head_channels=-1,
            num_heads_upsample=4,
        )

    @staticmethod
    def imagenet64(dropout: float = 0.1) -> "ADMUNetConfig":
        """guided-diffusion ImageNet-64."""
        return ADMUNetConfig(
            image_size=64,
            model_channels=192,
            num_res_blocks=3,
            attention_resolutions=(2, 4, 8),
            dropout=dropout,
            channel_mult=(1, 2, 3, 4),
            num_heads=4,
            num_head_channels=64,
            num_heads_upsample=4,
            use_new_attention_order=True,
        )

    @staticmethod
    def tiny(num_classes: Optional[int] = 10) -> "ADMUNetConfig":
        """Small test configuration (as the JAX package's)."""
        return ADMUNetConfig(
            image_size=16,
            model_channels=32,
            out_channels=3,
            num_res_blocks=1,
            attention_resolutions=(2,),
            channel_mult=(1, 2),
            num_classes=num_classes,
            num_heads=2,
            activation_noise_blocks=("in_1", "out_1"),
        )


def _split_input_conv(conv: Conv2d, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv over the channel concat of a and b without forming the concat:
    conv(a, W[:, :C1]) + conv(b, W[:, C1:]) + bias. A Winograd ``Conv3x3``
    runs both partials through its route, the second with the first as its
    fused residual."""
    c1 = a.shape[-1]
    if isinstance(conv, Conv3x3) and conv.winograd:
        ya = conv.partial(a, 0, c1, torch.zeros_like(conv.bias))
        return conv.partial(b, c1, None, conv.bias, res=ya)
    w = conv.weight
    pad = conv.padding[0]
    ya = conv2d_nhwc(a, w[:, :c1], None, padding=pad)
    return ya.add_(conv2d_nhwc(b, w[:, c1:], conv.bias, padding=pad))


class ResBlock(nn.Module):
    """ADM residual block with timestep scale-shift conditioning and optional
    in-block up/downsampling. Decoder blocks pass their skip tensor via
    ``skip=``: when GroupNorm's group size divides the first part's width, the
    block runs concat-free (split GN + split convs, exact up to summation
    order); otherwise it concatenates."""

    def __init__(self, c_in: int, c_out: int, emb_dim: int, use_scale_shift_norm: bool = True,
                 up: bool = False, down: bool = False, dropout: float = 0.0, winograd: bool = False):
        super().__init__()
        self.c_in, self.c_out = c_in, c_out
        self.up, self.down = up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.ModuleList([GroupNorm32(c_in), nn.SiLU(), Conv3x3(c_in, c_out, up2=up, winograd=winograd)])
        self.emb_layers = nn.ModuleList([nn.SiLU(), nn.Linear(emb_dim, 2 * c_out if use_scale_shift_norm else c_out)])
        self.out_layers = nn.ModuleList(
            [GroupNorm32(c_out), nn.SiLU(), nn.Dropout(dropout), Conv3x3(c_out, c_out, winograd=winograd)]
        )
        self.skip_connection = Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor, skip: Optional[torch.Tensor] = None, noise=None) -> torch.Tensor:
        gn_in, conv_in = self.in_layers[0], self.in_layers[2]
        split = None
        if skip is not None:
            assert not (self.up or self.down)
            c1, c_tot = x.shape[-1], self.c_in
            gs = c_tot // min(32, c_tot)
            if c1 % gs == 0 and c_tot % min(32, c_tot) == 0 and c_tot != self.c_out:
                split = (c1, gs)
            else:
                x = torch.cat([x, skip], dim=-1)
                skip = None

        if split is None:
            h = group_norm_silu(x, gn_in.weight, gn_in.bias)
            if self.up:
                # fused upsample+conv; the 1x1 skip commutes with nearest
                # upsampling, so it runs at the low resolution. The phase
                # interleave and the skip's upsample are one kernel launch.
                phases = conv_in.phases(h)
                if self.skip_connection is not None:
                    x = self.skip_connection(x)
                h, x = interleave_and_upsample_2x(phases, x)
            else:
                if self.down:
                    h, x = avg_pool_2x2_pair(h, x)  # one kernel launch
                h = conv_in(h)
        else:
            c1, gs = split
            h_a = group_norm_silu(x, gn_in.weight[:c1], gn_in.bias[:c1], num_groups=c1 // gs)
            h_b = group_norm_silu(skip, gn_in.weight[c1:], gn_in.bias[c1:], num_groups=(self.c_in - c1) // gs)
            h = _split_input_conv(conv_in, h_a, h_b)

        emb_out = self.emb_layers[1](F.silu(emb))
        gn_out, conv_out = self.out_layers[0], self.out_layers[3]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = group_norm_silu(h, gn_out.weight, gn_out.bias, scale=scale, shift=shift)
        else:
            h = group_norm_silu(h + emb_out[:, None, None, :].to(h.dtype), gn_out.weight, gn_out.bias)
        h = dropout(h, self.out_layers[2].p, noise)

        if split is not None:
            x = _split_input_conv(self.skip_connection, x, skip)
        elif self.skip_connection is not None and not self.up:
            x = self.skip_connection(x)
        return conv_out(h, res=x)


class _Downsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1) if use_conv else None

    def forward(self, x):
        return self.op(x) if self.op is not None else avg_pool_2x(x)


class _Upsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool):
        super().__init__()
        self.conv = Conv3x3(channels, channels, up2=True) if use_conv else None

    def forward(self, x):
        return self.conv(x) if self.conv is not None else nearest_upsample(x)


class ADMUNet(nn.Module):
    """Class-conditional epsilon(+learned variance) UNet.

    ``forward(x [B,H,W,C], t (int | [B]), y [B'] | None, noise=None,
    act_noise=None, taps=None)`` -> float32 [B, H, W, out_channels];
    ``noise`` turns MC dropout on, ``act_noise`` the activation noise (see
    the module note; the two are never given together), ``taps`` the
    gradient taps. When
    ensemble members are folded into the batch (B = k·B'), the labels are
    tiled k times, member-major.
    """

    def __init__(self, cfg: ADMUNetConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        td = 4 * mc
        self.time_embed = nn.Sequential(nn.Linear(mc, td), nn.SiLU(), nn.Linear(td, td))
        self.label_emb = nn.Embedding(cfg.num_classes, td) if cfg.num_classes is not None else None
        legacy = not cfg.use_new_attention_order

        def attn(ch: int, upsample: bool) -> AttentionBlock:
            if cfg.num_head_channels > 0:
                return AttentionBlock(ch, num_head_channels=cfg.num_head_channels, legacy_order=legacy)
            n = cfg.num_heads_upsample if (upsample and cfg.num_heads_upsample > 0) else cfg.num_heads
            return AttentionBlock(ch, num_heads=n, legacy_order=legacy)

        ss = cfg.use_scale_shift_norm

        def res_block(c_in, c_out, up=False, down=False):
            return ResBlock(c_in, c_out, td, ss, up=up, down=down, dropout=cfg.dropout, winograd=cfg.winograd)

        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv3x3(cfg.in_channels, mc)])])
        input_chs = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res_block(ch, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch, False))
                self.input_blocks.append(nn.ModuleList(layers))
                input_chs.append(ch)
            if level != len(cfg.channel_mult) - 1:
                down = res_block(ch, ch, down=True) if cfg.resblock_updown else _Downsample(ch, cfg.conv_resample)
                self.input_blocks.append(nn.ModuleList([down]))
                input_chs.append(ch)
                ds *= 2

        self.middle_block = nn.ModuleList([res_block(ch, ch), attn(ch, False), res_block(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res_block(ch + input_chs.pop(), mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch, True))
                if level and i == cfg.num_res_blocks:
                    layers.append(res_block(ch, ch, up=True) if cfg.resblock_updown else _Upsample(ch, cfg.conv_resample))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        self.out = nn.ModuleList([GroupNorm32(ch), nn.SiLU(), Conv3x3(ch, cfg.out_channels)])

    def _site(self, h, tag, act_noise, taps):
        """The activation-noise site and gradient tap at a plain ResBlock's
        output (JAX ``ADMUNet._maybe_noise``)."""
        cfg = self.cfg
        if act_noise is not None and tag in cfg.activation_noise_blocks:
            draw = act_noise.normal(tuple(h.shape), torch.float32, h.device)
            h = h + cfg.activation_noise_std * draw.to(h.dtype)
        if taps is not None:
            if tag not in taps:
                taps[tag] = torch.zeros(h.shape, dtype=h.dtype, device=h.device, requires_grad=True)
            h = h + taps[tag]
        return h

    def _block(self, layers, h, emb, skip=None, noise=None, tag=None, act_noise=None, taps=None):
        for i, layer in enumerate(layers):
            if isinstance(layer, ResBlock):
                h = layer(h, emb, skip, noise)
                skip = None
                if i == 0 and tag is not None and not (layer.up or layer.down):
                    h = self._site(h, tag, act_noise, taps)
            else:
                h = layer(h)
        return h

    def forward(self, x: torch.Tensor, t, y: Optional[torch.Tensor] = None, noise=None, act_noise=None,
                taps: Optional[dict] = None) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.time_embed[0].weight.dtype
        emb = timestep_embedding(t, cfg.model_channels, cos_first=True, device=x.device)
        emb = self.time_embed[0](emb.to(dtype))
        emb = self.time_embed[2](F.silu(emb))
        if self.label_emb is not None:
            if y is None:
                raise ValueError("class-conditional model requires y")
            if y.shape[0] != x.shape[0]:
                if x.shape[0] % y.shape[0]:
                    raise ValueError(f"batch {x.shape[0]} is not a multiple of the {y.shape[0]} labels")
                y = y.repeat(x.shape[0] // y.shape[0])  # folded ensemble members
            emb = emb + self.label_emb(y)
        if emb.shape[0] == 1 and x.shape[0] > 1:
            emb = emb.expand(x.shape[0], -1)

        sites = dict(act_noise=act_noise, taps=taps)
        h = self.input_blocks[0][0](x.to(dtype))
        hs = [h]
        for k, layers in enumerate(self.input_blocks[1:], start=1):
            h = self._block(layers, h, emb, noise=noise, tag=f"in_{k}", **sites)
            hs.append(h)
        h = self._block(self.middle_block, h, emb, noise=noise)
        for k, layers in enumerate(self.output_blocks):
            h = self._block(layers, h, emb, skip=hs.pop(), noise=noise, tag=f"out_{k}", **sites)
        gn = self.out[0]
        h = group_norm_silu(h, gn.weight, gn.bias)
        return self.out[2](h).float()


@dataclasses.dataclass(frozen=True)
class ADMClassifierConfig:
    """The reference's ``create_classifier_openai_imagenet`` settings."""

    image_size: int = 64
    in_channels: int = 3
    model_channels: int = 128  # classifier_width
    out_channels: int = 1000
    num_res_blocks: int = 2  # classifier_depth
    attention_resolutions: Tuple[int, ...] = (2, 4, 8)  # downsample factors of the 32, 16, 8 px maps
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    num_head_channels: int = 64
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    # "attention": the CLIP-style head (reference ``AttentionPool2d``); any
    # other value: the spatial mean and a 1x1-conv head (reference "adaptive")
    pool: str = "attention"

    @staticmethod
    def imagenet(image_size: int) -> "ADMClassifierConfig":
        mult = {64: (1, 2, 3, 4), 128: (1, 1, 2, 3, 4), 256: (1, 1, 2, 2, 4, 4)}[image_size]
        attention_ds = tuple(image_size // r for r in (32, 16, 8))
        return ADMClassifierConfig(image_size=image_size, channel_mult=mult, attention_resolutions=attention_ds)


class _AttentionPool(nn.Module):
    """CLIP-style attention pooling (reference ``AttentionPool2d``): the mean
    token in front of the H·W tokens, a learned positional embedding
    [C, H·W+1], a 1×1-conv qkv projection in the new (qkv-major) order,
    attention over all H·W+1 tokens, and the output projection of the mean
    token's row."""

    def __init__(self, spatial: int, channels: int, num_head_channels: int, out_channels: int):
        super().__init__()
        self.num_heads = channels // num_head_channels
        self.positional_embedding = nn.Parameter(torch.randn(channels, spatial * spatial + 1) / channels**0.5)
        self.qkv_proj = nn.Conv1d(channels, 3 * channels, 1)
        self.c_proj = nn.Conv1d(channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c).float()
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = (tokens + self.positional_embedding.float().t()[None]).to(self.qkv_proj.weight.dtype)
        qkv = F.linear(tokens, self.qkv_proj.weight.view(3 * c, c), self.qkv_proj.bias)
        q, k, v = split_qkv(qkv, self.num_heads, legacy=False)
        out = dot_product_attention(q, k, v)[:, 0].reshape(b, c)
        return F.linear(out, self.c_proj.weight.view(-1, c), self.c_proj.bias)


class ADMClassifier(nn.Module):
    """The noisy ImageNet classifier of classifier guidance (reference
    ``EncoderUNetModel``).

    ``forward(x [B,H,W,C], t (int | [1] | [B]))`` -> float32 logits
    [B, out_channels]; a batch-1 timestep embedding is broadcast to the
    batch. The module runs in its parameters' type (float32 as the factory
    builds it)."""

    def __init__(self, cfg: ADMClassifierConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        td = 4 * mc
        ss = cfg.use_scale_shift_norm
        self.time_embed = nn.Sequential(nn.Linear(mc, td), nn.SiLU(), nn.Linear(td, td))

        def attn(ch: int) -> AttentionBlock:
            return AttentionBlock(ch, num_head_channels=cfg.num_head_channels, legacy_order=False)

        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv3x3(cfg.in_channels, mc)])])
        ch, ds = mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [ResBlock(ch, mult * mc, td, ss)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
            if level != len(cfg.channel_mult) - 1:
                down = ResBlock(ch, ch, td, ss, down=True) if cfg.resblock_updown else _Downsample(ch, True)
                self.input_blocks.append(nn.ModuleList([down]))
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, td, ss), attn(ch), ResBlock(ch, ch, td, ss)])
        spatial = cfg.image_size // ds
        if cfg.pool == "attention":
            head = [_AttentionPool(spatial, ch, cfg.num_head_channels, cfg.out_channels)]
        else:  # the pool holds no parameters; it keeps the head conv at the reference's out.3
            head = [nn.AdaptiveAvgPool2d(1), Conv2d(ch, cfg.out_channels, 1)]
        self.out = nn.ModuleList([GroupNorm32(ch), nn.SiLU(), *head])

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.time_embed[0].weight.dtype
        emb = timestep_embedding(t, cfg.model_channels, cos_first=True, device=x.device)
        emb = self.time_embed[0](emb.to(dtype))
        emb = self.time_embed[2](F.silu(emb))
        if emb.shape[0] == 1 and x.shape[0] > 1:
            emb = emb.expand(x.shape[0], -1)

        h = self.input_blocks[0][0](x.to(dtype))
        for layers in (*self.input_blocks[1:], self.middle_block):
            for layer in layers:
                h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
        gn = self.out[0]
        h = group_norm_silu(h, gn.weight, gn.bias)
        if cfg.pool == "attention":
            return self.out[2](h).float()
        conv = self.out[3]
        pooled = h.mean(dim=(1, 2))
        return F.linear(pooled, conv.weight.view(cfg.out_channels, -1), conv.bias).float()
