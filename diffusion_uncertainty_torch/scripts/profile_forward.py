"""Where the device time of one full-width forward goes, on the card.

    python -m diffusion_uncertainty_torch.scripts.profile_forward --model sd15 --batch 2 [--json PATH]
    python -m diffusion_uncertainty_torch.scripts.profile_forward --model cifar10 --batch 128 --winograd 1
    python -m diffusion_uncertainty_torch.scripts.profile_forward --model vae --batch 1
    python -m diffusion_uncertainty_torch.scripts.profile_forward --model uvit256 --batch 8
    python -m diffusion_uncertainty_torch.scripts.profile_forward --model adm128_classifier --batch 8
    python -m diffusion_uncertainty_torch.scripts.profile_forward --model adm128_grad --batch 40
    python -m diffusion_uncertainty_torch.scripts.profile_forward --model sd3 --batch 2   # also sd35, flux (--batch 1)
    python -m diffusion_uncertainty_torch.scripts.profile_forward --model sd3_grad --batch 10   # also flux_grad --batch 5
    python -m diffusion_uncertainty_torch.scripts.profile_forward --model sd21 --batch 2   # also 10, the folded M=5 batch
    python -m diffusion_uncertainty_torch.scripts.profile_forward --model t5xxl --batch 1   # also clip_g, clip_l
    PYTHONPATH=<another checkout> python <this file> --model vae --batch 1

No JAX counterpart (the JAX package's profiles are TPU traces). Builds the
model with seeded random bf16 weights (``generate_t2i_guided.init_random_``;
``sd15``: the SD 1.5 UNet at a 64x64 latent, t=500, pseudo-text context;
``adm128``: ImageNet-128 ADM, t=500; ``cifar10``: the DDPM CIFAR-10 UNet from
``factory.instantiate_model_scheduler(random_init=True)``, t=500, its
ResnetBlock2D convs on the Winograd kernel with ``--winograd 1`` and on
cuDNN with ``--winograd 0``; ``vae``: the SD KL-VAE decoder in float32, as
the text-to-image CLI runs it, one decode of a 64x64 latent to a 512x512
image; ``uvit256`` / ``uvit512``: U-ViT-huge/2 on 32x32x4 latents / U-ViT-huge/4
on 64x64x4 latents from ``factory.instantiate_model_scheduler(random_init=True)``,
bf16, t=500; ``adm128_classifier``: the ImageNet-128 noisy classifier from
``factory.load_classifier(random_init=True)`` in float32, t=500, one
"forward" being the classifier-guidance term, a forward and the backward to
its input; ``adm128_grad``: ImageNet-128 ADM from
``factory.instantiate_model_scheduler(random_init=True)``, bf16, t=500, one
"forward" being a forward and the backward of a scalar of its ε to the
float32 input, the unit of work of every gradient guidance, whose batch is
the folded ensemble, M·B = 40 for M=5 and 8 images; ``sd3`` / ``sd35`` /
``flux``: SD3-medium, SD3.5-large, Flux-dev as the text-to-image CLI builds
them (``build_flow_stack``, bf16) at a 64x64x16 latent with 16 pseudo-text
tokens (1040 joint tokens), t=500, Flux's guidance 7500; batch 2 is SD3's
CFG batch, 10 / 5 the folded M=5 ensemble; ``sd3_grad`` / ``flux_grad``: a
forward and the backward of a scalar of its velocity to the float32 input,
the unit of work of the flow-matching gradient branch; ``sd21``: the SD 2.1
UNet as the CLI builds it, bf16, at a 64x64 latent with the CLI's 5-token,
1024-wide pseudo context, t=500; ``t5xxl`` / ``clip_g`` / ``clip_l``: the
SD3 / Flux text towers (T5-XXL, CLIP-bigG, CLIP-L with projection) in
float32 with seeded random weights on 77 token ids), times ``ITERS`` forwards on the host
clock (ending in a synchronize), then traces ``TRACE`` more with
``torch.profiler`` and prints the device time
per forward by kernel family and the largest kernels, the device's busy
share of the wall time, the kernel launches per forward and the peak
device memory (``torch.cuda.max_memory_allocated``). Run by its path
with another checkout first on the path, it profiles that checkout's port.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from diffusion_uncertainty_torch.models import ADMUNet, ADMUNetConfig, AutoencoderKL, AutoencoderKLConfig
from diffusion_uncertainty_torch.pipelines import pseudo_text_embeddings
from diffusion_uncertainty_torch.scripts.generate_t2i_guided import Config, _build, build_sd_stack, init_random_

MODELS = ("sd15 | adm128 | cifar10 | vae | uvit256 | uvit512 | adm128_classifier | adm128_grad | sd3 | sd35 | flux | "
          "sd3_grad | flux_grad | sd21 | t5xxl | clip_g | clip_l")
ITERS = 10  # forwards timed on the host clock
TRACE = 3  # forwards traced by torch.profiler
# kernel-name substrings -> family, first match wins
FAMILIES = (
    ("attention (port kernel)", ("attention_kernel", "attention_tc_kernel", "attention_wide_kernel", "attention_combine_kernel")),
    ("GroupNorm pair (port kernels)", ("gn_stats_kernel", "gn_fold_kernel", "gn_apply_kernel")),
    ("GroupNorm one launch (port kernel)", ("gn_fused_kernel",)),
    ("interleave (port kernel)", ("interleave",)),
    ("avg-pool (port kernel)", ("avgpool", "avg_pool")),
    ("Winograd conv (port kernel)", ("winograd_kernel",)),
    ("convolutions (cuDNN)", ("conv", "implicit", "wgrad", "dgrad", "fprop", "cudnn", "winograd")),
    ("matmuls (cuBLAS)", ("gemm", "gemv", "nvjet", "sm90_xmma", "cutlass", "ampere", "splitk")),
    ("copies, casts, cat", ("copy", "cat", "to_copy", "transpose", "CatArray")),
    ("layer norm, softmax", ("layer_norm", "LayerNorm", "softmax")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce")),
)


def _family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def build(model: str, batch: int, device, winograd: bool = False):
    """(forward closure, parameter count) with seeded random bf16 weights."""
    gen = torch.Generator(device=device).manual_seed(0)
    if model == "cifar10":
        from diffusion_uncertainty_torch.factory import instantiate_model_scheduler

        net = instantiate_model_scheduler("cifar10", dropout=0.1, random_init=True, device=device, winograd=winograd).model
        x = torch.randn(batch, 32, 32, 3, generator=gen, device=device)
        return (lambda: net(x, 500)), sum(p.numel() for p in net.parameters())
    if model == "sd15":
        stack = build_sd_stack(Config(random_init=True), device=device)
        x = torch.randn(batch, 64, 64, 4, generator=gen, device=device)
        ctx = torch.from_numpy(pseudo_text_embeddings(["a photo of a cat"] * batch)).to(device)
        return (lambda: stack.unet(x, 500, ctx)), sum(p.numel() for p in stack.unet.parameters())
    if model == "sd21":
        stack = build_sd_stack(Config(model="sd21", random_init=True), device=device)
        x = torch.randn(batch, 64, 64, 4, generator=gen, device=device)
        ctx = torch.from_numpy(pseudo_text_embeddings(["a photo of a cat"] * batch, seq_len=5, dim=1024)).to(device)
        return (lambda: stack.unet(x, 500, ctx)), sum(p.numel() for p in stack.unet.parameters())
    if model in ("t5xxl", "clip_g", "clip_l"):
        from diffusion_uncertainty_torch.factory import init_normal_
        from diffusion_uncertainty_torch.models import CLIPTextConfig, CLIPTextEncoder, T5Config, T5Encoder
        from diffusion_uncertainty_torch.models.t5_text import init_t5_

        make = {"t5xxl": lambda: T5Encoder(T5Config.v1_1_xxl()),
                "clip_g": lambda: CLIPTextEncoder(CLIPTextConfig.vit_bigg_14()),
                "clip_l": lambda: CLIPTextEncoder(CLIPTextConfig.vit_l_14_projected())}[model]
        with torch.device("meta"):
            net = make()
        net = (init_t5_ if model == "t5xxl" else init_normal_)(net.to_empty(device=device), gen).eval()
        ids = torch.randint(1, 32000, (batch, 77), generator=gen, device=device)
        return (lambda: net(ids)), sum(p.numel() for p in net.parameters())
    if model == "adm128":
        cfg = ADMUNetConfig.imagenet128()
        with torch.device(device):
            net = init_random_(ADMUNet(cfg), seed=0)
        net = net.to(dtype=torch.bfloat16, memory_format=torch.channels_last).eval()
        x = torch.randn(batch, 128, 128, 3, generator=gen, device=device).to(torch.bfloat16)
        y = torch.randint(0, cfg.num_classes, (batch,), generator=gen, device=device)
        return (lambda: net(x, 500, y)), sum(p.numel() for p in net.parameters())
    if model == "vae":
        # as build_sd_stack makes it for the CLI
        vae = _build(lambda: AutoencoderKL(AutoencoderKLConfig.sd_kl_ema()), None, 1, device, torch.float32)
        z = torch.randn(batch, 64, 64, vae.cfg.embed_dim, generator=gen, device=device)
        return (lambda: vae.decode(z)), sum(p.numel() for p in vae.parameters())
    if model in ("uvit256", "uvit512"):
        from diffusion_uncertainty_torch.factory import instantiate_model_scheduler

        bundle = instantiate_model_scheduler("imagenet" + model[4:], random_init=True, device=device)
        x = torch.randn(batch, *bundle.sample_shape, generator=gen, device=device)
        y = torch.randint(0, bundle.num_classes, (batch,), generator=gen, device=device)
        return (lambda: bundle.model(x, 500, y)), sum(p.numel() for p in bundle.model.parameters())
    if model == "adm128_classifier":
        from diffusion_uncertainty_torch.classifier_guidance import with_classifier_guidance
        from diffusion_uncertainty_torch.diffusion import make_schedule
        from diffusion_uncertainty_torch.factory import load_classifier

        clf = load_classifier("imagenet128", random_init=True, device=device)
        x = torch.randn(batch, 128, 128, 3, generator=gen, device=device)
        y = torch.randint(0, clf.cfg.out_channels, (batch,), generator=gen, device=device)
        term = with_classifier_guidance(lambda *a: torch.zeros_like(x), clf, make_schedule("linear", 1000, device=device), 1.0)
        return (lambda: term(x, 500, y, None)), sum(p.numel() for p in clf.parameters())
    if model == "adm128_grad":
        from diffusion_uncertainty_torch.factory import instantiate_model_scheduler

        bundle = instantiate_model_scheduler("imagenet128", random_init=True, device=device)
        x = torch.randn(batch, 128, 128, 3, generator=gen, device=device)
        y = torch.randint(0, bundle.num_classes, (batch,), generator=gen, device=device)

        def grad_step():
            with torch.enable_grad():
                xr = x.detach().requires_grad_(True)
                eps = bundle.apply_fn(xr, 500, y, None)
                return torch.autograd.grad(eps.float().square().mean(), xr)[0]

        return grad_step, sum(p.numel() for p in bundle.model.parameters())
    if model.removesuffix("_grad") in ("sd3", "sd35", "flux"):
        from diffusion_uncertainty_torch.scripts.generate_t2i_guided import build_flow_stack

        stack = build_flow_stack(Config(model=model.removesuffix("_grad"), random_init=True), device=device)
        cfg, net = stack.mcfg, stack.model
        x = torch.randn(batch, 64, 64, 16, generator=gen, device=device)
        ctx = torch.randn(batch, 16, cfg.joint_attention_dim, generator=gen, device=device)
        pooled = torch.randn(batch, cfg.pooled_projection_dim, generator=gen, device=device)
        extra = (7500.0,) if stack.is_flux else ()

        def flow_grad_step():
            with torch.enable_grad():
                xr = x.detach().requires_grad_(True)
                return torch.autograd.grad(net(xr, 500.0, ctx, pooled, *extra).square().mean(), xr)[0]

        fwd = flow_grad_step if model.endswith("_grad") else (lambda: net(x, 500.0, ctx, pooled, *extra))
        return fwd, sum(p.numel() for p in net.parameters())
    raise SystemExit(f"unknown model {model!r}: {MODELS}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Profile one full-width forward on the card.")
    ap.add_argument("--model", default="sd15", help=MODELS)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--winograd", type=int, default=0, help="cifar10: 1 runs the ResnetBlock2D convs on the Winograd kernel")
    ap.add_argument("--json", help="write the breakdown as JSON to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA card")
    dev = torch.device("cuda")
    fwd, n_params = build(args.model, args.batch, dev, bool(args.winograd))
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for _ in range(2):
            fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / ITERS * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(TRACE):
                fwd()
            torch.cuda.synchronize()
    by_kernel: dict = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = by_kernel[evt.name]
            k[0] += evt.time_range.elapsed_us() / 1e3 / TRACE  # ms per forward
            k[1] += 1
    fams: dict = defaultdict(float)
    for name, (ms, _) in by_kernel.items():
        fams[_family(name)] += ms
    device_ms = sum(fams.values())
    launches = sum(n for _, n in by_kernel.values()) / TRACE
    out = {
        "model": args.model, "batch": args.batch, "winograd": bool(args.winograd), "params_m": n_params / 1e6, "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_ms, "device_ms": device_ms, "device_busy": device_ms / wall_ms,
        "launches_per_forward": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "families_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": {n: ms for n, (ms, _) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]},
    }
    print(f"{args.model} batch {args.batch} winograd {args.winograd}: {wall_ms:.2f} ms wall per forward, device busy {device_ms:.2f} ms "
          f"({100 * device_ms / wall_ms:.0f}%), {launches:.0f} kernel launches, peak memory {out['peak_mem_gb']:.2f} GiB")
    for fam, ms in out["families_ms"].items():
        print(f"  {fam:<26} {ms:8.3f} ms")
    for name, ms in out["top_kernels_ms"].items():
        print(f"    {ms:8.3f} ms  {name[:110]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
