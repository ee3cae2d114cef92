#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and hold its kernels to account.

    python3 chip_smoke.py [--details PATH]   # one card, about four minutes

Phases (a failure in any of them ends the run with a non-zero exit):

1. Build the hand-written Hopper kernels from ``diffusion_uncertainty_torch/
   kernels/csrc`` with nvcc (one process per source, in parallel); print the
   seconds, the card's name and power limit, and the registers and spills
   of every attention, Winograd, GroupNorm, avg-pool and interleave kernel
   instance (ptxas); a spill in any but attention fails the run.
2. Hold every kernel against its plain PyTorch version on the card, at every
   shape the full-width models give it, recorded from the forwards of phases
   3, 5, 7 and 9: ADM-128 at batch 2 and 8, the SD 1.5 UNet at batch 2 (the
   CFG batch), the SD VAE decoder at batch 1 (64x64 latent), the CIFAR-10 UNet
   at batch 128 (the CLI batch) and ADM-64 at batch 8 (phase 9's batch), in
   bfloat16 and float32. Tolerances:
   interleave bit-exact (the phase interleave, the nearest upsample and their
   pair, at every interleave shape); avg-pool within 1 bf16 ulp (one tensor
   and a pair); each prints its route (wide / narrow: 16-byte words or
   narrower). The two are timed in
   every form the ADM forwards make (a pair) and in their single forms at the
   ADM shapes, and in the SD and CIFAR-10 forwards' single form, by
   ``scripts/bench_resample.py`` ``measure``: besides ms, device_only_ms (the
   calls captured in a CUDA graph) and host_us (the wrapper's host time a
   call), and the bound counts both jobs of a pair; the sums take the form
   each main path runs. A gradient through the CUDA avg-pool pair op must
   equal the plain version's;
   GroupNorm (the routed ``group_norm`` call against ``group_norm_plain``, and
   the gn_stats + gn_apply pair at every shape too, against the op's
   reference) |kernel - plain| <= 2e-2 + 2^-7·|plain| in bf16 (the
   second term is one output rounding step where |y| > 2) and <= 1e-4 in f32,
   gn_stats's A, B within 1e-3 of its plain version's and bit-identical over
   two calls, each check printing its route (one launch or the pair, and the
   pair's word width); attention,
   scaled to the output (whose size falls as 1/sqrt(S_kv) for random inputs),
   max |kernel - plain| <= 2^-6·max|plain| (2 to 4 bf16 ulps of the largest
   output) and relative L2 <= 5e-3 in bf16, max |kernel - plain| <=
   1e-4·max|plain| in f32; Winograd conv (with and without the residual), in
   bf16 max |kernel - plain| <= 2 bf16 ulps of max|plain| and relative L2 <=
   5e-3, in f32 relative L2 <= 1e-5 (the same bf16 rounding points; only
   the float32 summation order differs). Each attention check prints the
   route its launch took (tensor core, CUDA core, wide, split-combine).
   bfloat16 shapes are timed, and float32 shapes where a main path runs in
   float32 (the VAE decoder's attention and GroupNorm, whose bf16 shapes are
   then not timed) (CUDA events, median after warm-up): the kernel, its
   plain version, the one PyTorch call that computes the same function
   (``F.scaled_dot_product_attention``, ``F.avg_pool2d``, a
   stack/permute/reshape copy for the interleave, ``F.conv2d`` on
   channels_last (+ the residual add) for the Winograd conv,
   ``F.group_norm`` (+``F.silu``) for ``group_norm``, ``torch.var_mean`` of
   the [N, HW, G, gs] view over (1, 3) for ``gn_stats``, none for
   ``gn_apply``'s FMA (+SiLU); the pair is also timed back to back beside
   ``F.group_norm`` (+``F.silu``)), and the bound: the larger of bytes
   moved (each input read once, each output written once) / 3.35 TB/s and
   operations / 989 TFLOP/s (dense bf16; the Winograd conv counts its 2 x 16
   x tiles x C x K multiply-adds; float32 attention at 495/3 TFLOP/s, the
   rate of the wide kernel's 3xTF32 products, with the backend SDPA took and
   whether TF32 was allowed). The "sums" lines add each model's shapes by
   dtype; a GroupNorm shape is timed and summed only on the route it takes
   on a main path (``group_norm`` where it takes one launch, ``gn_stats`` and
   ``gn_apply`` where it takes the pair). The Winograd kernel is also timed, for
   information, at the ADM-128 ResBlock conv shapes (batch 8) it can serve.
3. The full-width ImageNet-128 ADM forward (421M parameters, random bf16
   weights N(0, 0.02), batch 2) on the card against the same weights in
   float32 on the CPU at batch 1: relative L2 error of image 0 <= 2e-2. The
   forward makes exactly 4 avg-pool and 4 interleave launches, each serving
   a pair (one per down / up ResBlock), and is bit-identical to the same
   forward with one launch per tensor (the pairs undone).
4. ADM main path: 50 DDIM steps, uncertainty window [40, 50) with
   uncertainty_zigzag_centered (M=5, num_zigzag=3, members one after another),
   bf16, batch 8; sample finite, maps (10, 8, 128, 128, 3) with positive mean;
   4 paired avg-pool and 4 paired interleave launches per forward.
5. The full-width SD 1.5 UNet forward (859.5M parameters, random bf16 weights
   N(0, 0.02) with norm scales 1, t=500, pseudo-text context [2, 77, 768],
   inputs rounded to bf16, batch 2) against float32 on the CPU at batch 1,
   and the full-width VAE decoder (float32, as the CLI runs it; 32x32
   latent) the same way: UNet rel L2 <= 2e-2, and at most 1e-3 above the
   same bf16 UNet forward through the plain versions on the card (the share
   of the error that is bf16 rounding, not the kernels); VAE rel L2 <= 1e-4
   (float32 accuracy: TF32 products would break it). One backward
   through the UNet at batch 1 (grad of eps.square().mean() with respect to
   the input) on the card must be finite and match the same grad through the
   plain versions on the card within 5e-2 rel L2. Every bf16 UNet attention
   launch (forward and backward) must take the tensor-core route, and the
   VAE's float32 D=512 attention the wide route. Every UNet GroupNorm takes
   the one-launch route; the VAE's take it where 8 blocks hold the group and
   the pair elsewhere, every 256x256 and 512x512 map among them, 19 pairs a
   decode, every pair launch on 16-byte words (phase 3
   holds the ADM forward to the one-launch route the same way). The UNet
   forward makes 3 interleave launches (its up-samplers).
6. SD 1.5 main path, the CLI defaults: ``build_sd_stack`` +
   ``TextToImageUncertaintyPipeline``, 512x512, 20 DDIM steps, CFG 7.5,
   percentile guidance on steps [0, 20) at 0.95 with M=5, gradient branch (lr
   0.99), one prompt; then once more with the posterior branch. Images
   [1, 512, 512, 3] finite, uncertainty [1, 20, 64, 64, 4] with positive mean;
   no attention launch on the CUDA-core route, the VAE's on the wide route;
   GroupNorm on the pair exactly as often as one VAE decode takes it.
7. The full-width CIFAR-10 UNet (``UNet2DConfig.ddpm_cifar10(dropout=0.1)``,
   35.7M parameters, seeded random bf16 weights from
   ``instantiate_model_scheduler(random_init=True)``, t=500, batch 128) with
   ``winograd=True`` against the same weights in float32 on the CPU with the
   direct conv at batch 1 (rel L2 <= 2e-2), and against the same card forward
   with ``winograd=False`` (printed); exactly 44 Winograd launches per
   forward, and 51 one-launch GroupNorms (no pair), 6 attention, 3 interleave.
8. CIFAR-10 main path through the dataset CLI's functions:
   ``instantiate_model_scheduler("cifar10", dropout=0.1, random_init=True)``
   and ``generate_uncertainty_dataset`` with ``mc_dropout``, M=5, 50 DDIM
   steps, window [40, 50), bf16, batch 128, on the port's starting points,
   with ``DU_TPU_WINOGRAD=1`` and then unset: images/s of each, uncertainty
   [128, 10, 32, 32, 3] finite with positive mean, Winograd launches 44 per
   forward (60 forwards: 50 trajectory steps and one folded M=5 ensemble
   forward per window step) with the kernel on and none with it off.
9. ADM-64 and the metrics (BASELINE config 2). (a) The full-width ADM-64
   forward (``instantiate_model_scheduler("imagenet64", random_init=True)``,
   295.9M parameters, bf16, batch 8, t=500) against the same weights in
   float32 on the CPU at batch 1: rel L2 of image 0's 6 channels <= 2e-2;
   3 paired avg-pool and 3 paired interleave launches, attention on the
   tensor-core route (D=64), the GroupNorms that took the pair printed.
   (b) ``compute_ause.main``: imagenet64, uncertainty_zigzag_centered, M=5,
   num_zigzag=3, a 20-step chain denoised over its second half, batch 8, 16
   synthetic images, random init: AUSE and AURG finite, summed map mean > 0,
   images/s. (c) ``compute_nll.main``: imagenet64, learned_range, batch 8, 8
   images (1000 forwards of the 6-channel model): bpd finite and > 0, s a
   batch. (d) A 32-image dataset-CLI run of ADM-64 (uncertainty_centered,
   M=5, 10 steps, window [5, 10)), then ``compute_fid`` stats and drop and
   ``compute_precision_recall`` real and generated on it, the extractors
   built from seeded random state dicts of the real architectures
   (``metrics.features.random_state_dict``): each extractor's card features
   (Inception at 299², VGG16 at 224², batch 16, float32) against the same
   weights in float32 on the CPU at batch 2, rel L2 <= 1e-4 (TF32 off), and
   its features/s; FIDs, precision and recall finite, the last two in [0, 1];
   precision and recall of two halves of the real features above 0 on the
   card and within one member of the CPU's.

Every forward of phases 3, 5, 7 and 9a must launch each kernel of its model;
each main path (phase 4, each run of phase 6, each run of phase 8, and the
AUSE, NLL and dataset-CLI runs of phase 9) sets the launch counters to 0 just
before and reads them just after, and fails if a kernel of its path never
launched. Each phase prints its seconds. The last two lines are the kernels
JSON (``launches``: the sum over the main-path runs; avg_pool_2x2 and
interleave_2x also carry
``device_only_ms``, ``host_us``, ``forms``, the form their sums take, and
``single_form``, the sums of one tensor a launch at every shape) and the
device JSON. ``--details`` writes every
check, time and the ptxas report as JSON to PATH.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
ADM_BATCH = 8  # images of the ADM main-path run (phase 4)
ADM64_BATCH = 8  # images a batch of the ADM-64 runs (phase 9)
CIFAR_BATCH = 128  # images of the CIFAR-10 main-path run (phase 8), the CLI's batch
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
# float32 attention on a main path (the VAE, D=512) takes the wide kernel,
# whose products are 3xTF32: three TF32 tensor-core products each
F32_ATTENTION_FLOPS, F32_ATTENTION_ARITH = 495e12 / 3, "3xTF32 (495/3 TFLOP/s)"
# the batch each model's shapes are checked at; the first is the main path's
CHECK_BATCHES = {"adm": (8, 2), "sd": (2,), "vae": (1,), "cifar": (CIFAR_BATCH,), "adm64": (ADM64_BATCH,)}
PAIRED = ("adm", "adm64")  # models whose forward resamples two tensors a launch
# the single form of the two resampling kernels, one tensor a launch
RESAMPLE_FORMS = {"avg_pool_2x2": "single", "interleave_2x": "phase"}
F32_MODELS = ("vae",)  # models whose main path runs in float32 (the SD VAE decoder)
SRC = "diffusion_uncertainty_torch/kernels/csrc/"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "group_norm": (SRC + "groupnorm.cu", "diffusion_uncertainty_tpu/ops/groupnorm.py:65"),
    "gn_stats": (SRC + "groupnorm.cu", "diffusion_uncertainty_tpu/ops/groupnorm.py:454"),
    "gn_apply": (SRC + "groupnorm.cu", "diffusion_uncertainty_tpu/ops/groupnorm.py:578"),
    "attention": (SRC + "attention.cu", "diffusion_uncertainty_tpu/ops/flash_attention.py:87"),
    "attention_long": (SRC + "attention.cu", "diffusion_uncertainty_tpu/ops/flash_attention.py:134"),
    "avg_pool_2x2": (SRC + "avgpool.cu", "diffusion_uncertainty_tpu/ops/avgpool.py:30"),
    "interleave_2x": (SRC + "interleave.cu", "diffusion_uncertainty_tpu/ops/fused_upsample.py:110"),
    "winograd": (SRC + "winograd.cu", "diffusion_uncertainty_tpu/ops/winograd_conv.py:154"),
}
ADM_PATH = ("group_norm", "attention", "avg_pool_2x2", "interleave_2x")
# avg-pool and interleave launches of one ADM-128 forward: one pair per down
# and per up ResBlock (ADM-64: 3 of each)
ADM_RESAMPLE = 4
ADM64_RESAMPLE = 3
# the VAE decode's GroupNorms over its large maps take the pair: 6 at
# 128x128x512, 1 at 256x256x512, 5 at 256x256x256, 1 at 512x512x256, 6 at
# 512x512x128 (a 64x64 latent)
VAE_PAIRS = 19
# the SD path: the UNet's kernels and the VAE decode's
SD_PATH = ("group_norm", "gn_stats", "gn_apply", "attention", "attention_long", "interleave_2x")
CIFAR_PATH = ("group_norm", "attention", "interleave_2x", "winograd")
# launches of one CIFAR-10 UNet forward: 22 ResnetBlock2Ds x 2 convs; 2 GNs per
# block, 6 attention norms and the output norm, each one launch; 6
# attentions; 3 upsamplers
CIFAR_FORWARD = {"winograd": 44, "group_norm": 51, "gn_stats": 0, "gn_apply": 0, "attention": 6, "interleave_2x": 3}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "nvidia-smi: not available"


def fmt_ms(t) -> str:
    return "none" if t is None else f"{t:.4f}"


def bound_ms(n_bytes: float, flops: float, rate: float = BF16_FLOPS) -> tuple[float, float]:
    """(bytes time, operations time) in ms on the published H100 peaks; rate:
    the operations per second of the arithmetic the kernel uses."""
    return n_bytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3


def sdpa_backend(q, k, v) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for these inputs."""
    import torch

    try:
        return torch.nn.attention.SDPBackend(torch._fused_sdp_choice(q, k, v)).name
    except (AttributeError, RuntimeError, ValueError) as e:
        return f"unknown ({type(e).__name__})"


def bf16_ulp(t):
    import torch

    mag = t.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def rel_l2(got, ref) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return float((got - ref).norm() / ref.norm())


class Recorder:
    """Stands in for every kernel wrapper during a recording forward: notes
    each call's shape signature (tensors are not kept) and forwards it."""

    def __init__(self, mods):
        self.mods = mods  # {wrapper name: kernel module}
        self.sigs: list = []

    def _wrap(self, name, fn):
        def call(*args):
            self.sigs.append((name, signature(name, args)))
            return fn(*args)

        return call

    def __enter__(self):
        self.saved = {name: getattr(mod, name) for name, mod in self.mods.items()}
        for name, mod in self.mods.items():
            setattr(mod, name, self._wrap(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, name, self.saved[name])


class PlainKernels:
    """Every kernel wrapper replaced by its plain PyTorch version, so a run
    on the card goes through no kernel (the reference of the backward check)."""

    def __init__(self, mods, plains):
        self.mods, self.plains = mods, plains

    def __enter__(self):
        self.saved = {name: getattr(mod, name) for name, mod in self.mods.items()}
        for name, mod in self.mods.items():
            setattr(mod, name, self.plains[name])

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, name, self.saved[name])


def signature(name, args):
    """What phase 2 needs to rebuild a call's inputs (per image)."""
    if name == "group_norm":
        x, groups = args[0], args[3]
        eps = args[4] if len(args) > 4 else 1e-5
        scale = args[5] if len(args) > 5 else None
        silu = bool(args[7]) if len(args) > 7 else True
        return (x.shape[1], x.shape[2], x.shape[3], groups, float(eps), scale is not None, silu)
    if name == "attention":
        q, k = args[0], args[1]
        s, h, d = q.shape[1:]
        layout = "separate"
        if q.stride(1) == 3 * h * d:  # a view into one qkv projection
            layout = "legacy" if q.stride(2) == 3 * d else "qkv"
        kv_len = args[3] if len(args) > 3 else None
        return (s, k.shape[1], h, d, layout, kv_len)
    if name == "winograd_conv":
        res = args[3] if len(args) > 3 else None
        return tuple(args[0].shape[1:]) + (args[2].shape[0], res is not None)
    if name == "interleave_2x_pair":
        return tuple(args[1].shape[1:])
    return tuple(args[0].shape[1:])  # avg-pool (single or pair), interleave, nearest


# recorded wrapper -> kernel family of phase 2
FAMILY = {"avg_pool_2x2_pair": "avg_pool_2x2", "nearest_2x": "interleave_2x", "interleave_2x_pair": "interleave_2x"}


def shape_sets(calls):
    """Recorded calls -> {kernel family: sorted distinct signatures}."""
    sets = {"group_norm": set(), "attention": set(), "avg_pool_2x2": set(), "interleave_2x": set(),
            "winograd_conv": set()}
    for name, sig in calls:
        sets[FAMILY.get(name, name)].add(sig)
    return {k: sorted(v, key=str) for k, v in sets.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one H100 and check its kernels.")
    ap.add_argument("--details", help="write every check and time as JSON to this path")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's kernels run only on a CUDA card")
    from diffusion_uncertainty_torch import kernels
    from diffusion_uncertainty_torch.diffusion import SamplerConfig, make_schedule, sample_ddim
    from diffusion_uncertainty_torch.kernels import attention as katt
    from diffusion_uncertainty_torch.kernels import avgpool as kpool
    from diffusion_uncertainty_torch.kernels import groupnorm as kgn
    from diffusion_uncertainty_torch.kernels import interleave as kilv
    from diffusion_uncertainty_torch.kernels import winograd as kwino
    from diffusion_uncertainty_torch.factory import instantiate_model_scheduler
    from diffusion_uncertainty_torch.models import ADMUNet, ADMUNetConfig, AutoencoderKL, SDUNet, UNet2D
    from diffusion_uncertainty_torch.models.adm_unet import ResBlock
    from diffusion_uncertainty_torch.models.layers import split_qkv
    from diffusion_uncertainty_torch.sampling import generate_uncertainty_dataset
    from diffusion_uncertainty_torch.scripts import generate_dataset_score_uncertainty as dataset_cli
    from diffusion_uncertainty_torch.scripts import compute_ause, compute_fid, compute_nll, compute_precision_recall
    from diffusion_uncertainty_torch.scripts import generate_starting_points
    from diffusion_uncertainty_torch.metrics.features import InceptionV3Features, VGG16Features, random_state_dict
    from diffusion_uncertainty_torch.metrics.precision_recall import precision_recall
    from diffusion_uncertainty_torch.utils import paths
    from diffusion_uncertainty_torch.utils.experiments import load_run_arrays
    from diffusion_uncertainty_torch.scripts.bench_resample import BOUND_INPUTS, measure
    from diffusion_uncertainty_torch.models import adm_unet
    from diffusion_uncertainty_torch.ops import avg_pool_2x2, avg_pool_2x2_pair, interleave_phases_2x, nearest_upsample_2x
    from diffusion_uncertainty_torch.ops.groupnorm import _reference_impl
    from diffusion_uncertainty_torch.pipelines import T2IPipelineConfig, TextToImageUncertaintyPipeline, pseudo_text_embeddings
    from diffusion_uncertainty_torch.scripts.generate_t2i_guided import Config as T2IConfig
    from diffusion_uncertainty_torch.scripts.generate_t2i_guided import build_sd_stack
    from diffusion_uncertainty_torch.uncertainty import EstimatorConfig, make_estimator
    from diffusion_uncertainty_torch.utils import TorchNoise
    from diffusion_uncertainty_torch.utils.device import device_ms, graph_ms, host_us

    wrapper_mods = {"group_norm": kgn, "attention": katt, "avg_pool_2x2": kpool, "avg_pool_2x2_pair": kpool,
                    "interleave_2x": kilv, "nearest_2x": kilv, "interleave_2x_pair": kilv, "winograd_conv": kwino}
    plains = {
        "group_norm": kgn.group_norm_plain, "attention": katt.attention_plain,
        "avg_pool_2x2": kpool.avg_pool_2x2_plain, "avg_pool_2x2_pair": kpool.avg_pool_2x2_pair_plain,
        "interleave_2x": kilv.interleave_2x_plain, "nearest_2x": kilv.nearest_2x_plain,
        "interleave_2x_pair": kilv.interleave_2x_pair_plain, "winograd_conv": kwino.winograd_conv_plain,
    }
    clocks = (device_ms, graph_ms, host_us)
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)
    details: dict = {"card": card, "phase_s": {}}
    clock = [time.perf_counter()]

    def lap(phase):
        """Print and keep the seconds since the previous lap."""
        now = time.perf_counter()
        details["phase_s"][str(phase)] = now - clock[0]
        print(f"[{phase}] phase time {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    print(f"[1] build: {build_s:.1f} s ({', '.join(kernels.SOURCES)}) on {card}", flush=True)
    details["build_s"] = build_s
    details["ptxas"] = dict(kernels._build.build_logs)
    for src in ("attention", "winograd", "groupnorm", "avgpool", "interleave"):
        for inst in kernels._build.ptxas_report(src):
            print(f"[1] ptxas {src} {inst}", flush=True)
    spills = [f"{src}: {inst}" for src in ("winograd", "groupnorm", "avgpool", "interleave")
              for inst in kernels._build.ptxas_report(src)
              if not ("0 bytes spill stores" in inst and "0 bytes spill loads" in inst)]
    if spills:
        fail(f"ptxas spills registers in a Winograd, GroupNorm, avg-pool or interleave kernel: {spills}")
    lap(1)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def check_counts(counts, path, what):
        for name in path:
            if counts[name] <= 0:
                fail(f"{what}: kernel {name} was never launched")

    def check_tc_routes(routes, what):
        """bf16 UNet attention (SD's, ADM-64's) is held to the tensor-core route."""
        if routes["cuda_core"] or routes["tensor_core"] <= 0:
            fail(f"{what}: an attention launch left the tensor-core route: {routes}")

    def check_gn_one_launch(gn_routes, what):
        """Every GroupNorm of a UNet forward takes the one-launch route."""
        if gn_routes["pair"] or gn_routes["one_launch"] <= 0:
            fail(f"{what}: a GroupNorm left the one-launch route: {gn_routes}")

    # ---- recording forwards (the card runs of phases 3 and 5) -----------
    cfg = ADMUNetConfig.imagenet128()
    with torch.device(dev):
        model = ADMUNet(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    model = model.to(dtype=torch.bfloat16, memory_format=torch.channels_last).eval()
    n_params = sum(p.numel() for p in model.parameters())
    x2 = torch.randn(2, 128, 128, 3, generator=gen, device=dev).to(torch.bfloat16)
    y2 = torch.randint(0, cfg.num_classes, (2,), generator=gen, device=dev)
    kernels.reset_launch_counts()
    with torch.no_grad(), Recorder(wrapper_mods) as rec_adm:
        t0 = time.perf_counter()
        out_adm = model(x2, 500, y2)
        torch.cuda.synchronize()
        adm_fwd_s = time.perf_counter() - t0
    adm_fwd_counts, adm_gn_routes = kernels.launch_counts(), kernels.gn_route_counts()
    adm_resample = kernels.resample_counts()

    stack = build_sd_stack(T2IConfig(random_init=True), device=dev)
    unet, vae = stack.unet, stack.vae
    n_sd = sum(p.numel() for p in unet.parameters())
    # bf16-representable inputs: the card's UNet casts them to bf16, and the
    # CPU reference of phase 5 then sees the same values
    xs = torch.randn(2, 64, 64, 4, generator=gen, device=dev).to(torch.bfloat16).float()
    ctx = torch.from_numpy(pseudo_text_embeddings(["a photo of a cat", ""])).to(dev).to(torch.bfloat16).float()
    kernels.reset_launch_counts()
    with torch.no_grad(), Recorder(wrapper_mods) as rec_sd:
        t0 = time.perf_counter()
        out_sd = unet(xs, 500, ctx)
        torch.cuda.synchronize()
        sd_fwd_s = time.perf_counter() - t0
    sd_fwd_counts, sd_fwd_routes, sd_gn_routes = kernels.launch_counts(), kernels.route_counts(), kernels.gn_route_counts()
    z64 = torch.randn(1, 64, 64, 4, generator=gen, device=dev)
    kernels.reset_launch_counts()
    with torch.no_grad(), Recorder(wrapper_mods) as rec_vae:
        img64 = vae.decode(z64)
        torch.cuda.synchronize()
    vae_counts, vae_routes, vae_gn_routes = kernels.launch_counts(), kernels.route_counts(), kernels.gn_route_counts()
    vae_pair_routes = kernels.gn_pair_route_counts()

    # the CIFAR-10 UNet with its Winograd route on, and the same seeded weights
    # with it off
    cifar = instantiate_model_scheduler("cifar10", dropout=0.1, random_init=True, device=dev, winograd=True)
    cifar_direct = instantiate_model_scheduler("cifar10", dropout=0.1, random_init=True, device=dev)
    n_cifar = sum(p.numel() for p in cifar.model.parameters())
    xc = torch.randn(CIFAR_BATCH, 32, 32, 3, generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        cifar.model(xc[:2], 500)  # the weight transforms, outside the timed call
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad(), Recorder(wrapper_mods) as rec_cifar:
        t0 = time.perf_counter()
        out_cifar = cifar.model(xc, 500)
        torch.cuda.synchronize()
        cifar_fwd_s = time.perf_counter() - t0
    cifar_counts, cifar_gn_routes = kernels.launch_counts(), kernels.gn_route_counts()

    # ADM-64 as the factory builds it for the metric CLIs (seeded random bf16
    # weights), at the batch of phase 9's runs
    adm64 = instantiate_model_scheduler("imagenet64", random_init=True, device=dev)
    n_adm64 = sum(p.numel() for p in adm64.model.parameters())
    x64 = torch.randn(ADM64_BATCH, 64, 64, 3, generator=gen, device=dev).to(torch.bfloat16)
    y64 = torch.randint(0, adm64.num_classes, (ADM64_BATCH,), generator=gen, device=dev)
    with torch.no_grad():
        adm64.model(x64, 500, y64)  # cuDNN plans, outside the timed call
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad(), Recorder(wrapper_mods) as rec_adm64:
        t0 = time.perf_counter()
        out_adm64 = adm64.model(x64, 500, y64)
        torch.cuda.synchronize()
        adm64_fwd_s = time.perf_counter() - t0
    adm64_counts, adm64_routes = kernels.launch_counts(), kernels.route_counts()
    adm64_gn_routes, adm64_resample = kernels.gn_route_counts(), kernels.resample_counts()
    lap("recording forwards")

    # ---- phase 2: every kernel against its plain version -----------------
    sets = {"adm": shape_sets(rec_adm.sigs), "sd": shape_sets(rec_sd.sigs), "vae": shape_sets(rec_vae.sigs),
            "cifar": shape_sets(rec_cifar.sigs), "adm64": shape_sets(rec_adm64.sigs)}
    for src, ss in sets.items():
        print(f"[2] {src} shapes: " + ", ".join(f"{k} {len(v)}" for k, v in ss.items()), flush=True)
    names = tuple(KERNELS)
    err = {k: 0.0 for k in names}
    # (kernel or "gn pair", model, dtype) -> sums over its distinct shapes at the model's main-path batch
    sums: dict = {}
    rows = []

    def add(what, src, dtype, **vals):
        t = sums.setdefault((what, src, dtype), {"shapes": 0, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                                                 "bound_ms": 0.0})
        t["shapes"] += 1
        for key, val in vals.items():
            t[key] = t.get(key, 0.0) + val

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def note(kernel, e, src, batch, dtype, shape, tol, times=None, n_bytes=0.0, flops=0.0, rate=BF16_FLOPS, summed=True,
             **extra):
        """Record a check; its times go into the sums at the main-path batch
        (and, where a kernel has several forms, for the form the path runs)."""
        err[kernel] = max(err[kernel], e)
        dt = str(dtype).split(".")[-1]
        row = {"kernel": kernel, "model": src, "batch": batch, "dtype": dt, "shape": shape,
               "max_abs_err": e, "tol": tol, **extra}
        if times is not None:
            b_ms, o_ms = bound_ms(n_bytes, flops, rate)
            row.update(times, bytes_ms=b_ms, ops_ms=o_ms, bound_ms=max(b_ms, o_ms))
            if batch == CHECK_BATCHES[src][0] and summed:
                add(kernel, src, dt, **times, bytes_ms=b_ms, ops_ms=o_ms, bound_ms=max(b_ms, o_ms))
        rows.append(row)

    def gn_checks(src, batch, dtype, h, w, c, groups, eps, ss, silu):
        # timed in the type the model's main path runs in (the VAE decodes in
        # float32), and only on the route the shape takes there: group_norm
        # where it takes one launch, gn_stats and gn_apply where it takes the pair
        timed = dtype == (torch.float32 if src in F32_MODELS else torch.bfloat16)
        x = rnd(batch, h, w, c, dtype=dtype)
        gamma, beta = rnd(c, dtype=dtype, scale=0.1, shift=1.0), rnd(c, dtype=dtype, scale=0.1)
        sc = rnd(batch, c, dtype=dtype, scale=0.1) if ss else None
        sh = rnd(batch, c, dtype=dtype, scale=0.1) if ss else None
        args = (x, gamma, beta, groups, eps, sc, sh, silu)
        kernels.reset_launch_counts()
        y = kgn.group_norm(*args)
        route = "+".join(r for r, n in kernels.gn_route_counts().items() if n)
        kernels.reset_launch_counts()
        a, b = kgn.gn_stats(x, gamma, beta, groups, eps, sc, sh)
        a2, b2 = kgn.gn_stats(x, gamma, beta, groups, eps, sc, sh)
        ap_, bp_ = kgn.gn_stats_plain(x, gamma, beta, groups, eps, sc, sh)
        y_pair = kgn.gn_apply(x, a, b, silu)
        pair_route = "+".join(r for r, n in kernels.gn_pair_route_counts().items() if n)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4

        def within(got, want):  # bf16: one output rounding step (2^-7 relative) on top of tol
            return bool(((got.float() - want).abs() <= tol + (2.0**-7 * want.abs() if dtype == torch.bfloat16 else 0.0)).all())

        plain = kgn.group_norm_plain(*args).float()
        ref = _reference_impl(*args).float()
        e_one, e_pair = float((y.float() - plain).abs().max()), float((y_pair.float() - ref).abs().max())
        where = (src, batch, h, w, c, groups, eps, ss, silu, dtype)
        if not within(y, plain):
            fail(f"group_norm ({route}) disagrees with its plain version at {where}: max err {e_one}")
        if not within(y_pair, ref):
            fail(f"GroupNorm pair ({pair_route}) disagrees at {where}: max err {e_pair}")
        e_stats = max(float((a - ap_).abs().max()), float((b - bp_).abs().max()))
        if e_stats > 1e-3:
            fail(f"gn_stats disagrees at {(src, batch, h, w, c, groups, eps)}: {e_stats}")
        if not (torch.equal(a, a2) and torch.equal(b, b2)):
            fail(f"gn_stats: two calls on one input differ at {(src, batch, h, w, c, groups, eps, dtype)}")
        shape = [batch, h, w, c, groups, eps, ss, silu]
        t_one = t_stats = t_apply = None
        nx = x.numel() * x.element_size()
        n_coef = 2 * batch * c * 4  # A and B, float32
        n_par = 2 * c * x.element_size() + (2 * batch * c * x.element_size() if ss else 0)
        pair = {}
        if timed:
            xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view for the library call
            lib = (lambda: F.silu(F.group_norm(xc, groups, gamma, beta, eps))) if silu else (lambda: F.group_norm(xc, groups, gamma, beta, eps))
            lib_ms = device_ms(lib)  # the whole GroupNorm
            if route == "one_launch":
                t_one = {"ms": device_ms(lambda: kgn.group_norm(*args)),
                         "plain_ms": device_ms(lambda: kgn.group_norm_plain(*args)), "library_ms": lib_ms}
            else:
                xv = x.view(batch, h * w, groups, c // groups)  # the statistics' one PyTorch call
                t_stats = {"ms": device_ms(lambda: kgn.gn_stats(x, gamma, beta, groups, eps, sc, sh)),
                           "plain_ms": device_ms(lambda: kgn.gn_stats_plain(x, gamma, beta, groups, eps, sc, sh)),
                           "library_ms": device_ms(lambda: torch.var_mean(xv, dim=(1, 3), correction=0))}
                t_apply = {"ms": device_ms(lambda: kgn.gn_apply(x, a, b, silu)),
                           "plain_ms": device_ms(lambda: kgn.gn_apply_plain(x, a, b, silu))}  # no one call: FMA (+SiLU)
                pair = {"pair_ms": device_ms(lambda: kgn.gn_apply(x, *kgn.gn_stats(x, gamma, beta, groups, eps, sc, sh), silu)),
                        "pair_plain_ms": device_ms(lambda: kgn.gn_apply_plain(x, *kgn.gn_stats_plain(x, gamma, beta, groups, eps, sc, sh), silu)),
                        "pair_library_ms": lib_ms, "pair_bound_ms": bound_ms(2 * nx + n_par, 0.0)[0]}
                if batch == CHECK_BATCHES[src][0]:
                    add("gn pair", src, str(dtype).split(".")[-1], ms=pair["pair_ms"], plain_ms=pair["pair_plain_ms"],
                        library_ms=lib_ms, bytes_ms=pair["pair_bound_ms"], bound_ms=pair["pair_bound_ms"])
        note("group_norm", e_one, src, batch, dtype, shape, tol, t_one, 2 * nx + n_par, 0.0, route=route)
        note("gn_stats", e_stats, src, batch, dtype, shape, 1e-3, t_stats, nx + n_par + n_coef, 0.0, route=route,
             pair_route=pair_route)
        note("gn_apply", e_pair, src, batch, dtype, shape, tol, t_apply, 2 * nx + n_coef, 0.0, route=route,
             pair_route=pair_route, **pair)

    def attention_checks(src, batch, dtype, s, s_kv, heads, d, layout, kv_len):
        if layout == "separate":
            q, k, v = rnd(batch, s, heads, d, dtype=dtype), rnd(batch, s_kv, heads, d, dtype=dtype), rnd(batch, s_kv, heads, d, dtype=dtype)
        else:
            q, k, v = split_qkv(rnd(batch, s, 3 * heads * d, dtype=dtype), heads, layout == "legacy")
        kernels.reset_launch_counts()
        o = katt.attention(q, k, v, kv_len).float()
        route = "+".join(r for r, n in kernels.route_counts().items() if n)
        ref = katt.attention_plain(q, k, v, kv_len).float()
        e = float((o - ref).abs().max())
        ref_max = float(ref.abs().max())
        rel = rel_l2(o, ref)
        bf16 = dtype == torch.bfloat16
        tol = (2.0**-6 if bf16 else 1e-4) * ref_max
        name = "attention_long" if s_kv > katt.LONG_KEYS else "attention"
        if not (e <= tol and (rel <= 5e-3 or not bf16)):
            fail(f"{name} disagrees at {(src, batch, s, s_kv, heads, d, dtype)}: max err {e} (limit {tol}), rel L2 {rel}")
        times, extra, rate = None, {}, BF16_FLOPS
        # bf16 everywhere; float32 where a main path runs attention in float32
        # (the VAE decodes in float32)
        if bf16 or src in F32_MODELS:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            times = {"ms": device_ms(lambda: katt.attention(q, k, v, kv_len)),
                     "plain_ms": device_ms(lambda: katt.attention_plain(q, k, v, kv_len)),
                     "library_ms": device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))}
            if not bf16:
                rate = F32_ATTENTION_FLOPS
                extra = {"sdpa_backend": sdpa_backend(qt, kt, vt), "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                         "bound_rate": F32_ATTENTION_ARITH}
        n_keys = s_kv if kv_len is None else kv_len
        es = q.element_size()
        n_bytes = (2 * batch * s * heads * d + 2 * batch * n_keys * heads * d) * es
        note(name, e, src, batch, dtype, [batch, s, s_kv, heads, d, layout], tol, times, n_bytes,
             4.0 * batch * heads * s * n_keys * d, rate, plain_max=ref_max, rel_l2=rel, route=route, **extra)

    def resample_times(kind, form, shape):
        """(times, bytes moved, extras) of one form at one shape (bench_resample)."""
        r = measure(kpool, kilv, kind, form, shape, gen, clocks)
        times = {k: r[k] for k in ("ms", "plain_ms", "library_ms", "device_only_ms", "host_us")}
        return times, BOUND_INPUTS[(kind, form)] * math.prod(shape) * 2, {"route": r["route"], "form": form}

    def pool_checks(src, batch, h, w, c):
        x, y = rnd(batch, h, w, c), rnd(batch, h, w, c)
        kernels.reset_launch_counts()
        got = (kpool.avg_pool_2x2(x), *kpool.avg_pool_2x2_pair(x, y))
        route = "+".join(r for r, n in kernels.resample_counts()["avg_pool_2x2"].items() if n)
        e = 0.0
        for g, ref in zip(got, (kpool.avg_pool_2x2_plain(x), *kpool.avg_pool_2x2_pair_plain(x, y))):
            diff = (g.float() - ref.float()).abs()
            if not bool((diff <= bf16_ulp(ref)).all()):
                fail(f"avg_pool_2x2 ({route}) disagrees by more than 1 bf16 ulp at {(src, batch, h, w, c)}")
            e = max(e, float(diff.max()))
        main = "pair" if src in PAIRED else "single"
        for form in ("single", "pair") if src in PAIRED else ("single",):
            times, nbytes, extra = resample_times("pool", form, (batch, h, w, c))
            note("avg_pool_2x2", e, src, batch, torch.bfloat16, [batch, h, w, c, form], "1 ulp", times, nbytes, 0.0,
                 summed=form == main, checked=route, **extra)

    def interleave_checks(src, batch, h, w, c):
        ys, x = [rnd(batch, h, w, c) for _ in range(4)], rnd(batch, h, w, c)
        kernels.reset_launch_counts()
        phase, near, pair = kilv.interleave_2x(*ys), kilv.nearest_2x(x), kilv.interleave_2x_pair(ys, x)
        route = "+".join(r for r, n in kernels.resample_counts()["interleave_2x"].items() if n)
        want = (kilv.interleave_2x_plain(*ys), kilv.nearest_2x_plain(x))
        if not (torch.equal(phase, want[0]) and torch.equal(near, want[1]) and torch.equal(pair[0], want[0])
                and torch.equal(pair[1], want[1])):
            fail(f"interleave_2x ({route}) is not bit-exact at {(src, batch, h, w, c)}")
        main = "pair" if src in PAIRED else "phase"
        for form in ("phase", "nearest", "pair") if src in PAIRED else ("phase",):
            times, nbytes, extra = resample_times("interleave", form, (batch, h, w, c))
            note("interleave_2x", 0.0, src, batch, torch.bfloat16, [batch, h, w, c, form], "exact", times, nbytes, 0.0,
                 summed=form == main, checked=route, **extra)

    def winograd_checks(src, batch, dtype, h, w, c, k, has_res, timed=True, compare=True):
        x = rnd(batch, h, w, c, dtype=dtype)
        wt = rnd(k, c, 3, 3, dtype=dtype, scale=0.05)
        b = rnd(k, dtype=dtype)
        res = rnd(batch, h, w, k, dtype=dtype) if has_res else None
        u, b32 = kwino.weight_transform(wt), b.float()
        got = kwino.winograd_conv(x, u, b32, res)
        shape = [batch, h, w, c, k, has_res]
        extra = {}
        e, tol = 0.0, None
        if compare:
            ref = kwino.winograd_conv_plain(x, u, b32, res).float()
            e = float((got.float() - ref).abs().max())
            ref_max = float(ref.abs().max())
            rel = rel_l2(got, ref)
            bf16 = dtype == torch.bfloat16
            tol = 2 * float(bf16_ulp(torch.tensor(ref_max))) if bf16 else None  # f32: rel L2 only
            if not ((tol is None or e <= tol) and rel <= (5e-3 if bf16 else 1e-5)):
                fail(f"winograd disagrees at {(src, *shape, dtype)}: max err {e} (limit {tol}), rel L2 {rel}")
            extra = {"plain_max": ref_max, "rel_l2": rel}
        times = None
        if timed:
            xcl, wcl = x.permute(0, 3, 1, 2), wt.contiguous(memory_format=torch.channels_last)
            rcl = res.permute(0, 3, 1, 2) if has_res else None

            def library():
                y = F.conv2d(xcl, wcl, b, padding=1)
                return y if rcl is None else y.add_(rcl)

            times = {"ms": device_ms(lambda: kwino.winograd_conv(x, u, b32, res)),
                     "plain_ms": device_ms(lambda: kwino.winograd_conv_plain(x, u, b32, res)) if compare else float("nan"),
                     "library_ms": device_ms(library)}
        es = x.element_size()
        n_bytes = (x.numel() + batch * h * w * k * (2 if has_res else 1)) * es + u.numel() * 2 + k * 4
        flops = 2.0 * 16 * (batch * (h // 2) * (w // 2)) * c * k
        if not compare:  # information only: a row of its own, outside the checks and the sums
            b_ms, o_ms = bound_ms(n_bytes, flops)
            return {"kernel": "winograd", "model": src, "batch": batch, "shape": shape, **times,
                    "bytes_ms": b_ms, "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms)}
        return note("winograd", e, src, batch, dtype, shape, tol, times, n_bytes, flops, **extra)

    for src, ss in sets.items():
        for batch in CHECK_BATCHES[src]:
            for dtype in (torch.bfloat16, torch.float32):
                for sig in ss["group_norm"]:
                    gn_checks(src, batch, dtype, *sig)
                for sig in ss["attention"]:
                    attention_checks(src, batch, dtype, *sig)
                for sig in ss["winograd_conv"]:
                    winograd_checks(src, batch, dtype, *sig, timed=dtype == torch.bfloat16)
            for sig in ss["avg_pool_2x2"]:
                pool_checks(src, batch, *sig)
            for sig in ss["interleave_2x"]:
                interleave_checks(src, batch, *sig)
    # a gradient through the CUDA avg-pool pair op against the plain version's
    xa, xb = (rnd(2, 16, 16, 256, dtype=torch.float32).requires_grad_(True) for _ in range(2))
    ct = rnd(2, 8, 8, 256, dtype=torch.float32)
    g_op = torch.autograd.grad([(p * ct).sum() for p in avg_pool_2x2_pair(xa, xb)], (xa, xb))
    g_plain = torch.autograd.grad([(p * ct).sum() for p in kpool.avg_pool_2x2_pair_plain(xa, xb)], (xa, xb))
    if not all(torch.equal(u, v) for u, v in zip(g_op, g_plain)):
        fail("avg_pool_2x2: the gradient through the CUDA op differs from the plain version's")
    torch.cuda.synchronize()
    for r in rows:
        if "ms" in r:
            f32 = f"  (SDPA backend {r['sdpa_backend']}, allow_tf32 {r['allow_tf32']}, bound at {r['bound_rate']})" \
                if "sdpa_backend" in r else ""
            route = f"  route {r['route']}" if r["kernel"] in ("group_norm", "avg_pool_2x2", "interleave_2x") else ""
            route += f"  {r['pair_route']}" if "pair_route" in r else ""
            only = (f"  device-only {r['device_only_ms']:.4f}  host {r['host_us']:.2f} us"
                    if "device_only_ms" in r else "")
            pair = (f"  pair {r['pair_ms']:.4f} (plain {r['pair_plain_ms']:.4f}, F.group_norm+F.silu "
                    f"{r['pair_library_ms']:.4f}, bound {r['pair_bound_ms']:.4f})" if "pair_ms" in r else "")
            print(f"    {r['kernel']:<14} {r['model']:<4} {r['dtype']:<8} {str(r['shape']):<48} err {r['max_abs_err']:.3g}  "
                  f"{r['ms']:.4f} ms{only}  plain {r['plain_ms']:.4f}  library {fmt_ms(r.get('library_ms'))}  "
                  f"bound {r['bound_ms']:.4f}{f32}{route}{pair}", flush=True)
    for r in rows:
        if "rel_l2" in r:
            limit = "rel L2 only" if r["tol"] is None else f"{r['tol']:.3g}"
            route = f"  route {r['route']}" if "route" in r else ""
            print(f"    {r['kernel']:<14} {r['model']:<5} {r['dtype']:<8} {str(r['shape']):<40} max|plain| {r['plain_max']:.4g}  "
                  f"err {r['max_abs_err']:.3g} (limit {limit})  rel L2 {r['rel_l2']:.3e}{route}", flush=True)
    print("[2] sums over each model's distinct shapes at its main-path batch, by dtype, ms (GroupNorm in the type "
          "the path runs, on the route each shape takes there: group_norm beside F.group_norm(+silu), gn_stats beside "
          "torch.var_mean, gn_apply beside none; 'gn pair' times gn_stats + gn_apply back to back beside "
          "F.group_norm(+silu); avg-pool and interleave: the form the model's forward runs, ADM's pairs):", flush=True)
    for (what, src, dt), t in sums.items():
        by = "operations" if t["ops_ms"] > t["bytes_ms"] else "bytes"
        only = (f"  device-only {t['device_only_ms']:.4f}  host {t['host_us']:.2f} us" if "device_only_ms" in t else "")
        print(f"    {what:<14} {src:<4} {dt:<8} {t['shapes']:>2} shapes  card {t['ms']:.4f}{only}  plain {t['plain_ms']:.4f}  "
              f"library {fmt_ms(t.get('library_ms'))}  bound {t['bound_ms']:.4f} ({by})", flush=True)
    print(f"[2] kernels agree with their plain versions at every shape: max errors {err}", flush=True)

    # information: the Winograd kernel at the ADM-128 ResBlock conv shapes it
    # serves (the model's ResBlock convs switched to the Winograd route for one
    # recording forward at the main-path batch); not part of the sums
    resblock_convs = [c for rb in model.modules() if isinstance(rb, ResBlock)
                      for c in (rb.in_layers[2], rb.out_layers[3]) if not c.up2]
    for c in resblock_convs:
        c.winograd = True
    with torch.no_grad(), Recorder({"winograd_conv": kwino}) as rec_adm_wino:
        model(torch.randn(ADM_BATCH, 128, 128, 3, generator=gen, device=dev).to(torch.bfloat16), 500,
              torch.randint(0, cfg.num_classes, (ADM_BATCH,), generator=gen, device=dev))
    for c in resblock_convs:
        c.winograd = False
        c._wino_cache.clear()
    adm_wino = [winograd_checks("adm", ADM_BATCH, torch.bfloat16, *sig, compare=False)
                for sig in shape_sets(rec_adm_wino.sigs)["winograd_conv"]]
    adm_wino_sum = {key: sum(r[key] for r in adm_wino) for key in ("ms", "library_ms", "bound_ms")}
    for r in adm_wino:
        print(f"    winograd (information) adm {str(r['shape']):<36} {r['ms']:.4f} ms  library {r['library_ms']:.4f}  "
              f"bound {r['bound_ms']:.4f}", flush=True)
    print(f"[2] winograd at the {len(adm_wino)} ADM-128 ResBlock conv shapes, batch {ADM_BATCH} (information, bf16): card "
          f"{adm_wino_sum['ms']:.4f} ms  cuDNN {adm_wino_sum['library_ms']:.4f}  bound {adm_wino_sum['bound_ms']:.4f}",
          flush=True)
    details["winograd_adm_information"] = adm_wino
    lap(2)

    # ---- phase 3: full-width ADM forward against float32 on the CPU ------
    check_counts(adm_fwd_counts, ADM_PATH, "ADM forward")
    check_gn_one_launch(adm_gn_routes, "ADM forward")
    for name in ("avg_pool_2x2", "interleave_2x"):
        if adm_fwd_counts[name] != ADM_RESAMPLE or adm_resample[name]["pair"] != ADM_RESAMPLE:
            fail(f"ADM forward: {adm_fwd_counts[name]} {name} launches ({adm_resample[name]}), want {ADM_RESAMPLE} pairs")
    saved = adm_unet.avg_pool_2x2_pair, adm_unet.interleave_and_upsample_2x
    adm_unet.avg_pool_2x2_pair = lambda h, x: (avg_pool_2x2(h), avg_pool_2x2(x))
    adm_unet.interleave_and_upsample_2x = lambda ph, x: (interleave_phases_2x(*ph), nearest_upsample_2x(x))
    try:
        with torch.no_grad():
            out_unpaired = model(x2, 500, y2)
    finally:
        adm_unet.avg_pool_2x2_pair, adm_unet.interleave_and_upsample_2x = saved
    if not torch.equal(out_unpaired, out_adm):
        fail("ADM forward: the paired resampling is not bit-identical to one launch per tensor")
    t0 = time.perf_counter()
    with torch.device("meta"):
        cpu_model = ADMUNet(cfg)
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()}, assign=True)
    with torch.no_grad():
        ref = cpu_model.eval()(x2[:1].float().cpu(), 500, y2[:1].cpu())
    cpu_s = time.perf_counter() - t0
    del cpu_model
    if not bool(torch.isfinite(out_adm).all()):
        fail("ADM forward: non-finite output on the card")
    adm_rel = rel_l2(out_adm[:1], ref)
    print(f"[3] ADM-128 forward ({n_params / 1e6:.1f}M params, bf16, batch 2): {adm_fwd_s:.2f} s first call; "
          f"image 0 vs float32 CPU (batch 1, {cpu_s:.1f} s): rel L2 {adm_rel:.3e} (limit 2e-2)", flush=True)
    print(f"[3] kernels {json.dumps(adm_fwd_counts)}; GroupNorm routes {json.dumps(adm_gn_routes)}; avg-pool and "
          f"interleave launches {json.dumps(adm_resample)}; bit-identical to one launch per tensor", flush=True)
    if not adm_rel <= 2e-2:
        fail(f"ADM forward: relative L2 error {adm_rel} > 2e-2")
    details.update(n_params=n_params, forward_rel_l2=adm_rel, forward_launches=adm_fwd_counts)
    lap(3)

    # ---- phase 4: the ADM main path ---------------------------------------
    B = ADM_BATCH
    yb = torch.randint(0, cfg.num_classes, (B,), generator=gen, device=dev)
    x_T = torch.randn(B, 128, 128, 3, generator=gen, device=dev).to(torch.bfloat16)
    sched = make_schedule("linear", 1000, device=dev)
    scfg = SamplerConfig(num_inference_steps=50, after_step=40, num_steps_uc=10)
    est = make_estimator(EstimatorConfig(name="uncertainty_zigzag_centered", M=5, num_zigzag=3, ensemble_chunk=1))
    forwards = [0]

    def model_fn(x, t, _):
        forwards[0] += 1
        return model(x, t, yb)[..., :3]

    with torch.no_grad():
        model_fn(x_T, 999, None)  # warm-up at this batch
    torch.cuda.synchronize()
    forwards[0] = 0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = sample_ddim(model_fn, sched, x_T, TorchNoise(SEED + 1, dev), scfg, estimator=est)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    adm_launches, resample = kernels.launch_counts(), kernels.resample_counts()
    check_counts(adm_launches, ADM_PATH, "ADM main path")
    for name in ("avg_pool_2x2", "interleave_2x"):
        want = ADM_RESAMPLE * forwards[0]
        if adm_launches[name] != want or resample[name]["pair"] != want:
            fail(f"ADM main path: {adm_launches[name]} {name} launches ({resample[name]}), want {want} pairs "
                 f"({forwards[0]} forwards)")
    if not bool(torch.isfinite(res.sample.float()).all()):
        fail("ADM main path: non-finite sample")
    u = res.uncertainty
    if tuple(u.shape) != (10, B, 128, 128, 3):
        fail(f"ADM main path: uncertainty shape {tuple(u.shape)}")
    u_mean = float(u.mean())
    if not (math.isfinite(u_mean) and u_mean > 0):
        fail(f"ADM main path: uncertainty mean {u_mean}")
    ips = B / wall
    print(f"[4] ADM main path: 50 DDIM steps, zigzag M=5 x3 in [40, 50), bf16, batch {B}: {wall:.2f} s, "
          f"{ips:.4f} images/s on {card} (information, not a claim); uncertainty mean {u_mean:.4e}", flush=True)
    print(f"[4] kernels {json.dumps(adm_launches)} over {forwards[0]} forwards; avg-pool and interleave launches "
          f"{json.dumps(resample)}", flush=True)
    details.update(main_path_s=wall, images_per_s=ips, main_path_launches=adm_launches, uncertainty_mean=u_mean)
    del model, res
    lap(4)

    # ---- phase 5: full-width SD 1.5 UNet and VAE, forward and backward ---
    check_counts(sd_fwd_counts, [k for k in SD_PATH if k not in ("gn_stats", "gn_apply")], "SD UNet forward")
    if sd_fwd_counts["interleave_2x"] != 3:
        fail(f"SD UNet forward: {sd_fwd_counts['interleave_2x']} interleave launches, want 3 (its up-samplers)")
    check_tc_routes(sd_fwd_routes, "SD UNet forward")
    check_gn_one_launch(sd_gn_routes, "SD UNet forward")
    # the VAE's GroupNorms: the pair exactly where the route rule sends a group
    # beyond 8 blocks, which every 256x256 and 512x512 map is
    vae_gn = [sig for name, sig in rec_vae.sigs if name == "group_norm"]
    vae_pair = [sig for sig in vae_gn if kgn.route(1, sig[0] * sig[1], sig[2], sig[3], 4)[0] == "pair"]
    if any(sig[0] * sig[1] >= 256 * 256 and sig not in vae_pair for sig in vae_gn):
        fail(f"VAE decode: a GroupNorm over a 256x256 or larger map is routed to one launch: {vae_gn}")
    if vae_gn_routes != {"one_launch": len(vae_gn) - len(vae_pair), "pair": len(vae_pair)} or len(vae_pair) != VAE_PAIRS:
        fail(f"VAE decode: GroupNorm routes {vae_gn_routes}, expected {len(vae_pair)} pair of {len(vae_gn)} "
             f"({VAE_PAIRS} pairs)")
    if vae_pair_routes != {"wide": 2 * VAE_PAIRS, "scalar": 0} or vae_counts["gn_stats"] != VAE_PAIRS:
        fail(f"VAE decode: gn_stats / gn_apply launches {vae_counts} by route {vae_pair_routes}: want {VAE_PAIRS} "
             f"of each, all on 16-byte words")
    if vae_counts["attention_long"] <= 0 or vae_counts["gn_apply"] <= 0:
        fail(f"VAE decode: kernels not launched {vae_counts}")
    if vae_routes["wide"] != vae_counts["attention_long"] or vae_routes["cuda_core"] or vae_routes["tensor_core"]:
        fail(f"VAE decode: its float32 D=512 attention must take the wide route, took {vae_routes}")
    if not (bool(torch.isfinite(out_sd).all()) and bool(torch.isfinite(img64).all())):
        fail("SD forward: non-finite output on the card")
    if tuple(img64.shape) != (1, 512, 512, 3):
        fail(f"VAE decode: image shape {tuple(img64.shape)}")
    t0 = time.perf_counter()
    with torch.device("meta"):
        cpu_unet = SDUNet(stack.mcfg)
    cpu_unet.load_state_dict({k: v.float().cpu() for k, v in unet.state_dict().items()}, assign=True)
    with torch.no_grad():
        ref = cpu_unet.eval()(xs[:1].cpu(), 500, ctx[:1].cpu())
    sd_cpu_s = time.perf_counter() - t0
    del cpu_unet
    sd_rel = rel_l2(out_sd[:1], ref)
    with torch.no_grad(), PlainKernels(wrapper_mods, plains):
        sd_plain_rel = rel_l2(unet(xs[:1], 500, ctx[:1]), ref)
    z32 = torch.randn(1, 32, 32, 4, generator=gen, device=dev)
    with torch.no_grad():
        img32 = vae.decode(z32)
    with torch.device("meta"):
        cpu_vae = AutoencoderKL(vae.cfg)
    cpu_vae.load_state_dict({k: v.float().cpu() for k, v in vae.state_dict().items()}, assign=True)
    with torch.no_grad():
        vae_rel = rel_l2(img32, cpu_vae.eval().decode(z32.cpu()))
    del cpu_vae
    print(f"[5] SD 1.5 UNet forward ({n_sd / 1e6:.1f}M params, bf16, batch 2): {sd_fwd_s:.2f} s first call; image 0 vs "
          f"float32 CPU ({sd_cpu_s:.1f} s): rel L2 {sd_rel:.3e} (the plain versions on the card: {sd_plain_rel:.3e}); "
          f"VAE decoder (float32) 32x32 latent: rel L2 {vae_rel:.3e} (limits: UNet 2e-2 and plain + 1e-3, VAE 1e-4)",
          flush=True)
    print(f"[5] kernels UNet {json.dumps(sd_fwd_counts)} VAE {json.dumps(vae_counts)}", flush=True)
    print(f"[5] attention routes UNet {json.dumps(sd_fwd_routes)} VAE {json.dumps(vae_routes)}; GroupNorm routes UNet "
          f"{json.dumps(sd_gn_routes)} VAE {json.dumps(vae_gn_routes)} (pair at {sorted(set(vae_pair))}, its launches "
          f"by word {json.dumps(vae_pair_routes)})", flush=True)
    if not (sd_rel <= 2e-2 and sd_rel <= sd_plain_rel + 1e-3):
        fail(f"SD UNet forward: relative L2 error {sd_rel} (plain versions {sd_plain_rel}; limits 2e-2 and plain + 1e-3)")
    if not vae_rel <= 1e-4:
        fail(f"VAE decode: relative L2 error {vae_rel} > 1e-4")

    def input_grad():
        xg = xs[:1].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(unet(xg, 500, ctx[:1]).square().mean(), xg)
        return g

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    grad = input_grad()
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    bwd_counts, bwd_routes, bwd_gn_routes = kernels.launch_counts(), kernels.route_counts(), kernels.gn_route_counts()
    with PlainKernels(wrapper_mods, plains):
        grad_plain = input_grad()
    torch.cuda.synchronize()
    if kernels.launch_counts() != bwd_counts:
        fail("backward check: the plain-version run launched a kernel")
    check_counts(bwd_counts, [k for k in SD_PATH if k not in ("gn_stats", "gn_apply")], "SD backward")
    check_tc_routes(bwd_routes, "SD backward")
    check_gn_one_launch(bwd_gn_routes, "SD backward")
    if not bool(torch.isfinite(grad).all()):
        fail("SD backward: non-finite input gradient")
    grad_rel = rel_l2(grad, grad_plain)
    print(f"[5] SD 1.5 UNet backward (batch 1): {bwd_s:.2f} s; input grad vs the plain versions on the card: "
          f"rel L2 {grad_rel:.3e} (limit 5e-2)", flush=True)
    if not grad_rel <= 5e-2:
        fail(f"SD backward: relative L2 error {grad_rel} > 5e-2")
    details.update(sd_params=n_sd, sd_forward_rel_l2=sd_rel, sd_plain_rel_l2=sd_plain_rel, vae_rel_l2=vae_rel,
                   sd_grad_rel_l2=grad_rel,
                   sd_forward_launches=sd_fwd_counts, vae_launches=vae_counts)
    lap(5)

    # ---- phase 6: the SD 1.5 main path at the CLI defaults ---------------
    cli = T2IConfig(random_init=True)
    cond = torch.from_numpy(pseudo_text_embeddings([cli.prompt])).to(dev)
    uncond = torch.from_numpy(pseudo_text_embeddings([cli.prompt_negative])).to(dev)
    sd_runs = {}
    for use_posterior in (False, True):
        tag = "posterior" if use_posterior else "gradient"
        pcfg = T2IPipelineConfig(
            num_inference_steps=cli.num_steps, guidance_scale=cli.guidance_scale,
            start_step_uc=cli.start_step_threshold, num_steps_uc=cli.num_steps_threshold,
            percentile=cli.percentile, use_posterior=use_posterior, lr=cli.strength, M=cli.M,
            latent_channels=stack.mcfg.in_channels, latent_size=stack.latent_size,
        )
        pipe = TextToImageUncertaintyPipeline(stack.denoise_fn, stack.schedule, stack.decode_fn, pcfg)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = pipe(cond, TorchNoise(cli.seed, dev), uncond_embeds=uncond)
        torch.cuda.synchronize()
        s_img = time.perf_counter() - t0
        counts, routes, gn_routes = kernels.launch_counts(), kernels.route_counts(), kernels.gn_route_counts()
        check_counts(counts, SD_PATH, f"SD main path ({tag})")
        check_tc_routes(routes, f"SD main path ({tag})")
        if gn_routes["pair"] != vae_gn_routes["pair"] or gn_routes["one_launch"] <= 0:
            fail(f"SD main path ({tag}): GroupNorm routes {gn_routes}: the pair only for the one VAE decode's "
                 f"{vae_gn_routes['pair']} large maps")
        if routes["wide"] < 1:
            fail(f"SD main path ({tag}): the VAE decode's attention did not take the wide route: {routes}")
        if tuple(out.images.shape) != (1, 512, 512, 3) or not bool(torch.isfinite(out.images).all()):
            fail(f"SD main path ({tag}): images {tuple(out.images.shape)}, finite {bool(torch.isfinite(out.images).all())}")
        if tuple(out.uncertainty.shape) != (1, 20, 64, 64, 4):
            fail(f"SD main path ({tag}): uncertainty shape {tuple(out.uncertainty.shape)}")
        um = float(out.uncertainty.mean())
        if not (math.isfinite(um) and um > 0):
            fail(f"SD main path ({tag}): uncertainty mean {um}")
        print(f"[6] SD 1.5 main path ({tag} guidance): 512x512, 20 steps, CFG 7.5, window [0, 20), p 0.95, M=5: "
              f"{s_img:.2f} s per image on {card} (information, not a claim); uncertainty mean {um:.4e}", flush=True)
        print(f"[6] kernels {json.dumps(counts)}; attention routes {json.dumps(routes)}; GroupNorm routes "
              f"{json.dumps(gn_routes)}", flush=True)
        sd_runs[tag] = {"s_per_image": s_img, "launches": counts, "routes": routes, "gn_routes": gn_routes,
                        "uncertainty_mean": um}
    details.update(sd_main_path=sd_runs)
    lap(6)

    # ---- phase 7: full-width CIFAR-10 UNet forward -----------------------
    for name, want in CIFAR_FORWARD.items():
        if cifar_counts[name] != want:
            fail(f"CIFAR-10 forward: {cifar_counts[name]} {name} launches, want {want}")
    check_gn_one_launch(cifar_gn_routes, "CIFAR-10 forward")
    if not bool(torch.isfinite(out_cifar).all()):
        fail("CIFAR-10 forward: non-finite output on the card")
    t0 = time.perf_counter()
    with torch.device("meta"):
        cpu_cifar = UNet2D(cifar_direct.model.cfg)
    cpu_cifar.load_state_dict({k: v.float().cpu() for k, v in cifar.model.state_dict().items()}, assign=True)
    with torch.no_grad():
        ref = cpu_cifar.eval()(xc[:1].float().cpu(), 500)
        direct = cifar_direct.model(xc, 500)
    cifar_cpu_s = time.perf_counter() - t0
    del cpu_cifar
    cifar_rel = rel_l2(out_cifar[:1], ref)
    cifar_vs_direct = rel_l2(out_cifar, direct)
    direct_rel = rel_l2(direct[:1], ref)
    print(f"[7] CIFAR-10 UNet forward ({n_cifar / 1e6:.1f}M params, bf16, Winograd on, batch {CIFAR_BATCH}): "
          f"{cifar_fwd_s:.3f} s first call; image 0 vs float32 CPU with the direct conv ({cifar_cpu_s:.1f} s): rel L2 "
          f"{cifar_rel:.3e} (limit 2e-2); vs the same card forward with winograd=False: rel L2 {cifar_vs_direct:.3e}; "
          f"winograd=False vs float32 CPU: {direct_rel:.3e}", flush=True)
    print(f"[7] kernels {json.dumps(cifar_counts)}; GroupNorm routes {json.dumps(cifar_gn_routes)}", flush=True)
    if not cifar_rel <= 2e-2:
        fail(f"CIFAR-10 forward: relative L2 error {cifar_rel} > 2e-2")
    details.update(cifar_params=n_cifar, cifar_forward_rel_l2=cifar_rel, cifar_vs_direct_rel_l2=cifar_vs_direct,
                   cifar_direct_rel_l2=direct_rel, cifar_forward_launches=cifar_counts)
    del cifar, cifar_direct, out_cifar, direct
    lap(7)

    # ---- phase 8: the CIFAR-10 main path through the dataset CLI's functions
    n_fwd = 50 + 10  # trajectory steps, plus one folded M=5 ensemble forward per window step
    cifar_runs = {}
    saved_env = {k: os.environ.get(k) for k in ("DIFFUSION_UNCERTAINTY_ROOT", "DU_TPU_WINOGRAD")}
    with tempfile.TemporaryDirectory() as root:
        os.environ["DIFFUSION_UNCERTAINTY_ROOT"] = root
        generate_starting_points.main(["--datasets", "cifar10", "--num-samples", str(CIFAR_BATCH), "--extra-samples", "0"])
        x_t, _ = dataset_cli.load_starting_points("cifar10", 0, CIFAR_BATCH)
        for flag in ("1", None):
            if flag is None:
                os.environ.pop("DU_TPU_WINOGRAD", None)
            else:
                os.environ["DU_TPU_WINOGRAD"] = flag
            winograd = os.environ.get("DU_TPU_WINOGRAD", "0") == "1"  # as the CLI reads it
            tag = "winograd" if winograd else "direct"
            bundle = instantiate_model_scheduler("cifar10", dropout=0.1, random_init=True, device=dev, winograd=winograd)
            apply_fn, est_apply = dataset_cli.select_apply_fn(bundle, "mc_dropout")
            with torch.no_grad():  # warm-up at the run's two batch sizes (weight transforms, cuDNN plans)
                xw = torch.from_numpy(x_t).to(dev)
                apply_fn(xw, 999, None, None)
                est_apply(xw.repeat(5, 1, 1, 1), 999, None, TorchNoise(SEED, dev))
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = generate_uncertainty_dataset(
                apply_fn, bundle.schedule, SamplerConfig(num_inference_steps=50, after_step=40, num_steps_uc=10),
                x_t, None, CIFAR_BATCH, seed=SEED, estimator=make_estimator(EstimatorConfig(name="mc_dropout", M=5)),
                estimator_apply_fn=est_apply,
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            want = {name: n * n_fwd for name, n in CIFAR_FORWARD.items()}
            want["winograd"] = want["winograd"] if winograd else 0
            print(f"[8] kernels ({tag}) {json.dumps(counts)}; expected {json.dumps(want)}", flush=True)
            if any(counts[name] != n for name, n in want.items()):
                fail(f"CIFAR-10 main path ({tag}): launches {counts}, expected {want}")
            u = res.uncertainty
            if tuple(u.shape) != (CIFAR_BATCH, 10, 32, 32, 3) or not bool(np.isfinite(u).all()):
                fail(f"CIFAR-10 main path ({tag}): uncertainty {u.shape}, finite {bool(np.isfinite(u).all())}")
            um = float(u.mean())
            if not um > 0:
                fail(f"CIFAR-10 main path ({tag}): uncertainty mean {um}")
            ips = CIFAR_BATCH / wall
            print(f"[8] CIFAR-10 main path ({tag}): mc_dropout M=5, 50 DDIM steps, window [40, 50), bf16, batch "
                  f"{CIFAR_BATCH}: {wall:.2f} s, {ips:.2f} images/s on {card} (information, not a claim); "
                  f"uncertainty mean {um:.4e}", flush=True)
            cifar_runs[tag] = {"s": wall, "images_per_s": ips, "launches": counts, "uncertainty_mean": um}
            del bundle, res
    for k, v in saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    details.update(cifar_main_path=cifar_runs, checks=rows, sums={" ".join(key): t for key, t in sums.items()})
    lap(8)

    # ---- phase 9: ADM-64 and the metrics -----------------------------------
    # 9a: the full-width ADM-64 forward of the recording run
    check_counts(adm64_counts, ADM_PATH, "ADM-64 forward")
    check_tc_routes(adm64_routes, "ADM-64 forward")
    for name in ("avg_pool_2x2", "interleave_2x"):
        if adm64_counts[name] != ADM64_RESAMPLE or adm64_resample[name]["pair"] != ADM64_RESAMPLE:
            fail(f"ADM-64 forward: {adm64_counts[name]} {name} launches ({adm64_resample[name]}), want "
                 f"{ADM64_RESAMPLE} pairs")
    if not bool(torch.isfinite(out_adm64).all()):
        fail("ADM-64 forward: non-finite output on the card")
    t0 = time.perf_counter()
    with torch.device("meta"):
        cpu_adm64 = ADMUNet(adm64.model.cfg)
    cpu_adm64.load_state_dict({k: v.float().cpu() for k, v in adm64.model.state_dict().items()}, assign=True)
    with torch.no_grad():
        ref = cpu_adm64.eval()(x64[:1].float().cpu(), 500, y64[:1].cpu())
    adm64_cpu_s = time.perf_counter() - t0
    del cpu_adm64, adm64
    adm64_rel = rel_l2(out_adm64[:1], ref)
    print(f"[9a] ADM-64 forward ({n_adm64 / 1e6:.1f}M params, bf16, batch {ADM64_BATCH}): {adm64_fwd_s:.3f} s; image 0 "
          f"(6 channels) vs float32 CPU (batch 1, {adm64_cpu_s:.1f} s): rel L2 {adm64_rel:.3e} (limit 2e-2)", flush=True)
    print(f"[9a] kernels {json.dumps(adm64_counts)}; attention routes {json.dumps(adm64_routes)}; GroupNorm routes "
          f"{json.dumps(adm64_gn_routes)} ({adm64_gn_routes['pair']} GroupNorms took the pair); avg-pool and interleave "
          f"{json.dumps(adm64_resample)}", flush=True)
    if not adm64_rel <= 2e-2:
        fail(f"ADM-64 forward: relative L2 error {adm64_rel} > 2e-2")
    metric_runs = {}

    def path_run(tag, fn):
        """One main-path run of phase 9 between zeroed and read counters:
        every ADM kernel launches, attention on the tensor-core route."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, routes, gn_routes = kernels.launch_counts(), kernels.route_counts(), kernels.gn_route_counts()
        check_counts(counts, ADM_PATH, f"ADM-64 {tag}")
        check_tc_routes(routes, f"ADM-64 {tag}")
        print(f"[9] {tag}: kernels {json.dumps(counts)}; attention routes {json.dumps(routes)}; GroupNorm routes "
              f"{json.dumps(gn_routes)}", flush=True)
        metric_runs[tag] = {"s": wall, "launches": counts, "routes": routes, "gn_routes": gn_routes}
        return out, wall

    saved_root = os.environ.get("DIFFUSION_UNCERTAINTY_ROOT")
    with tempfile.TemporaryDirectory() as root:
        os.environ["DIFFUSION_UNCERTAINTY_ROOT"] = root
        # 9b: BASELINE config 2, ADM-64 zigzag + AUSE, through the AUSE CLI
        res, wall = path_run("AUSE", lambda: compute_ause.main([
            "--dataset", "imagenet64", "--scheduler-type", "uncertainty_zigzag_centered", "--M", "5", "--num-zigzag", "3",
            "--num-steps-uc", "20", "--batch-size", str(ADM64_BATCH), "--num-samples", "16", "--random-init", "true"]))
        if not (math.isfinite(res.ause) and math.isfinite(res.aurg)):
            fail(f"ADM-64 AUSE: AUSE {res.ause}, AURG {res.aurg}")
        if not (math.isfinite(res.uncertainty_mean) and res.uncertainty_mean > 0):
            fail(f"ADM-64 AUSE: summed map mean {res.uncertainty_mean}")
        print(f"[9b] BASELINE config 2 (ADM-64 zigzag M=5 x3, steps [10, 20) of 20, bf16, batch {ADM64_BATCH}, "
              f"{res.images} synthetic images): AUSE {res.ause:.6f}, AURG {res.aurg:.6f}, summed map mean "
              f"{res.uncertainty_mean:.4e}; {res.seconds:.2f} s in the batches, {res.images / res.seconds:.4f} images/s "
              f"on {card} ({wall:.2f} s with the model's set-up)", flush=True)
        metric_runs["AUSE"].update(ause=res.ause, aurg=res.aurg, uncertainty_mean=res.uncertainty_mean,
                                   batch_s=res.seconds, images_per_s=res.images / res.seconds)

        # 9c: ADM-64 NLL, 1000 forwards of the 6-channel model a batch
        res, wall = path_run("NLL", lambda: compute_nll.main([
            "--dataset", "imagenet64", "--variance-type", "learned_range", "--batch-size", str(ADM64_BATCH),
            "--num-samples", str(ADM64_BATCH), "--random-init", "true"]))
        if not (math.isfinite(res.total_bpd) and res.total_bpd > 0):
            fail(f"ADM-64 NLL: total bpd {res.total_bpd}")
        print(f"[9c] ADM-64 NLL (learned_range, 1000 steps, bf16, batch {ADM64_BATCH}): {res.total_bpd:.4f} bpd, "
              f"{res.seconds_per_batch:.2f} s a batch on {card}", flush=True)
        metric_runs["NLL"].update(total_bpd=res.total_bpd, seconds_per_batch=res.seconds_per_batch)

        # 9d: FID and precision/recall on a short dataset-CLI run of ADM-64,
        # with real-architecture extractors of seeded random weights
        n_img = 4 * ADM64_BATCH
        generate_starting_points.main(["--datasets", "imagenet64", "--num-samples", str(n_img), "--extra-samples", "0"])
        run, wall = path_run("dataset CLI", lambda: dataset_cli.main([
            "--dataset", "imagenet64", "--scheduler-type", "uncertainty_centered", "--random-init", "true",
            "--num-samples", str(n_img), "--batch-size", "16", "--M", "5", "--generation-steps", "10",
            "--start-step-uc", "5", "--num-steps-uc", "5"]))
        weights = {}
        for arch in ("inception", "vgg16"):
            weights[arch] = os.path.join(root, f"{arch}.pth")
            torch.save(random_state_dict(arch, seed=SEED), weights[arch])
        imgs = torch.from_numpy(load_run_arrays(run, "gen_images")[:16]).to(dev)
        for arch, make in (("inception", InceptionV3Features), ("vgg16", VGG16Features)):
            ext, ext_cpu = make(weights[arch]), make(weights[arch], device="cpu")
            feats = ext(imgs)
            ext_rel = rel_l2(feats[:2], ext_cpu(imgs[:2].cpu()))
            ms = device_ms(lambda: ext(imgs), reps=3, inner=3)
            print(f"[9d] {arch} features (float32, {imgs.shape[1]}x{imgs.shape[2]} images, batch 16): card vs float32 "
                  f"CPU (batch 2) rel L2 {ext_rel:.3e} (limit 1e-4); {ms:.3f} ms a batch, {16e3 / ms:.1f} features/s "
                  f"on {card}", flush=True)
            if not (bool(torch.isfinite(feats).all()) and ext_rel <= 1e-4):
                fail(f"{arch} features: finite {bool(torch.isfinite(feats).all())}, rel L2 against the CPU {ext_rel}")
            metric_runs[f"{arch} features"] = {"rel_l2": ext_rel, "batch_ms": ms, "features_per_s": 16e3 / ms}
            del ext, ext_cpu
        common = ["--dataset", "imagenet64", "--batch-size", "16"]
        drop = ["--run-dir", str(run), "--drop-fraction", "0.25"]
        t0 = time.perf_counter()
        compute_fid.main(common + ["--mode", "stats", "--num-samples", str(n_img), "--inception-weights", weights["inception"]])
        fids = compute_fid.main(common + ["--mode", "drop", "--inception-weights", weights["inception"]] + drop)
        fid_s = time.perf_counter() - t0
        compute_precision_recall.main(common + ["--mode", "real", "--num-samples", str(n_img), "--vgg-weights", weights["vgg16"]])
        pr = compute_precision_recall.main(common + ["--mode", "generated", "--k", "3", "--vgg-weights", weights["vgg16"]] + drop)
        pr_s = time.perf_counter() - t0 - fid_s
        scores = {k: fids[k] for k in ("fid_drop_most", "fid_drop_random")}
        scores.update({k: pr[k] for k in ("precision_drop_most", "recall_drop_most", "precision_drop_random",
                                          "recall_drop_random")})
        print(f"[9d] FID stats + drop ({n_img} real, {n_img} generated, 25% dropped; {fid_s:.1f} s) and precision/recall "
              f"real + generated (k=3; {pr_s:.1f} s): {json.dumps(scores)}", flush=True)
        if not all(math.isfinite(v) for v in scores.values()):
            fail(f"metrics: a non-finite score {scores}")
        if not all(0.0 <= pr[k] <= 1.0 for k in scores if not k.startswith("fid")):
            fail(f"metrics: precision or recall outside [0, 1]: {scores}")
        # the random model's images lie off the real manifold (0 is a right
        # answer there); two halves of the real features overlap, on the card
        # as on the CPU
        real = np.load(paths.results() / "pr-features" / "imagenet64_real.npy")
        halves = real[: n_img // 2], real[n_img // 2 :]
        pr_card, pr_cpu = precision_recall(*halves), precision_recall(*halves, device="cpu")
        print(f"[9d] precision/recall of two halves of the real features (k=3): card {tuple(pr_card)}, CPU "
              f"{tuple(pr_cpu)}", flush=True)
        if not (min(pr_card) > 0 and max(abs(a - b) for a, b in zip(pr_card, pr_cpu)) <= 1.0 / len(halves[0]) + 1e-6):
            fail(f"precision/recall of the real halves: card {pr_card}, CPU {pr_cpu}")
        metric_runs["scores"] = {**scores, "fid_s": fid_s, "pr_s": pr_s, "real_halves_card": tuple(pr_card),
                                 "real_halves_cpu": tuple(pr_cpu)}
    if saved_root is None:
        os.environ.pop("DIFFUSION_UNCERTAINTY_ROOT", None)
    else:
        os.environ["DIFFUSION_UNCERTAINTY_ROOT"] = saved_root
    details.update(adm64_params=n_adm64, adm64_forward_rel_l2=adm64_rel, adm64_forward_launches=adm64_counts,
                   adm64_gn_routes=adm64_gn_routes, metric_runs=metric_runs)
    lap(9)

    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)), exist_ok=True)
        with open(args.details, "w") as f:
            json.dump(details, f, indent=1, default=str)

    path_runs = (*sd_runs.values(), *cifar_runs.values(), *(r for r in metric_runs.values() if "launches" in r))
    launches = {k: adm_launches[k] + sum(r["launches"][k] for r in path_runs) for k in names}
    entries = []
    for k, (src, replaces) in KERNELS.items():
        mine = [v for (w, _, _), v in sums.items() if w == k]
        t = {key: sum(v[key] for v in mine) for key in ("ms", "plain_ms", "bytes_ms", "ops_ms", "bound_ms")}
        # null where no PyTorch call computes the kernel's function (gn_apply)
        t["library_ms"] = sum(v["library_ms"] for v in mine) if mine and all("library_ms" in v for v in mine) else None
        entry = {
            "name": k, "route": "cuda", "source": src, "replaces": replaces, "launches": launches[k],
            "max_abs_err": err[k], "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "operations" if t["ops_ms"] > t["bytes_ms"] else "bytes",
            "library_ms": t["library_ms"],
        }
        if k in RESAMPLE_FORMS:
            # the sums above take the form each forward runs (ADM: a pair a
            # launch); the single form, one tensor a shape, is summed beside it
            single = [r for r in rows if r["kernel"] == k and r.get("form") == RESAMPLE_FORMS[k]
                      and r["batch"] == CHECK_BATCHES[r["model"]][0]]
            entry.update({key: sum(v[key] for (w, _, _), v in sums.items() if w == k)
                          for key in ("device_only_ms", "host_us")},
                         forms="ADM-128, ADM-64: pair (two tensors a launch); SD, CIFAR-10: single",
                         single_form={key: sum(r[key] for r in single)
                                      for key in ("ms", "device_only_ms", "host_us", "plain_ms", "library_ms", "bound_ms")})
        entries.append(entry)
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
