#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and hold its kernels to account.

    python3 chip_smoke.py [--details PATH]   # one card, about nine minutes

Phases (a failure in any of them ends the run with a non-zero exit):

1. Build the hand-written Hopper kernels from ``diffusion_uncertainty_torch/
   kernels/csrc`` with nvcc (one process per source, in parallel); print the
   seconds, the card's name and power limit, and the registers and spills
   of every attention, Winograd, GroupNorm, avg-pool and interleave kernel
   instance (ptxas); a spill in any but attention fails the run.
2. Hold every kernel against its plain PyTorch version on the card, at every
   shape the full-width models give it, recorded from the forwards of phases
   3, 5, 7, 9 and 10: ADM-128 at batch 2 and 8, the SD 1.5 UNet at batch 2 (the
   CFG batch), the SD VAE decoder at batch 1 (64x64 latent), the CIFAR-10 UNet
   at batch 128 (the CLI batch), ADM-64 at batch 8 (phase 9's batch), U-ViT-huge
   at batch 8 (the trajectory) and 40 (the folded M=5 ensemble), the bf16
   VAE decodes of the U-ViT datasets (a 32x32 latent at batch 8, a 64x64 latent
   at batch 1), the joint attention of SD3-medium and SD3.5-large (D=64, 24
   and 38 heads, 1040 tokens) at batch 2 and 10 and of Flux-dev (D=128) at
   batch 1 and 5 (phase 13, which fails unless its forwards make exactly
   these shapes), SD3-medium's over 1024 + 77 tokens at batch 8 (phase
   13d), the same joint attention over the real text towers' 1024 + 154
   (SD3, SD3.5) and 1024 + 77 tokens (Flux) at the same batches (phase 14b),
   the SD 2.1 UNet at batch 2 and 10 (the CFG batch and the folded M=5
   ensemble; its 64-wide heads over 4096 keys and its 5-key
   cross-attention), and the ImageNet-128 noisy classifier at batch 8 (phase 11; it
   runs in float32, so its GroupNorm, attention and avg-pool shapes are timed
   in float32, its D=64 attention on the CUDA-core route against SDPA and a
   bound at 67 TFLOP/s of float32 FMAs), in bfloat16 and float32. Tolerances:
   interleave bit-exact (the phase interleave, the nearest upsample and their
   pair, at every interleave shape); avg-pool within 1 ulp of the type the
   model pools in (one tensor and a pair); each prints its route (wide / narrow: 16-byte words or
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
   pair's word width); attention (U-ViT's D=72 on q, k, v views of one qkv
   projection, as the model makes them), scaled to the output (whose size
   falls as 1/sqrt(S_kv) for random inputs), max |kernel - plain| <=
   2^-6·max|plain| (2 to 4 bf16 ulps of the largest output) and relative L2 <= 5e-3 in bf16, max |kernel - plain| <=
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
6. SD 1.5 main path, the CLI defaults with ``--vae-weights`` (a seeded random
   decoder saved to a temporary folder, which the recording forwards of
   phase 5 also use): ``build_sd_stack`` +
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
10. U-ViT (BASELINE config 4), the factory's ``imagenet256`` and
   ``imagenet512`` bundles (seeded random bf16 weights, N(0, 0.02) with norm
   scales 1). (a) The full-width U-ViT-huge/2 forward (batch 8, t=500,
   latents rounded to bf16) against the same weights in float32 on the CPU
   at batch 1: rel L2 <= 2e-2 and at most 1e-3 above the same bf16 forward
   through the plain versions on the card; exactly 29 attention launches
   (28 blocks and the mid block), every one on the tensor-core route (D=72).
   (b) The dataset CLI's main path through its functions:
   ``uncertainty_zigzag_centered`` M=5, num_zigzag=3, 50 DDIM steps, window
   [40, 50), bf16, batch 8, on the port's ``imagenet256`` starting points,
   the final latents decoded by the bf16 VAE: images [8, 256, 256, 3] uint8,
   maps [8, 10, 32, 32, 4] finite with positive mean, images/s; every
   kernel of the path launched (one-launch GroupNorm, the pair for the
   decode's 256x256x256 map, attention), 29 tensor-core attention launches
   a forward, none on the CUDA-core route, the decode's on the wide route.
   (c) The full-width U-ViT-huge/4 forward (batch 2) against float32 on the
   CPU at batch 1 with the limits of (a); one bf16 decode of a 64x64 latent
   at batch 1: [1, 512, 512, 3] finite, its attention on the wide route, the
   GroupNorms over its 512x512 maps on the pair.
11. Classifier guidance (BASELINE config 3) and ADM w/ 2-DPM, ADM-128 from
   the factory with seeded random weights. (a) The noisy classifier of
   ``load_classifier("imagenet128", random_init=True)`` (float32, batch 8,
   t=500): its logits and its guidance term sqrt(1-ab_t)·grad_x log p(y|x)
   (``with_classifier_guidance`` around a zero eps: one forward and one
   backward through the kernels' autograd wrappers) against the same weights
   and inputs in float32 on the CPU, rel L2 <= 1e-4 and <= 1e-3, the plain
   versions on the card printed beside them; a forward launches 8 attention
   kernels (all on the CUDA-core route, D=64), 40 one-launch or paired
   GroupNorms and 4 avg-pool pairs; the term's ms (CUDA events). (b) The
   dataset CLI with no ``--device``: imagenet128, ``--classifier-scale
   1.0``, uncertainty_zigzag_centered M=5 x3, 50 DDIM steps, window [40,
   50), bf16, batch 8, 8 images; then ``compute_fid`` stats (32 synthetic
   images) and drop, ``compute_precision_recall`` real and generated on the
   run (seeded random Inception and VGG16): maps [8, 10, 128, 128, 3]
   finite with positive mean, 50 guided calls (400 CUDA-core attention
   launches and 400 attention backwards), 200 ADM forwards of batch 8 (in 80
   calls: the zigzag members are folded), 16 tensor-core attention launches
   an ADM call, the FID and precision/recall records written, finite, P and
   R in [0, 1]; images/s of the sampling. (c) The same CLI with
   ``dpm_2_uncertainty_centered`` (DPM-Solver++ order 2, 50 steps, centered
   M=5 on [40, 50)): 100 ADM forwards in 60 calls, attention on the
   tensor-core route only, maps [8, 10, 128, 128, 3] finite; images/s.
12. The remaining estimators and guidances on ADM-128 (bf16, batch 8,
   seeded random weights, no ``--device``). (a) The dataset CLI once for
   each of ``uncertainty`` (activation noise at in_8, out_1, out_4,
   out_12) and ``uncertainty_grad`` (the gradient guidance: a forward and a
   backward to ε at the folded batch 40 each window step), both 50 DDIM
   steps with the window [40, 50) and M=5, and ``infer_noise``,
   ``uncertainty_image``, ``uncertainty_centered_d`` and ``flip``, 10 steps
   with the window [8, 10): maps finite with positive mean, the ADM calls
   and forwards each type makes, 16 tensor-core attention launches an ADM
   call, every GroupNorm on the one-launch route, and for
   ``uncertainty_grad`` one backward through each op wrapper (GroupNorm,
   attention, the avg-pool and interleave pairs) for each launch of its
   forward; images/s and peak memory. (b) One window step's gradient of
   ``uncertainty_grad`` (t=180, M=5, one fixed ensemble draw) with the
   kernels against the same step with every kernel replaced by its plain
   version: dε and u within rel L2 5e-2; seconds and peak memory of both.
   (c) ``generate_guided`` on imagenet128 with ``--guidance posterior``
   (50 steps, window [40, 50), FID on: the extractor that ran is printed),
   ``gradient``, ``second_order`` and ``mask`` (10 steps, window [8, 10)):
   a record appended each, the guided images differ from the plain ones.

13. SD3-medium, SD3.5-large and Flux-dev on the flow-matching sampler, the
   t2i CLI's models (``build_flow_stack``: seeded random weights drawn in
   bf16 on the card), 512x512 (64x64x16 latents, 1024 image and 16
   pseudo-text tokens). (a) Each full-width forward (t=500; SD3 models at
   the CFG batch 2, Flux at batch 1 with guidance 7500; inputs rounded to
   bf16) against float32 (SD3-medium on the CPU at batch 1; SD3.5-large and
   Flux-dev, 32 and 48 GB of float32 weights, on the card through the plain
   versions, the weights converted in place): rel L2 <= 2e-2 and at most
   1e-3 above the same bf16 forward through the plain versions; exactly 24,
   38 and 19 + 38 attention launches, all on the tensor-core route, at
   phase 2's shapes. (b) The t2i CLI with no ``--device`` at its defaults
   (20 steps, window [0, 20), M=5 folded, percentile 0.95, CFG 7.5,
   ``--random-init true``): sd3 and flux in the gradient and the posterior
   branch, sd35 posterior: the JAX CLI's file names, maps (20, 1, 64, 64,
   16) finite with positive mean, model calls 2·20 + 20 (posterior) or
   2·20 + 2·20 with 40 under autograd (gradient: each window step's
   ensemble call is checkpointed and recomputed), attention launches =
   calls x sites, attention backwards = sites x half the autograd calls;
   guided and plain seconds, images/s, peak memory. (c) One sd3 posterior
   run with ``--vae-weights`` (a seeded random 16-channel decoder, float32):
   ``output_sd3_uc.png`` and ``output_sd3.png`` at 512x512, 2 x 19 GroupNorm
   pairs and the two decodes' D=512 attention on the wide route. (d)
   ``bench.py`` ``run_sd3``'s protocol through ``sample_flow_match_stepwise``
   (SD3-medium, batch 4, 16 steps, M=2 posterior on [8, 16), CFG 7.0, 77
   zero context tokens, bf16 latents), twice: images/s of the second run
   (information, not a benchmark cell).
14. The real text towers, SD 2.1 and the safety checker. (a) CLIP-L with
   projection (123.7M), CLIP-bigG (694.7M) and T5-XXL (4.76B) at full width
   (``T2ITowers("sd3", "full")``: seeded random float32 weights drawn on the
   card) on 77 pseudo token ids at batch 2: ``last_hidden``, ``penultimate``
   and ``pooled`` within rel L2 1e-4 of float32 on the CPU at batch 1, or,
   where the host's MemAvailable is under 2.5x T5's float32 bytes, T5 block
   by block within 1e-5 of float64 on the card (which one is printed); fails
   if TF32 is on for float32 matmuls. (b) The t2i CLI with no ``--device``:
   ``--model sd3 --text-towers full`` (gradient and posterior), ``--model
   flux --text-towers full`` (posterior), ``--model sd35 --text-towers
   small`` (posterior): the JAX CLI's file names, ``args.yaml`` with
   ``pseudo_text: false`` and ``pseudo_tokens`` as the towers found the
   tokenizers (true where no tokenizer files are in the local Hugging Face
   cache), two encodes of context / pooled [1, 154, 4096] / [1, 2048]
   (SD3, SD3.5) or [1, 77, 4096] / [1, 768] (Flux), every attention launch
   at the joint length 1178 or 1101 on the tensor-core route, calls x sites
   of them; the towers' build and encode seconds, guided and plain seconds,
   peak memory. (c) SD 2.1: the full-width bf16 UNet forward of the
   recording (batch 2, t=500, the CLI's 5 x 1024 context) against float32 on
   the CPU at batch 1 (rel L2 <= 2e-2 and at most 1e-3 above the plain
   versions), its launches a forward equal to SD 1.5's (GroupNorm,
   attention, ``attention_long``, interleave), every attention on the
   tensor-core route; then ``--model sd21`` at the CLI defaults in both
   branches (the RGBA latent grid, no GroupNorm pair) and posterior with
   ``--vae-weights`` (512x512 RGB, 2 x 19 pairs, 2 wide attentions). (d) The
   SD 1.5 CLI (posterior, ``--vae-weights``) with
   ``--safety-checker-weights``, a seeded random ViT-L/14 checker saved to a
   temporary folder: a first run with every threshold above 1 flags nothing;
   concept 0 is then set along the gap between the two images' embeddings,
   its threshold halfway, and the second run must flag the guided image
   (black) and not the plain one (``nsfw_flags.yaml``); the checker's image
   embeds on the card within rel L2 1e-4 of float32 on the CPU, and the
   CPU's flags equal to the CLI's.
15. ADM-128's other samplers and the timing and grid CLIs (the factory's
   ``imagenet128`` bundle, seeded random bf16 weights, batch 8). (a)
   ``sample_ddpm`` with ``learned_range`` on the model's raw 6-channel
   output, 10 steps, ``uncertainty_centered`` (M=5, folded) on the last 2,
   and (b) ``sample_kdpm2``, 10 steps: 12 and 20 model calls; each chain
   (sample, and 15a's maps) held to the same chain in float32 (the same
   weights, the plain versions, the same injected noise): rel L2 at most
   1e-3 above the same bf16 chain through the plain versions (the form of
   phase 5). (c) ``measure_times`` with no ``--device``, the ``bench.py``
   protocol (zigzag M=5 x3 on [40, 50) of 50 steps, ``--repeats 1``),
   ``--baseline kdpm2`` and then ``ddim``: both records printed, two records
   in ``times.json`` naming the card. (d) ``uncertainty_benchmark`` with no
   ``--device`` (the six estimator methods, 8 images, 20 steps, window [16,
   20)): six rows with a finite mean map and images/s above 0; then one
   short dataset-CLI run and ``summary_experiments``, whose one row must
   name it. Each run holds the ADM path: every kernel launched, attention
   on the tensor-core route, GroupNorm on one launch, 4 avg-pool and 4
   interleave launches an ADM call.

Every forward of phases 3, 5, 7, 9a, 10 and 11a must launch each kernel of its
model; each main path (phase 4, each run of phase 6, each run of phase 8, the
AUSE, NLL and dataset-CLI runs of phase 9, phase 10b, phases 11b and 11c,
each run of phase 12, each CLI run of phases 13 and 14, and each run of
phase 15) sets the launch counters to 0 just before and reads them just
after, and fails if a kernel of its path never launched. Each phase prints its seconds. The last two lines are the kernels
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
UVIT_BATCH = 8  # latents of the U-ViT main-path run (phase 10b)
UVIT_M = 5  # its zigzag members, folded into one forward of UVIT_M * UVIT_BATCH
UVIT_ATTENTION = 29  # attention launches of one U-ViT-huge forward: 14 + 1 + 14 blocks
CLF_BATCH = 8  # images of the classifier runs (phase 11), the guided run's batch
# launches of one forward of the ImageNet-128 noisy classifier (float32): 6
# attention blocks in the input levels, 1 in the middle and the pool, all
# D=64 on the CUDA-core route; 16 ResBlocks x 2 GroupNorms, 7 attention
# norms and the output norm; 4 down ResBlocks, each pooling a pair
CLF_FORWARD = {"attention": 8, "group_norm": 40, "avg_pool_2x2": 4}  # GroupNorm: calls on either route
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak
F32_FLOPS = 67e12  # float32 outside the tensor cores (the CUDA-core attention route)
# float32 attention on a main path (the VAE, D=512) takes the wide kernel,
# whose products are 3xTF32: three TF32 tensor-core products each
F32_ATTENTION_FLOPS, F32_ATTENTION_ARITH = 495e12 / 3, "3xTF32 (495/3 TFLOP/s)"
# the batch each model's shapes are checked at; the first is the main path's
CHECK_BATCHES = {"adm": (8, 2), "sd": (2,), "vae": (1,), "cifar": (CIFAR_BATCH,), "adm64": (ADM64_BATCH,),
                 "uvit": (UVIT_BATCH, UVIT_M * UVIT_BATCH), "uvae": (UVIT_BATCH,), "uvae512": (1,), "clf": (CLF_BATCH,),
                 "sd3": (2, 10), "sd35": (2, 10), "flux": (1, 5), "sd3_bench": (8,), "sd21": (2, 10),
                 "sd3_towers": (2, 10), "sd35_towers": (2, 10), "flux_towers": (1, 5)}
# the flow-matching transformers of phase 13 at the t2i CLI's defaults (a
# 512x512 image: 64x64x16 latents, 1024 image tokens and 16 pseudo-text
# tokens): (heads, head dim, attention sites a forward); each is held and
# timed in phase 2 at its plain (CFG) batch and its folded M=5 batch
FLOW_TOKENS = 1024 + 16
FLOW_MODELS = {"sd3": (24, 64, 24), "sd35": (38, 64, 38), "flux": (24, 128, 19 + 38)}
# the joint length with the real text towers (phase 14b): 1024 image tokens
# and 77 CLIP + 77 T5 tokens (SD3, SD3.5) or 77 T5 tokens (Flux)
FLOW_TOWER_TOKENS = {"sd3": 1024 + 154, "sd35": 1024 + 154, "flux": 1024 + 77}
# bench.py run_sd3's protocol (phase 13d): batch 4 (8 with CFG), 77 context tokens
SD3_BENCH = {"batch": 4, "steps": 16, "M": 2, "cfg": 7.0, "tokens": 77}
PAIRED = ("adm", "adm64", "clf")  # models whose forward resamples two tensors a launch
# the single form of the two resampling kernels, one tensor a launch
RESAMPLE_FORMS = {"avg_pool_2x2": "single", "interleave_2x": "phase"}
F32_MODELS = ("vae", "clf")  # models whose main path runs in float32 (the SD VAE decoder, the classifier)
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
SD_UNET_PATH = ("group_norm", "attention", "attention_long", "interleave_2x")  # without a decode
CIFAR_PATH = ("group_norm", "attention", "interleave_2x", "winograd")
# the U-ViT path: the transformer's attention and the bf16 VAE decode's
# kernels (at 256x256 output the 256-channel map takes the pair)
UVIT_PATH = ("group_norm", "gn_stats", "gn_apply", "attention")
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


# phase 15: ADM-128's samplers and the timing and grid CLIs. 15a: sample_ddpm
# (learned_range) with uncertainty_centered M=5 on the last 2 of 10 steps;
# 15b: sample_kdpm2, 10 steps (2 model calls a step)
P15_STEPS, P15_WINDOW, P15_M = 10, 2, 5
P15_LIMIT = 1e-3  # rel L2 above the plain versions', both against float32 (the form of phase 5)


def phase15(dev, card: str, wrapper_mods: dict, plains: dict, lap) -> dict:
    """Phase 15's records; each main-path run carries its launches."""
    import gc

    import numpy as np
    import torch

    from diffusion_uncertainty_torch import kernels
    from diffusion_uncertainty_torch.diffusion import SamplerConfig, sample_ddpm
    from diffusion_uncertainty_torch.diffusion.kdpm2 import KDPM2Config, sample_kdpm2
    from diffusion_uncertainty_torch.factory import instantiate_model_scheduler
    from diffusion_uncertainty_torch.models import ADMUNet
    from diffusion_uncertainty_torch.scripts import generate_dataset_score_uncertainty as dataset_cli
    from diffusion_uncertainty_torch.scripts import generate_starting_points, measure_times, summary_experiments
    from diffusion_uncertainty_torch.scripts import uncertainty_benchmark
    from diffusion_uncertainty_torch.uncertainty import EstimatorConfig, make_estimator
    from diffusion_uncertainty_torch.utils import TorchNoise, paths

    p15: dict = {}
    calls = [0]  # ADM-128 calls (forward pre-hooks)

    def hooked(bundle):
        bundle.model.register_forward_pre_hook(lambda module, args: calls.__setitem__(0, calls[0] + 1))
        return bundle

    def counted(tag, fn):
        """fn() between zeroed and read counters; fails unless every ADM
        kernel launched and attention stayed on the tensor-core route."""
        calls[0] = 0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        r = {"s": time.perf_counter() - t0, "launches": kernels.launch_counts(), "routes": kernels.route_counts(),
             "gn_routes": kernels.gn_route_counts(), "adm_calls": calls[0]}
        for name in ADM_PATH:
            if r["launches"][name] <= 0:
                fail(f"{tag}: kernel {name} was never launched")
        if r["routes"]["cuda_core"] or r["routes"]["tensor_core"] <= 0 or r["gn_routes"]["pair"]:
            fail(f"{tag}: attention routes {r['routes']}, GroupNorm routes {r['gn_routes']}: want tensor-core and one launch")
        for name in ("avg_pool_2x2", "interleave_2x"):
            if r["launches"][name] != ADM_RESAMPLE * calls[0]:
                fail(f"{tag}: {r['launches'][name]} {name} launches in {calls[0]} ADM calls, want {ADM_RESAMPLE} a call")
        print(f"[{tag}] kernels {json.dumps(r['launches'])}; {calls[0]} ADM calls; attention routes "
              f"{json.dumps(r['routes'])}", flush=True)
        return out, r

    def plain_run(fn):
        """fn() with every kernel wrapper replaced by its plain version."""
        kernels.reset_launch_counts()
        with PlainKernels(wrapper_mods, plains):
            out = fn()
        torch.cuda.synchronize()
        if any(kernels.launch_counts().values()):
            fail("phase 15: a plain-version run launched a kernel")
        return out

    # 15a-b: the samplers on ADM-128 at full width (seeded random bf16
    # weights, the model's raw 6-channel output), held to the same chain with
    # the plain versions and to float32 (the same weights, the plain versions)
    bundle = hooked(instantiate_model_scheduler("imagenet128", random_init=True, device=dev))
    model, sched = bundle.model, bundle.schedule
    with torch.device("meta"):
        model32 = ADMUNet(model.cfg)
    model32.load_state_dict({k: v.float() for k, v in model.state_dict().items()}, assign=True)
    model32 = model32.to(memory_format=torch.channels_last).eval().requires_grad_(False)
    g15 = torch.Generator(device=dev).manual_seed(SEED + 15)
    x_T = torch.randn(ADM_BATCH, 128, 128, 3, generator=g15, device=dev)
    y = torch.randint(0, 1000, (ADM_BATCH,), generator=g15, device=dev)
    scfg = SamplerConfig(num_inference_steps=P15_STEPS, after_step=P15_STEPS - P15_WINDOW, num_steps_uc=P15_WINDOW)
    est = make_estimator(EstimatorConfig(name="uncertainty_centered", M=P15_M))

    def ddpm(m):
        return sample_ddpm(lambda x, t, nz: m(x, t, y), sched, x_T, TorchNoise(SEED + 151, dev), scfg,
                           variance_type="learned_range", estimator=est,
                           estimator_model_fn=lambda x, t, nz: m(x, t, y)[..., :3])

    def kdpm2(m):
        return sample_kdpm2(lambda x, t, nz: m(x, t, y)[..., :3], sched, x_T, TorchNoise(SEED + 152, dev),
                            KDPM2Config(num_inference_steps=P15_STEPS))

    with torch.no_grad():  # cuDNN plans at both batches, outside the counted runs
        model(x_T, 999, y)
        model(x_T.repeat(P15_M, 1, 1, 1), 999, y.repeat(P15_M))
    for tag, run, n_calls in (("15a", ddpm, P15_STEPS + P15_WINDOW), ("15b", kdpm2, 2 * P15_STEPS)):
        res, r = counted(tag, lambda: run(model))
        if r["adm_calls"] != n_calls:
            fail(f"{tag}: {r['adm_calls']} model calls, want {n_calls}")
        res_p = plain_run(lambda: run(model))
        t0 = time.perf_counter()
        res_f = plain_run(lambda: run(model32))
        f32_s = time.perf_counter() - t0
        pairs = {"sample": (res.sample, res_p.sample, res_f.sample)}
        if tag == "15a":
            pairs["maps"] = (res.uncertainty, res_p.uncertainty, res_f.uncertainty)
            if tuple(res.uncertainty.shape) != (P15_WINDOW, ADM_BATCH, 128, 128, 3):
                fail(f"15a: maps {tuple(res.uncertainty.shape)}")
        rels = {}
        for what, (k, pl, f) in pairs.items():
            if not (bool(torch.isfinite(k.float()).all()) and tuple(k.shape) == tuple(f.shape)):
                fail(f"{tag} {what}: not finite, or shape {tuple(k.shape)} against {tuple(f.shape)}")
            rels[what] = {"kernels": rel_l2(k, f), "plain": rel_l2(pl, f), "kernels_vs_plain": rel_l2(k, pl)}
        name = "sample_ddpm (learned_range, centered M=5 on the last 2 steps)" if tag == "15a" else "sample_kdpm2"
        print(f"[{tag}] {name}, ADM-128, {P15_STEPS} steps, bf16, batch {ADM_BATCH}: {r['s']:.2f} s with the kernels "
              f"({r['adm_calls']} model calls) on {card}; against the same chain in float32 (plain versions, "
              f"{f32_s:.2f} s): " + "; ".join(f"{w} rel L2 {v['kernels']:.3e} (the plain versions {v['plain']:.3e}, "
                                              f"kernels against plain {v['kernels_vs_plain']:.3e})"
                                              for w, v in rels.items()) + f" (limit: plain + {P15_LIMIT})", flush=True)
        for what, v in rels.items():
            if not v["kernels"] <= v["plain"] + P15_LIMIT:
                fail(f"{tag} {what}: relative L2 error {v['kernels']} against float32 (plain versions {v['plain']}; "
                     f"limit plain + {P15_LIMIT})")
        p15[tag] = {**r, "rel_l2": rels, "float32_s": f32_s}
    del model, model32, bundle, res, res_p, res_f
    lap("15a-b")

    saved_root = os.environ.get("DIFFUSION_UNCERTAINTY_ROOT")
    saved_build = (measure_times.instantiate_model_scheduler, uncertainty_benchmark.instantiate_model_scheduler,
                   dataset_cli.instantiate_model_scheduler)
    hook_build = lambda *a, **kw: hooked(saved_build[0](*a, **kw))  # noqa: E731
    measure_times.instantiate_model_scheduler = uncertainty_benchmark.instantiate_model_scheduler = hook_build
    dataset_cli.instantiate_model_scheduler = hook_build
    try:
        with tempfile.TemporaryDirectory() as root:
            os.environ["DIFFUSION_UNCERTAINTY_ROOT"] = root
            # 15c: measure_times with no --device, the bench.py protocol, against each baseline
            protocol = ["--dataset", "imagenet128", "--random-init", "true", "--batch-size", str(ADM_BATCH),
                        "--scheduler-type", "uncertainty_zigzag_centered", "--M", "5", "--num-zigzag", "3",
                        "--generation-steps", "50", "--start-step-uc", "40", "--num-steps-uc", "10", "--repeats", "1"]
            for baseline in ("kdpm2", "ddim"):
                rec, r = counted(f"15c {baseline}", lambda: measure_times.main(protocol + ["--baseline", baseline]))
                print(f"[15c] measure_times --baseline {baseline}: {json.dumps(rec)}", flush=True)
                p15[f"measure_times_{baseline}"] = {**r, "record": rec}
            times = json.loads((paths.results() / "times.json").read_text())
            kind = torch.cuda.get_device_name(0)
            if [(t["baseline"], t["device"]) for t in times] != [("kdpm2", kind), ("ddim", kind)]:
                fail(f"15c: times.json holds {[(t['baseline'], t['device']) for t in times]}, want kdpm2 and ddim on {kind}")
            if not all(t[k] > 0 for t in times for k in ("overhead_x", "images_per_sec_uncertainty", "images_per_sec_plain")):
                fail(f"15c: records {times}")
            lap("15c")

            # 15d: the estimator grid with no --device, then summary_experiments
            # on the results folder (with one short dataset-CLI run in it)
            generate_starting_points.main(["--datasets", "imagenet128", "--num-samples", str(ADM_BATCH),
                                           "--extra-samples", "0"])
            rows, r = counted("15d", lambda: uncertainty_benchmark.main([
                "--dataset", "imagenet128", "--random-init", "true", "--num-samples", str(ADM_BATCH),
                "--batch-size", str(ADM_BATCH), "--generation-steps", "20", "--start-step-uc", "16",
                "--num-steps-uc", "4"]))
            for row in rows:
                print(f"[15d] uncertainty_benchmark {row['method']}: {json.dumps(row)}", flush=True)
            if ([row["method"] for row in rows] != list(uncertainty_benchmark.ESTIMATOR_METHODS)
                    or not all(math.isfinite(row["mean_uncertainty"]) and row["images_per_sec"] > 0 for row in rows)):
                fail(f"15d: rows {rows}")
            run, r_cli = counted("15d dataset CLI", lambda: dataset_cli.main([
                "--dataset", "imagenet128", "--random-init", "true", "--scheduler-type", "uncertainty_centered",
                "--num-samples", str(ADM_BATCH), "--batch-size", str(ADM_BATCH), "--M", "5", "--generation-steps", "10",
                "--start-step-uc", "8", "--num-steps-uc", "2"]))
            table = summary_experiments.main([])
            want = [run.name, "imagenet128", "uncertainty_centered", ADM_BATCH, 5, 10, 8, 2, 1]
            if table != [want]:
                fail(f"15d: summary_experiments rows {table}, want [{want}]")
            p15["uncertainty_benchmark"] = {**r, "rows": rows}
            p15["dataset_cli"] = {**r_cli, "summary": table}
    finally:
        measure_times.instantiate_model_scheduler, uncertainty_benchmark.instantiate_model_scheduler = saved_build[:2]
        dataset_cli.instantiate_model_scheduler = saved_build[2]
        if saved_root is None:
            os.environ.pop("DIFFUSION_UNCERTAINTY_ROOT", None)
        else:
            os.environ["DIFFUSION_UNCERTAINTY_ROOT"] = saved_root
    lap("15d")
    total = {k: sum(r["launches"][k] for r in p15.values()) for k in KERNELS}
    print(f"[15] launches of phase 15's paths: {json.dumps(total)}", flush=True)
    return p15


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
    from diffusion_uncertainty_torch.classifier_guidance import with_classifier_guidance
    from diffusion_uncertainty_torch.factory import instantiate_model_scheduler, load_classifier
    from diffusion_uncertainty_torch.models import ADMClassifier
    from diffusion_uncertainty_torch.ops import attention as ops_attention
    from diffusion_uncertainty_torch.models import ADMUNet, ADMUNetConfig, AutoencoderKL, SDUNet, UNet2D, UViT
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
    from diffusion_uncertainty_torch.scripts.generate_t2i_guided import build_sd_stack, init_random_
    from diffusion_uncertainty_torch.models import AutoencoderKLConfig
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

    # seeded random weight files that the CLI runs read (the SD VAE decoder:
    # without --vae-weights the SD CLI saves latents, as the JAX CLI does)
    work = tempfile.TemporaryDirectory()
    sd_vae_file = os.path.join(work.name, "sd_vae.pt")
    with torch.device("meta"):
        vae_meta = AutoencoderKL(AutoencoderKLConfig.sd_kl_ema())
    torch.save(init_random_(vae_meta.to_empty(device="cpu"), 1).state_dict(), sd_vae_file)
    del vae_meta
    stack = build_sd_stack(T2IConfig(random_init=True, vae_weights=sd_vae_file), device=dev)
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

    # SD 2.1 (2-1-base) as the t2i CLI builds it, at the CFG batch, with the
    # CLI's 5-token, 1024-wide pseudo conditioning (phase 14c)
    stack21 = build_sd_stack(T2IConfig(model="sd21", random_init=True), device=dev)
    xs21 = torch.randn(2, 64, 64, 4, generator=gen, device=dev).to(torch.bfloat16).float()
    ctx21 = torch.from_numpy(np.concatenate([pseudo_text_embeddings([p], seq_len=5, dim=1024)
                                             for p in ("a photo of a cat", "")])).to(dev).to(torch.bfloat16).float()
    with torch.no_grad():
        stack21.unet(xs21, 500, ctx21)  # cuBLAS plans, outside the timed call
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad(), Recorder(wrapper_mods) as rec_sd21:
        t0 = time.perf_counter()
        out_sd21 = stack21.unet(xs21, 500, ctx21)
        torch.cuda.synchronize()
        sd21_fwd_s = time.perf_counter() - t0
    sd21_fwd_counts, sd21_fwd_routes, sd21_gn_routes = kernels.launch_counts(), kernels.route_counts(), kernels.gn_route_counts()

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

    # the ImageNet-128 noisy classifier as the factory builds it for classifier
    # guidance (seeded random float32 weights): the guidance term, one forward
    # and one backward, at the guided run's batch (phase 11)
    clf = load_classifier("imagenet128", random_init=True, device=dev)
    n_clf = sum(p.numel() for p in clf.parameters())
    clf_sched = make_schedule("linear", 1000, device=dev)
    xcl = torch.randn(CLF_BATCH, 128, 128, 3, generator=gen, device=dev)
    ycl = torch.randint(0, 1000, (CLF_BATCH,), generator=gen, device=dev)

    def guidance_term(model, x, y, sched, t=500):
        """sqrt(1 - ab_t)·grad_x sum_b log p(y_b|x_b): the port's guided
        output around a zero eps, negated."""
        return -with_classifier_guidance(lambda *a: torch.zeros_like(x), model, sched, 1.0)(x, t, y, None)

    guidance_term(clf, xcl, ycl, clf_sched)  # cuDNN plans, outside the timed call
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with Recorder(wrapper_mods) as rec_clf:
        t0 = time.perf_counter()
        term_clf = guidance_term(clf, xcl, ycl, clf_sched)
        torch.cuda.synchronize()
        clf_s = time.perf_counter() - t0
    clf_counts, clf_routes, clf_gn_routes = kernels.launch_counts(), kernels.route_counts(), kernels.gn_route_counts()
    clf_resample = kernels.resample_counts()

    # U-ViT-huge/2 and /4 with their bf16 VAE as the factory builds them for
    # the dataset CLI (seeded random weights): the /2 forward at the main
    # path's batch and its decode of those latents, the /4 forward at batch 2
    # and one decode of a 64x64 latent (phase 10); latents rounded to bf16 so
    # the CPU reference sees the card's inputs
    uvit = instantiate_model_scheduler("imagenet256", random_init=True, device=dev)
    n_uvit = sum(p.numel() for p in uvit.model.parameters())
    zu = torch.randn(UVIT_BATCH, *uvit.sample_shape, generator=gen, device=dev).to(torch.bfloat16).float()
    yu = torch.randint(0, 1000, (UVIT_BATCH,), generator=gen, device=dev)
    with torch.no_grad():
        uvit.model(zu, 500, yu)  # cuBLAS plans, outside the timed call
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad(), Recorder(wrapper_mods) as rec_uvit:
        t0 = time.perf_counter()
        out_uvit = uvit.model(zu, 500, yu)
        torch.cuda.synchronize()
        uvit_fwd_s = time.perf_counter() - t0
    uvit_counts, uvit_routes = kernels.launch_counts(), kernels.route_counts()
    kernels.reset_launch_counts()
    with torch.no_grad(), Recorder(wrapper_mods) as rec_uvae:
        t0 = time.perf_counter()
        img_u = uvit.decode_fn(zu)
        torch.cuda.synchronize()
        uvae_s = time.perf_counter() - t0
    uvae_counts, uvae_routes, uvae_gn_routes = kernels.launch_counts(), kernels.route_counts(), kernels.gn_route_counts()
    uvit512 = instantiate_model_scheduler("imagenet512", random_init=True, device=dev)
    z512 = torch.randn(2, *uvit512.sample_shape, generator=gen, device=dev).to(torch.bfloat16).float()
    y512 = torch.randint(0, 1000, (2,), generator=gen, device=dev)
    with torch.no_grad():
        uvit512.model(z512, 500, y512)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        out_uvit512 = uvit512.model(z512, 500, y512)
        torch.cuda.synchronize()
        uvit512_fwd_s = time.perf_counter() - t0
    uvit512_counts, uvit512_routes = kernels.launch_counts(), kernels.route_counts()
    kernels.reset_launch_counts()
    with torch.no_grad(), Recorder(wrapper_mods) as rec_uvae512:
        t0 = time.perf_counter()
        img512 = uvit512.decode_fn(z512[:1])
        torch.cuda.synchronize()
        uvae512_s = time.perf_counter() - t0
    uvae512_counts, uvae512_routes = kernels.launch_counts(), kernels.route_counts()
    uvae512_gn_routes = kernels.gn_route_counts()
    lap("recording forwards")

    # ---- phase 2: every kernel against its plain version -----------------
    sets = {"adm": shape_sets(rec_adm.sigs), "sd": shape_sets(rec_sd.sigs), "vae": shape_sets(rec_vae.sigs),
            "cifar": shape_sets(rec_cifar.sigs), "adm64": shape_sets(rec_adm64.sigs), "uvit": shape_sets(rec_uvit.sigs),
            "uvae": shape_sets(rec_uvae.sigs), "uvae512": shape_sets(rec_uvae512.sigs), "clf": shape_sets(rec_clf.sigs)}
    # the joint attention of the flow-matching transformers (q, k, v made by
    # concatenating the image and text streams): phase 13 records each
    # forward and fails unless it makes exactly these shapes
    for m, (heads, d, _) in FLOW_MODELS.items():
        sets[m] = shape_sets([("attention", (FLOW_TOKENS, FLOW_TOKENS, heads, d, "separate", None))])
    # the same with the real text towers' conditioning (phase 14b)
    for m, n_tok in FLOW_TOWER_TOKENS.items():
        heads, d, _ = FLOW_MODELS[m]
        sets[f"{m}_towers"] = shape_sets([("attention", (n_tok, n_tok, heads, d, "separate", None))])
    sets["sd21"] = shape_sets(rec_sd21.sigs)
    n_bench = 1024 + SD3_BENCH["tokens"]
    sets["sd3_bench"] = shape_sets([("attention", (n_bench, n_bench, 24, 64, "separate", None))])
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
        # in the type the model's main path runs attention in: bf16, float32
        # for the SD VAE decoder and the classifier
        if bf16 != (src in F32_MODELS):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            times = {"ms": device_ms(lambda: katt.attention(q, k, v, kv_len)),
                     "plain_ms": device_ms(lambda: katt.attention_plain(q, k, v, kv_len)),
                     "library_ms": device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))}
            if not bf16:  # the wide route's products are 3xTF32, the CUDA-core route's float32 FMAs
                rate, arith = (F32_FLOPS, "float32 CUDA cores (67 TFLOP/s)") if route == "cuda_core" else \
                    (F32_ATTENTION_FLOPS, F32_ATTENTION_ARITH)
                extra = {"sdpa_backend": sdpa_backend(qt, kt, vt), "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                         "bound_rate": arith}
        n_keys = s_kv if kv_len is None else kv_len
        es = q.element_size()
        n_bytes = (2 * batch * s * heads * d + 2 * batch * n_keys * heads * d) * es
        note(name, e, src, batch, dtype, [batch, s, s_kv, heads, d, layout], tol, times, n_bytes,
             4.0 * batch * heads * s * n_keys * d, rate, plain_max=ref_max, rel_l2=rel, route=route, **extra)

    def resample_times(kind, form, shape, dtype=torch.bfloat16):
        """(times, bytes moved, extras) of one form at one shape (bench_resample)."""
        r = measure(kpool, kilv, kind, form, shape, gen, clocks, dtype)
        times = {k: r[k] for k in ("ms", "plain_ms", "library_ms", "device_only_ms", "host_us")}
        return times, BOUND_INPUTS[(kind, form)] * math.prod(shape) * dtype.itemsize, {"route": r["route"], "form": form}

    def pool_checks(src, batch, h, w, c):
        dtype = torch.float32 if src in F32_MODELS else torch.bfloat16  # the type the model pools in
        x, y = rnd(batch, h, w, c, dtype=dtype), rnd(batch, h, w, c, dtype=dtype)
        kernels.reset_launch_counts()
        got = (kpool.avg_pool_2x2(x), *kpool.avg_pool_2x2_pair(x, y))
        route = "+".join(r for r, n in kernels.resample_counts()["avg_pool_2x2"].items() if n)
        e = 0.0
        for g, ref in zip(got, (kpool.avg_pool_2x2_plain(x), *kpool.avg_pool_2x2_pair_plain(x, y))):
            diff = (g.float() - ref.float()).abs()
            ulp = bf16_ulp(ref) * (1.0 if dtype == torch.bfloat16 else 2.0**-16)
            if not bool((diff <= ulp).all()):
                fail(f"avg_pool_2x2 ({route}) disagrees by more than 1 ulp at {(src, batch, h, w, c, dtype)}")
            e = max(e, float(diff.max()))
        main = "pair" if src in PAIRED else "single"
        for form in ("single", "pair") if src in PAIRED else ("single",):
            times, nbytes, extra = resample_times("pool", form, (batch, h, w, c), dtype)
            note("avg_pool_2x2", e, src, batch, dtype, [batch, h, w, c, form], "1 ulp", times, nbytes, 0.0,
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
    cli = T2IConfig(random_init=True, vae_weights=sd_vae_file)
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

    def extractor_weights(root):
        """Seeded random Inception and VGG16 state dicts saved under root."""
        weights = {arch: os.path.join(root, f"{arch}.pth") for arch in ("inception", "vgg16")}
        for arch, path in weights.items():
            torch.save(random_state_dict(arch, seed=SEED), path)
        return weights

    def fid_and_pr(dataset, run, n_real, weights):
        """compute_fid stats (n_real synthetic images) and drop, then
        compute_precision_recall real and generated, on a dataset-CLI run:
        (scores, FID s, P&R s); fails unless every score is finite and P and
        R lie in [0, 1]."""
        common = ["--dataset", dataset, "--batch-size", "16"]
        drop = ["--run-dir", str(run), "--drop-fraction", "0.25"]
        t0 = time.perf_counter()
        compute_fid.main(common + ["--mode", "stats", "--num-samples", str(n_real), "--inception-weights", weights["inception"]])
        fids = compute_fid.main(common + ["--mode", "drop", "--inception-weights", weights["inception"]] + drop)
        fid_s = time.perf_counter() - t0
        compute_precision_recall.main(common + ["--mode", "real", "--num-samples", str(n_real), "--vgg-weights", weights["vgg16"]])
        pr = compute_precision_recall.main(common + ["--mode", "generated", "--k", "3", "--vgg-weights", weights["vgg16"]] + drop)
        pr_s = time.perf_counter() - t0 - fid_s
        scores = {k: fids[k] for k in ("fid_drop_most", "fid_drop_random")}
        scores.update({k: pr[k] for k in ("precision_drop_most", "recall_drop_most", "precision_drop_random",
                                          "recall_drop_random")})
        if not all(math.isfinite(v) for v in scores.values()):
            fail(f"metrics: a non-finite score {scores}")
        if not all(0.0 <= v <= 1.0 for k, v in scores.items() if not k.startswith("fid")):
            fail(f"metrics: precision or recall outside [0, 1]: {scores}")
        return scores, fid_s, pr_s

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
        weights = extractor_weights(root)
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
        scores, fid_s, pr_s = fid_and_pr("imagenet64", run, n_img, weights)
        print(f"[9d] FID stats + drop ({n_img} real, {n_img} generated, 25% dropped; {fid_s:.1f} s) and precision/recall "
              f"real + generated (k=3; {pr_s:.1f} s): {json.dumps(scores)}", flush=True)
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

    # ---- phase 10: U-ViT (BASELINE config 4) ------------------------------
    def check_uvit_forward(tag, bundle, z, y, out, counts, routes, fwd_s):
        """A full-width U-ViT forward of the recording run: 29 attention
        launches, all tensor-core; image 0 against float32 on the CPU and the
        plain versions on the card."""
        if counts["attention"] != UVIT_ATTENTION or routes["tensor_core"] != UVIT_ATTENTION or routes["cuda_core"]:
            fail(f"{tag} forward: attention launches {counts['attention']} by route {routes}, want "
                 f"{UVIT_ATTENTION} on the tensor-core route")
        if not bool(torch.isfinite(out).all()):
            fail(f"{tag} forward: non-finite output on the card")
        t0 = time.perf_counter()
        with torch.device("meta"):
            cpu_model = UViT(bundle.model.cfg)
        cpu_model.load_state_dict({k: v.float().cpu() for k, v in bundle.model.state_dict().items()}, assign=True)
        with torch.no_grad():
            ref = cpu_model.eval()(z[:1].cpu(), 500, y[:1].cpu())
        cpu_s = time.perf_counter() - t0
        del cpu_model
        with torch.no_grad(), PlainKernels(wrapper_mods, plains):
            plain_rel = rel_l2(bundle.model(z[:1], 500, y[:1]), ref)
        rel = rel_l2(out[:1], ref)
        n = sum(p.numel() for p in bundle.model.parameters())
        print(f"[10] {tag} forward ({n / 1e6:.1f}M params, bf16, batch {z.shape[0]}): {fwd_s:.3f} s; image 0 vs float32 "
              f"CPU (batch 1, {cpu_s:.1f} s): rel L2 {rel:.3e} (the plain versions on the card: {plain_rel:.3e}; limits "
              f"2e-2 and plain + 1e-3); attention routes {json.dumps(routes)}", flush=True)
        if not (rel <= 2e-2 and rel <= plain_rel + 1e-3):
            fail(f"{tag} forward: relative L2 error {rel} (plain versions {plain_rel}; limits 2e-2 and plain + 1e-3)")
        return {"params": n, "first_call_s": fwd_s, "rel_l2": rel, "plain_rel_l2": plain_rel, "launches": counts,
                "routes": routes}

    # 10a: U-ViT-huge/2 of the recording run
    uvit_runs = {"uvit256 forward": check_uvit_forward("U-ViT-256", uvit, zu, yu, out_uvit, uvit_counts, uvit_routes,
                                                       uvit_fwd_s)}
    # 10b: the dataset CLI's main path through its functions, decoded by the bf16 VAE
    saved_root = os.environ.get("DIFFUSION_UNCERTAINTY_ROOT")
    with tempfile.TemporaryDirectory() as root:
        os.environ["DIFFUSION_UNCERTAINTY_ROOT"] = root
        generate_starting_points.main(["--datasets", "imagenet256", "--num-samples", str(UVIT_BATCH), "--extra-samples", "0"])
        x_t, y_t = dataset_cli.load_starting_points("imagenet256", 0, UVIT_BATCH)
    if saved_root is None:
        os.environ.pop("DIFFUSION_UNCERTAINTY_ROOT", None)
    else:
        os.environ["DIFFUSION_UNCERTAINTY_ROOT"] = saved_root
    apply_fn, _ = dataset_cli.select_apply_fn(uvit, "uncertainty_zigzag_centered")
    forwards = [0]

    def counted(x, t, y, noise):
        forwards[0] += 1
        return apply_fn(x, t, y, noise)

    with torch.no_grad():  # cuBLAS plans at the folded ensemble's batch
        apply_fn(zu.repeat(UVIT_M, 1, 1, 1), 999, yu, None)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = generate_uncertainty_dataset(
        counted, uvit.schedule, SamplerConfig(num_inference_steps=50, after_step=40, num_steps_uc=10), x_t, y_t,
        UVIT_BATCH, seed=SEED,
        estimator=make_estimator(EstimatorConfig(name="uncertainty_zigzag_centered", M=UVIT_M, num_zigzag=3)),
        decode_fn=uvit.decode_fn,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes, gn_routes = kernels.launch_counts(), kernels.route_counts(), kernels.gn_route_counts()
    print(f"[10b] kernels {json.dumps(counts)} over {forwards[0]} forwards and 1 decode; attention routes "
          f"{json.dumps(routes)}; GroupNorm routes {json.dumps(gn_routes)}", flush=True)
    check_counts(counts, UVIT_PATH, "U-ViT main path")
    if routes["cuda_core"] or routes["tensor_core"] != UVIT_ATTENTION * forwards[0] or routes["wide"] != 1:
        fail(f"U-ViT main path: attention routes {routes}: want {UVIT_ATTENTION} tensor-core launches a forward "
             f"({forwards[0]} forwards), the decode's on the wide route, none on the CUDA-core route")
    if gn_routes["pair"] != uvae_gn_routes["pair"]:
        fail(f"U-ViT main path: GroupNorm routes {gn_routes}: the pair only for one decode's {uvae_gn_routes['pair']}")
    imgs, u = res.gen_images, res.uncertainty
    if imgs.shape != (UVIT_BATCH, 256, 256, 3) or imgs.dtype != np.uint8:
        fail(f"U-ViT main path: images {imgs.shape} {imgs.dtype}, want ({UVIT_BATCH}, 256, 256, 3) uint8")
    if u.shape != (UVIT_BATCH, 10, 32, 32, 4) or not bool(np.isfinite(u).all()):
        fail(f"U-ViT main path: uncertainty {u.shape}, finite {bool(np.isfinite(u).all())}")
    um = float(u.mean())
    if not um > 0:
        fail(f"U-ViT main path: uncertainty mean {um}")
    ips = UVIT_BATCH / wall
    print(f"[10b] U-ViT-256 main path (dataset CLI functions): zigzag M={UVIT_M} x3, 50 DDIM steps, window [40, 50), "
          f"bf16, batch {UVIT_BATCH}, bf16 VAE decode: {wall:.2f} s, {ips:.4f} images/s on {card} (information, not a "
          f"claim); images {imgs.shape}, uncertainty mean {um:.4e}", flush=True)
    uvit_runs["main path"] = {"s": wall, "images_per_s": ips, "forwards": forwards[0], "launches": counts,
                              "routes": routes, "gn_routes": gn_routes, "uncertainty_mean": um}
    del res
    # 10c: U-ViT-huge/4 of the recording run, and its bf16 decode of a 64x64 latent
    uvit_runs["uvit512 forward"] = check_uvit_forward("U-ViT-512", uvit512, z512, y512, out_uvit512, uvit512_counts,
                                                      uvit512_routes, uvit512_fwd_s)
    if tuple(img512.shape) != (1, 512, 512, 3) or not bool(torch.isfinite(img512).all()):
        fail(f"U-ViT-512 decode: image {tuple(img512.shape)}, finite {bool(torch.isfinite(img512).all())}")
    if (uvae512_counts["attention_long"] != 1 or uvae512_routes["wide"] != 1 or uvae512_routes["cuda_core"]
            or uvae512_routes["tensor_core"]):
        fail(f"U-ViT-512 decode: its D=512 attention must take the wide route once: {uvae512_counts} {uvae512_routes}")
    gn512 = [sig for name, sig in rec_uvae512.sigs if name == "group_norm"]
    pair512 = [sig for sig in gn512 if kgn.route(1, sig[0] * sig[1], sig[2], sig[3], 2)[0] == "pair"]
    if any(sig[0] * sig[1] >= 512 * 512 and sig not in pair512 for sig in gn512) or not pair512:
        fail(f"U-ViT-512 decode: a GroupNorm over a 512x512 map is routed to one launch: {gn512}")
    if uvae512_gn_routes != {"one_launch": len(gn512) - len(pair512), "pair": len(pair512)}:
        fail(f"U-ViT-512 decode: GroupNorm routes {uvae512_gn_routes}, expected {len(pair512)} pair of {len(gn512)}")
    print(f"[10c] U-ViT-512 bf16 decode (64x64 latent, batch 1): {uvae512_s:.3f} s first call; kernels "
          f"{json.dumps(uvae512_counts)}; attention routes {json.dumps(uvae512_routes)}; GroupNorm routes "
          f"{json.dumps(uvae512_gn_routes)} (pair at {sorted(set(pair512))})", flush=True)
    if tuple(img_u.shape) != (UVIT_BATCH, 256, 256, 3) or not bool(torch.isfinite(img_u).all()):
        fail(f"U-ViT-256 decode: images {tuple(img_u.shape)}, finite {bool(torch.isfinite(img_u).all())}")
    print(f"[10] U-ViT-256 bf16 decode (32x32 latents, batch {UVIT_BATCH}): {uvae_s:.3f} s first call; kernels "
          f"{json.dumps(uvae_counts)}; attention routes {json.dumps(uvae_routes)}; GroupNorm routes "
          f"{json.dumps(uvae_gn_routes)}", flush=True)
    uvit_runs["decodes"] = {"uvae_first_call_s": uvae_s, "uvae_launches": uvae_counts, "uvae_gn_routes": uvae_gn_routes,
                            "uvae512_first_call_s": uvae512_s, "uvae512_launches": uvae512_counts,
                            "uvae512_gn_routes": uvae512_gn_routes}
    details.update(uvit_runs=uvit_runs, uvit_params=n_uvit)
    del uvit, uvit512
    lap(10)

    # ---- phase 11: classifier guidance (BASELINE config 3) and ADM w/ 2-DPM --
    # 11a: the classifier's guidance term of the recording run (one forward
    # and one backward at batch 8) against float32 on the CPU
    clf_calls = {"attention": clf_counts["attention"], "group_norm": sum(clf_gn_routes.values()),
                 "avg_pool_2x2": clf_counts["avg_pool_2x2"]}
    if clf_calls != CLF_FORWARD:
        fail(f"classifier: kernel calls a forward {clf_calls}, want {CLF_FORWARD}: {clf_counts}")
    if clf_routes["cuda_core"] != CLF_FORWARD["attention"] or clf_resample["avg_pool_2x2"]["pair"] != CLF_FORWARD["avg_pool_2x2"]:
        fail(f"classifier: attention routes {clf_routes}, avg-pool {clf_resample['avg_pool_2x2']}: want "
             f"{CLF_FORWARD['attention']} CUDA-core launches and {CLF_FORWARD['avg_pool_2x2']} pairs")
    with torch.no_grad():
        logits_clf = clf(xcl, 500)
    if not (bool(torch.isfinite(term_clf).all()) and bool(torch.isfinite(logits_clf).all()) and float(term_clf.abs().max()) > 0):
        fail(f"classifier: the guidance term is not finite and non-zero (max |term| {float(term_clf.abs().max())})")
    t0 = time.perf_counter()
    with torch.device("meta"):
        cpu_clf = ADMClassifier(clf.cfg)
    cpu_clf.load_state_dict({k: v.cpu() for k, v in clf.state_dict().items()}, assign=True)
    cpu_clf.eval()
    x_cpu = xcl.cpu()
    with torch.no_grad():
        ref_logits = cpu_clf(x_cpu, 500)
    ref_term = guidance_term(cpu_clf, x_cpu, ycl.cpu(), make_schedule("linear", 1000, device="cpu"))
    clf_cpu_s = time.perf_counter() - t0
    del cpu_clf
    with torch.no_grad(), PlainKernels(wrapper_mods, plains):
        plain_logits = clf(xcl, 500)
    with PlainKernels(wrapper_mods, plains):
        plain_term = guidance_term(clf, xcl, ycl, clf_sched)
    clf_rel = {"logits": rel_l2(logits_clf, ref_logits), "term": rel_l2(term_clf, ref_term),
               "plain_logits": rel_l2(plain_logits, ref_logits), "plain_term": rel_l2(plain_term, ref_term)}
    clf_ms = device_ms(lambda: guidance_term(clf, xcl, ycl, clf_sched), reps=3, inner=3)
    print(f"[11a] ImageNet-128 classifier ({n_clf / 1e6:.1f}M params, float32, batch {CLF_BATCH}): guidance term "
          f"(forward + backward) {clf_s:.3f} s first timed call, {clf_ms:.3f} ms (CUDA events around 3 calls) on {card}; "
          f"vs float32 CPU (batch {CLF_BATCH}, {clf_cpu_s:.1f} s): logits rel L2 {clf_rel['logits']:.3e} (limit 1e-4), "
          f"term rel L2 {clf_rel['term']:.3e} (limit 1e-3); the plain versions on the card: {clf_rel['plain_logits']:.3e}, "
          f"{clf_rel['plain_term']:.3e}", flush=True)
    print(f"[11a] kernels a forward {json.dumps(clf_counts)}; attention routes {json.dumps(clf_routes)}; GroupNorm routes "
          f"{json.dumps(clf_gn_routes)}; avg-pool {json.dumps(clf_resample['avg_pool_2x2'])}", flush=True)
    if not (clf_rel["logits"] <= 1e-4 and clf_rel["term"] <= 1e-3):
        fail(f"classifier against float32 on the CPU: {clf_rel}")
    guided_runs = {"classifier": {"params": n_clf, "first_call_s": clf_s, "term_ms": clf_ms, **clf_rel,
                                  "launches": clf_counts, "routes": clf_routes, "gn_routes": clf_gn_routes}}
    del clf

    adm_per_forward = adm_fwd_counts["attention"]  # tensor-core launches of one ADM-128 forward (phase 3)
    calls = {"adm": [0, 0], "guided": 0, "attention_bwd": 0}  # ADM calls and member forwards, guided calls, backwards
    saved = dataset_cli.instantiate_model_scheduler, dataset_cli.with_classifier_guidance, ops_attention.attention_bwd
    saved_gen = dataset_cli.generate_uncertainty_dataset

    def counted_bundle(*a, **kw):
        bundle = saved[0](*a, **kw)

        def hook(module, args):
            calls["adm"][0] += 1
            calls["adm"][1] += args[0].shape[0] // CLF_BATCH

        bundle.model.register_forward_pre_hook(hook)
        return bundle

    def counted_guidance(*a, **kw):
        guided = saved[1](*a, **kw)

        def call(*args):
            calls["guided"] += 1
            return guided(*args)

        return call

    def counted_bwd(*a, **kw):
        calls["attention_bwd"] += 1
        return saved[2](*a, **kw)

    gen_s = [0.0]

    def timed_generation(*a, **kw):  # the span the CLI times itself
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved_gen(*a, **kw)
        torch.cuda.synchronize()
        gen_s[0] = time.perf_counter() - t0
        return out

    def cli_run(tag, argv):
        """One run of the dataset CLI (no --device) between zeroed and read counters."""
        calls.update(adm=[0, 0], guided=0, attention_bwd=0)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        run = dataset_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, routes, gn_routes = kernels.launch_counts(), kernels.route_counts(), kernels.gn_route_counts()
        u = load_run_arrays(run, "uncertainty")
        imgs = load_run_arrays(run, "gen_images")
        r = {"run": str(run), "s": wall, "generation_s": gen_s[0], "images_per_s": len(imgs) / gen_s[0],
             "adm_calls": calls["adm"][0], "adm_forwards": calls["adm"][1], "guided_calls": calls["guided"],
             "attention_backwards": calls["attention_bwd"], "launches": counts, "routes": routes, "gn_routes": gn_routes,
             "uncertainty_shape": list(u.shape), "uncertainty_mean": float(u.mean())}
        print(f"[{tag}] kernels {json.dumps(counts)}; attention routes {json.dumps(routes)}; GroupNorm routes "
              f"{json.dumps(gn_routes)}; {r['adm_calls']} ADM calls ({r['adm_forwards']} forwards of batch {CLF_BATCH}), "
              f"{r['guided_calls']} guided calls, {r['attention_backwards']} attention backwards", flush=True)
        if not (imgs.shape == (CLF_BATCH, 128, 128, 3) and u.shape == (CLF_BATCH, 10, 128, 128, 3)
                and bool(np.isfinite(u).all()) and u.mean() > 0):
            fail(f"{tag}: images {imgs.shape}, uncertainty {u.shape}, finite {bool(np.isfinite(u).all())}, mean {u.mean()}")
        if routes["tensor_core"] != adm_per_forward * r["adm_calls"]:
            fail(f"{tag}: {routes['tensor_core']} tensor-core attention launches, want {adm_per_forward} a call of ADM-128 "
                 f"({r['adm_calls']} calls)")
        return run, r

    dataset_cli.instantiate_model_scheduler, dataset_cli.with_classifier_guidance = counted_bundle, counted_guidance
    ops_attention.attention_bwd, dataset_cli.generate_uncertainty_dataset = counted_bwd, timed_generation
    saved_root = os.environ.get("DIFFUSION_UNCERTAINTY_ROOT")
    try:
        with tempfile.TemporaryDirectory() as root:
            os.environ["DIFFUSION_UNCERTAINTY_ROOT"] = root
            generate_starting_points.main(["--datasets", "imagenet128", "--num-samples", str(CLF_BATCH), "--extra-samples", "0"])
            cli = ["--dataset", "imagenet128", "--random-init", "true", "--M", "5", "--generation-steps", "50",
                   "--start-step-uc", "40", "--num-steps-uc", "10", "--batch-size", str(CLF_BATCH),
                   "--num-samples", str(CLF_BATCH)]
            # 11b: BASELINE config 3, the guided zigzag run, then its FID and precision/recall
            run, r = cli_run("11b", cli + ["--classifier-scale", "1.0", "--scheduler-type", "uncertainty_zigzag_centered",
                                           "--num-zigzag", "3"])
            check_counts(r["launches"], ADM_PATH, "guided run")
            if (r["guided_calls"] != 50 or r["routes"]["cuda_core"] != CLF_FORWARD["attention"] * 50
                    or r["attention_backwards"] != CLF_FORWARD["attention"] * 50 or r["adm_forwards"] != 200
                    or r["adm_calls"] != 80):
                fail(f"guided run: {r['guided_calls']} classifier forwards and backwards ({r['routes']['cuda_core']} "
                     f"CUDA-core attention launches, {r['attention_backwards']} attention backwards) and "
                     f"{r['adm_forwards']} ADM forwards in {r['adm_calls']} calls; want 50 ({8 * 50}, {8 * 50}) and 200 "
                     f"in 80")
            n_real = 4 * CLF_BATCH
            scores, fid_s, pr_s = fid_and_pr("imagenet128", run, n_real, extractor_weights(root))
            records = (paths.results() / "fid_scores.json").exists() and (paths.results() / "precision_recall.json").exists()
            print(f"[11b] BASELINE config 3 (ADM-128 guided by the float32 classifier at scale 1.0, zigzag M=5 x3, 50 DDIM "
                  f"steps, window [40, 50), bf16, batch {CLF_BATCH}, dataset CLI): {r['generation_s']:.2f} s sampling, "
                  f"{r['images_per_s']:.4f} images/s on {card} ({r['s']:.2f} s with the set-up); uncertainty mean "
                  f"{r['uncertainty_mean']:.4e}; FID stats + drop ({n_real} synthetic real, {CLF_BATCH} generated, 25% "
                  f"dropped; {fid_s:.1f} s) and precision/recall (k=3; {pr_s:.1f} s): {json.dumps(scores)}; records "
                  f"written {records}", flush=True)
            if not records:
                fail("guided run metrics: the FID or precision/recall record was not written")
            guided_runs["guided"] = {**r, **scores, "fid_s": fid_s, "pr_s": pr_s}

            # 11c: ADM w/ 2-DPM, the centered estimator on DPM-Solver++
            run, r = cli_run("11c", cli + ["--scheduler-type", "dpm_2_uncertainty_centered"])
            check_counts(r["launches"], ADM_PATH, "DPM run")
            check_tc_routes(r["routes"], "DPM run")
            if r["adm_forwards"] != 100 or r["adm_calls"] != 60:
                fail(f"DPM run: {r['adm_forwards']} ADM forwards in {r['adm_calls']} calls, want 100 in 60 (50 trajectory, "
                     f"10 folded M=5 ensembles)")
            print(f"[11c] ADM w/ 2-DPM (DPM-Solver++ order 2, 50 steps, centered M=5 on [40, 50), bf16, batch {CLF_BATCH}, "
                  f"dataset CLI): {r['generation_s']:.2f} s sampling, {r['images_per_s']:.4f} images/s on {card} "
                  f"({r['s']:.2f} s with the set-up); maps {r['uncertainty_shape']}, mean {r['uncertainty_mean']:.4e}",
                  flush=True)
            guided_runs["dpm"] = r
    finally:
        dataset_cli.instantiate_model_scheduler, dataset_cli.with_classifier_guidance = saved[:2]
        ops_attention.attention_bwd, dataset_cli.generate_uncertainty_dataset = saved[2], saved_gen
        if saved_root is None:
            os.environ.pop("DIFFUSION_UNCERTAINTY_ROOT", None)
        else:
            os.environ["DIFFUSION_UNCERTAINTY_ROOT"] = saved_root
    details.update(guided_runs=guided_runs)
    lap(11)

    # ---- phase 12: the remaining estimators and guidances on ADM-128 ---------
    import diffusion_uncertainty_torch.ops.attention as op_att
    import diffusion_uncertainty_torch.ops.avgpool as op_pool
    import diffusion_uncertainty_torch.ops.fused_upsample as op_up
    import diffusion_uncertainty_torch.ops.groupnorm as op_gn
    from diffusion_uncertainty_torch.diffusion import DiffusionConfig, StepState, ddim_step
    from diffusion_uncertainty_torch.diffusion.sampler import _recompute_prev
    from diffusion_uncertainty_torch.scripts import generate_guided
    from diffusion_uncertainty_torch.uncertainty import guidance as guid_mod

    # the ops' autograd backwards of the ADM path, counted as they run
    bwd_ops = {"group_norm": op_gn._GroupNorm, "attention": op_att._Attention, "avg_pool_2x2": op_pool._AvgPoolPair,
               "interleave_2x": op_up._InterleaveUpsample}
    bwd_calls = dict.fromkeys(bwd_ops, 0)
    saved_bwd = {k: cls.backward for k, cls in bwd_ops.items()}

    def counted_backward(name):
        def backward(ctx, *grads):
            bwd_calls[name] += 1
            return saved_bwd[name](ctx, *grads)

        return staticmethod(backward)

    gg_saved = generate_guided.instantiate_model_scheduler, generate_guided.generate_uncertainty_dataset
    gg_build = generate_guided.build_guidance
    gg_images, extractors, gg_moves = [], [], []
    saved_ext = compute_fid.make_extractor

    def gg_generation(*a, **kw):
        out = gg_saved[1](*a, **kw)
        gg_images.append(out.gen_images)
        return out

    def moved_guidance(cfg):
        """The CLI's guidance, noting for each window step how far the guided
        x_{t-1} lies from the plain DDIM x_{t-1} of the same x_t (float32 rel
        L2), beside the rounding floor: x_{t-1} re-derived from the unguided
        epsilon by the guidance's own formula."""
        g = gg_build(cfg)

        def apply(model_fn, schedule, state, noise, aux):
            x_next, u, aux = g.apply(model_fn, schedule, state, noise, aux)
            plain = state.prev_sample.float()
            floor = rel_l2(_recompute_prev(schedule, state, state.pred_epsilon.float(), DiffusionConfig(eta=cfg.eta)), plain)
            gg_moves.append((rel_l2(x_next, plain), floor))
            return x_next, u, aux

        return guid_mod.Guidance(g.init, apply)

    def recorded_extractor(cfg):
        ext = saved_ext(cfg)
        extractors.append(f"{type(ext).__name__} (dim {ext.dim})")
        return ext

    def counted(tag, fn):
        """fn() between zeroed and read counters: (its value, the run's record)."""
        calls.update(adm=[0, 0], guided=0, attention_bwd=0)
        bwd_calls.update(dict.fromkeys(bwd_calls, 0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        r = {"s": time.perf_counter() - t0, "launches": kernels.launch_counts(), "routes": kernels.route_counts(),
             "gn_routes": kernels.gn_route_counts(), "adm_calls": calls["adm"][0], "adm_forwards": calls["adm"][1],
             "backwards": dict(bwd_calls), "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        check_counts(r["launches"], ADM_PATH, tag)
        check_tc_routes(r["routes"], tag)
        check_gn_one_launch(r["gn_routes"], tag)
        if r["routes"]["tensor_core"] != adm_per_forward * r["adm_calls"]:
            fail(f"{tag}: {r['routes']['tensor_core']} tensor-core attention launches, want {adm_per_forward} a call of "
                 f"ADM-128 ({r['adm_calls']} calls)")
        print(f"[{tag}] kernels {json.dumps(r['launches'])}; {r['adm_calls']} ADM calls ({r['adm_forwards']} forwards of "
              f"batch {CLF_BATCH}); op backwards {json.dumps(r['backwards'])}; peak memory {r['peak_mem_gib']:.2f} GiB",
              flush=True)
        return out, r

    def check_backwards(r, grad_calls, tag):
        """Each gradient ADM call takes one backward through every op wrapper
        its forward used (phase 3's launches a forward)."""
        want = {k: adm_fwd_counts[k] * grad_calls for k in bwd_ops}
        if r["backwards"] != want:
            fail(f"{tag}: op backwards {r['backwards']}, want {want} ({grad_calls} gradient calls)")

    # scheduler type: (extra flags, window steps, ADM calls, forwards of the batch, gradient calls)
    short = ["--generation-steps", "10", "--start-step-uc", "8", "--num-steps-uc", "2"]
    protocol = ["--generation-steps", "50", "--start-step-uc", "40", "--num-steps-uc", "10"]
    runs12 = {
        "uncertainty": (protocol, 10, 60, 100, 0),
        "uncertainty_grad": (protocol, 10, 60, 100, 10),
        "infer_noise": (short, 2, 12, 20, 0),
        "uncertainty_image": (short, 2, 12, 20, 0),
        "uncertainty_centered_d": (short, 2, 12, 20, 0),
        "flip": (short, 2, 12, 12, 0),
    }
    phase12: dict = {}
    dataset_cli.instantiate_model_scheduler, ops_attention.attention_bwd = counted_bundle, counted_bwd
    dataset_cli.generate_uncertainty_dataset = timed_generation
    generate_guided.instantiate_model_scheduler, generate_guided.generate_uncertainty_dataset = counted_bundle, gg_generation
    generate_guided.build_guidance = moved_guidance
    compute_fid.make_extractor = recorded_extractor
    for name, cls in bwd_ops.items():
        cls.backward = counted_backward(name)
    try:
        with tempfile.TemporaryDirectory() as root:
            os.environ["DIFFUSION_UNCERTAINTY_ROOT"] = root
            generate_starting_points.main(["--datasets", "imagenet128", "--num-samples", str(CLF_BATCH), "--extra-samples", "0"])
            base = ["--dataset", "imagenet128", "--random-init", "true", "--M", "5", "--batch-size", str(CLF_BATCH),
                    "--num-samples", str(CLF_BATCH)]
            # 12a: every newly ported scheduler type through the dataset CLI
            for st, (flags, n_win, n_calls, n_fwd, n_grad) in runs12.items():
                run_dir = ["--run-dir", os.path.join(root, "runs12", st)]  # runs within one second share a timestamp
                run, r = counted(f"12a {st}", lambda: dataset_cli.main(base + flags + run_dir + ["--scheduler-type", st]))
                u, imgs = load_run_arrays(run, "uncertainty"), load_run_arrays(run, "gen_images")
                r.update(generation_s=gen_s[0], images_per_s=len(imgs) / gen_s[0], uncertainty_shape=list(u.shape),
                         uncertainty_mean=float(u.mean()))
                if not (imgs.shape == (CLF_BATCH, 128, 128, 3) and u.shape == (CLF_BATCH, n_win, 128, 128, 3)
                        and bool(np.isfinite(u).all()) and u.mean() > 0):
                    fail(f"12a {st}: images {imgs.shape}, maps {u.shape}, finite {bool(np.isfinite(u).all())}, mean {u.mean()}")
                if (r["adm_calls"], r["adm_forwards"]) != (n_calls, n_fwd):
                    fail(f"12a {st}: {r['adm_forwards']} ADM forwards in {r['adm_calls']} calls, want {n_fwd} in {n_calls}")
                check_backwards(r, n_grad, f"12a {st}")
                print(f"[12a] {st} (ADM-128, bf16, batch {CLF_BATCH}, M=5, {n_calls - n_win} DDIM steps, window of "
                      f"{n_win}, dataset CLI): {r['generation_s']:.2f} s sampling, {r['images_per_s']:.4f} images/s on "
                      f"{card} ({r['s']:.2f} s with the set-up); maps {r['uncertainty_shape']}, mean "
                      f"{r['uncertainty_mean']:.4e}; peak memory {r['peak_mem_gib']:.2f} GiB", flush=True)
                phase12[st] = r

            # 12b: one window step's gradient of uncertainty_grad, kernels against plain versions
            bundle = counted_bundle("imagenet128", random_init=True)
            g12 = torch.Generator(device=dev).manual_seed(SEED + 12)
            x12 = torch.randn(CLF_BATCH, 128, 128, 3, generator=g12, device=dev)
            y12 = torch.randint(0, 1000, (CLF_BATCH,), generator=g12, device=dev)
            n12 = torch.randn(5, CLF_BATCH, 128, 128, 3, generator=g12, device=dev)

            class Fixed:  # the same ensemble draw for both runs
                def normal(self, shape, dtype, device):
                    assert tuple(shape) == tuple(n12.shape)
                    return n12

            fn12 = lambda x, t, nz: bundle.apply_fn(x, t, y12, nz)  # noqa: E731
            with torch.no_grad():
                step = ddim_step(bundle.schedule, x12, fn12(x12, 180, None), 180, 160, DiffusionConfig())
            state12 = StepState(x12, step.pred_original_sample, step.pred_epsilon, step.prev_sample, 180, 160)
            grad_k, r = counted("12b kernels", lambda: guid_mod._eps_gradient(fn12, bundle.schedule, state12, Fixed(), 5, 0))
            check_backwards(r, 1, "12b kernels")
            with PlainKernels(wrapper_mods, plains):
                kernels.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                grad_p = guid_mod._eps_gradient(fn12, bundle.schedule, state12, Fixed(), 5, 0)
                torch.cuda.synchronize()
                plain_s, plain_mem = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
            if any(kernels.launch_counts().values()):
                fail("12b: the plain-version run launched a kernel")
            rel = {"grad": rel_l2(grad_k[0], grad_p[0]), "u": rel_l2(grad_k[1], grad_p[1])}
            ok = all(bool(torch.isfinite(t).all()) for t in (*grad_k, *grad_p)) and float(grad_k[0].abs().max()) > 0
            print(f"[12b] uncertainty_grad, one window step (t=180, M=5 folded to batch {5 * CLF_BATCH}, bf16): gradient "
                  f"{r['s']:.2f} s with the kernels, {plain_s:.2f} s with the plain versions on {card}; peak memory "
                  f"{r['peak_mem_gib']:.2f} / {plain_mem:.2f} GiB; kernels against plain versions: dε rel L2 "
                  f"{rel['grad']:.3e}, u rel L2 {rel['u']:.3e} (limit 5e-2)", flush=True)
            if not (ok and rel["grad"] <= 5e-2 and rel["u"] <= 5e-2):
                fail(f"12b: gradient against the plain versions {rel}, finite and non-zero {ok}")
            phase12["grad_check"] = {**r, **rel, "plain_s": plain_s, "plain_peak_mem_gib": plain_mem}
            del bundle, grad_k, grad_p, state12, step

            # 12c: the guided-generation A/B CLI; (flags, window steps, gradient calls)
            for g, (flags, n_win, n_grad) in {"posterior": (protocol + ["--compute-fid", "true"], 10, 0),
                                              "gradient": (short + ["--compute-fid", "false"], 2, 2),
                                              "second_order": (short + ["--compute-fid", "false"], 2, 0),
                                              "mask": (short + ["--compute-fid", "false"], 2, 0)}.items():
                gg_images.clear()
                extractors.clear()
                gg_moves.clear()
                argv = ["--dataset", "imagenet128", "--guidance", g, "--random-init", "true", "--M", "5",
                        "--batch-size", str(CLF_BATCH), "--num-samples", str(CLF_BATCH)] + flags
                rec, r = counted(f"12c {g}", lambda: generate_guided.main(argv))
                check_backwards(r, n_grad, f"12c {g}")
                records = json.loads((paths.results() / "uncertainty_guidance" / "results.json").read_text())
                moved = float(np.abs(gg_images[0].astype(np.int16) - gg_images[1].astype(np.int16)).mean())
                # beyond rounding: above 10x the largest floor of the window (0 where the guidance's formula
                # reproduces the plain step bitwise); the last step moves only the unclipped pixels of x0
                step_moves = [m for m, _ in gg_moves]
                limit = max([0.0] + [10 * f for _, f in gg_moves])
                r.update(record=rec, extractor=extractors[:1], guided_vs_plain_mean_abs_uint8=moved,
                         x_prev_moves=step_moves, x_prev_rounding_floors=[f for _, f in gg_moves])
                print(f"[12c] generate_guided --guidance {g} ({flags[1]} steps, window of {flags[5]}, M=5, batch "
                      f"{CLF_BATCH}): {r['s']:.2f} s for both runs on {card}; record {json.dumps(rec)}; extractor "
                      f"{extractors or 'none'}; guided against plain x_(t-1), rel L2 a window step "
                      f"{['%.3e' % m for m in step_moves]} (rounding floor {['%.1e' % f for _, f in gg_moves]}, "
                      f"limit above {limit:.1e}); final images: mean |diff| {moved:.4f} uint8", flush=True)
                if not (len(gg_images) == 2 and len(gg_moves) == n_win and max(step_moves) > limit
                        and records[-1]["guidance"] == g):
                    fail(f"12c {g}: {len(gg_images)} runs, x_(t-1) moved {step_moves} in {len(gg_moves)} window steps "
                         f"(want {n_win}, the largest above {limit:.1e}), last record {records[-1]}")
                if g == "posterior" and not (extractors and math.isfinite(rec["fid_guided_vs_plain"])):
                    fail(f"12c posterior: FID {rec.get('fid_guided_vs_plain')}, extractor {extractors}")
                phase12[f"guided_{g}"] = r
    finally:
        dataset_cli.instantiate_model_scheduler, ops_attention.attention_bwd = saved[0], saved[2]
        dataset_cli.generate_uncertainty_dataset = saved_gen
        generate_guided.instantiate_model_scheduler, generate_guided.generate_uncertainty_dataset = gg_saved
        generate_guided.build_guidance = gg_build
        compute_fid.make_extractor = saved_ext
        for name, cls in bwd_ops.items():
            cls.backward = staticmethod(saved_bwd[name])
        if saved_root is None:
            os.environ.pop("DIFFUSION_UNCERTAINTY_ROOT", None)
        else:
            os.environ["DIFFUSION_UNCERTAINTY_ROOT"] = saved_root
    details.update(phase12=phase12)
    lap(12)

    # ---- phase 13: SD3-medium, SD3.5-large and Flux-dev on the flow-matching sampler
    import gc

    from diffusion_uncertainty_torch.diffusion.flow_match import FlowMatchConfig, sample_flow_match_stepwise
    from diffusion_uncertainty_torch.models import AutoencoderKLConfig, FluxTransformer, MMDiT
    from diffusion_uncertainty_torch.scripts import generate_t2i_guided as t2i

    def free_card():
        gc.collect()
        torch.cuda.empty_cache()

    def flow_inputs(m, cfg, b, tokens=16):
        """Latents, context, pooled text (bf16-representable, so a float32
        reference sees the card's inputs) and the model's extra argument."""
        g13 = torch.Generator(device=dev).manual_seed(SEED + 13)
        r = lambda *shape: torch.randn(*shape, generator=g13, device=dev).to(torch.bfloat16).float()  # noqa: E731
        extra = (7500.0,) if m == "flux" else ()
        return r(b, 64, 64, 16), r(b, tokens, cfg.joint_attention_dim), r(b, cfg.pooled_projection_dim), extra

    # 13a: full-width forwards against float32
    phase13: dict = {}
    for m, (heads, d, sites) in FLOW_MODELS.items():
        t0 = time.perf_counter()
        stack = t2i.build_flow_stack(T2IConfig(model=m, random_init=True), device=dev)
        model13, mcfg13, b = stack.model, stack.mcfg, (1 if m == "flux" else 2)
        n_p = sum(p.numel() for p in model13.parameters())
        x13, c13, p13, extra = flow_inputs(m, mcfg13, b)
        build_s = time.perf_counter() - t0
        with torch.no_grad():
            model13(x13, 500.0, c13, p13, *extra)  # cuBLAS plans, outside the timed call
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with Recorder(wrapper_mods) as rec13:
                t0 = time.perf_counter()
                out13 = model13(x13, 500.0, c13, p13, *extra)
                torch.cuda.synchronize()
                fwd_s = time.perf_counter() - t0
            counts13, routes13 = kernels.launch_counts(), kernels.route_counts()
            with PlainKernels(wrapper_mods, plains):
                out_plain = model13(x13, 500.0, c13, p13, *extra)
        want_sig = {(FLOW_TOKENS, FLOW_TOKENS, heads, d, "separate", None)}
        got_sig = {sig for name, sig in rec13.sigs if name == "attention"}
        if counts13["attention"] != sites or routes13["tensor_core"] != sites or got_sig != want_sig:
            fail(f"13a {m}: {counts13['attention']} attention launches by route {routes13} at {got_sig}; want {sites} on the "
                 f"tensor-core route at {want_sig} (phase 2's shapes)")
        if any(v for k, v in counts13.items() if k != "attention") or not bool(torch.isfinite(out13).all()):
            fail(f"13a {m}: kernels {counts13}, finite {bool(torch.isfinite(out13).all())}")
        t0 = time.perf_counter()
        if m == "sd3":  # float32 on the CPU at batch 1, as phases 3 and 5
            with torch.device("meta"):
                ref_model = MMDiT(mcfg13)
            ref_model.load_state_dict({k: v.float().cpu() for k, v in model13.state_dict().items()}, assign=True)
            with torch.no_grad():
                ref13 = ref_model.eval()(x13[:1].cpu(), 500.0, c13[:1].cpu(), p13[:1].cpu())
            where, out13, out_plain = "CPU, batch 1", out13[:1], out_plain[:1]
            del ref_model
        else:  # 32 / 48 GB of float32 weights: on the card in place of the bf16 ones, with the plain versions
            with torch.no_grad():
                for i, p in enumerate(model13.parameters()):
                    p.data = p.data.float()  # frees the bf16 tensor
                    if i % 64 == 0:
                        torch.cuda.empty_cache()
                with PlainKernels(wrapper_mods, plains):
                    ref13 = model13(x13, 500.0, c13, p13, *extra)
            where = "the card, plain versions"
        ref_s = time.perf_counter() - t0
        rel13, plain13 = rel_l2(out13, ref13), rel_l2(out_plain, ref13)
        print(f"[13a] {m} forward ({n_p / 1e9:.3f}B params, bf16, batch {b}, {FLOW_TOKENS} tokens, t=500): built in "
              f"{build_s:.1f} s, {fwd_s * 1e3:.1f} ms (second call); vs float32 on {where} ({ref_s:.1f} s): rel L2 "
              f"{rel13:.3e} (limit 2e-2), the same bf16 forward through the plain versions {plain13:.3e} (limit: kernels "
              f"<= plain + 1e-3); {counts13['attention']} attention launches a forward (want {sites}), route "
              f"{json.dumps(routes13)}", flush=True)
        if not (rel13 <= 2e-2 and rel13 <= plain13 + 1e-3):
            fail(f"13a {m}: relative L2 error {rel13} (plain versions {plain13}; limits 2e-2 and plain + 1e-3)")
        phase13[f"forward_{m}"] = {"params": n_p, "batch": b, "forward_ms": fwd_s * 1e3, "rel_l2": rel13,
                                   "plain_rel_l2": plain13, "attention_per_forward": counts13["attention"]}
        stack = model13 = out13 = out_plain = ref13 = None
        free_card()
    lap("13a")

    # 13b-d: the CLI at its defaults; model calls, op backwards and sampler
    # spans counted as they run
    flow_calls = {"calls": 0, "grad_calls": 0}
    saved_fwd = {cls: cls.forward for cls in (MMDiT, FluxTransformer)}
    saved_att_bwd = op_att._Attention.backward
    att_bwd = [0]
    sampler_s: list = []
    saved_sampler = t2i.sample_flow_match

    def counted_forward(cls):
        def forward(self, *a, **kw):
            flow_calls["calls"] += 1
            flow_calls["grad_calls"] += torch.is_grad_enabled()
            return saved_fwd[cls](self, *a, **kw)

        return forward

    def counted_att_bwd(ctx, *grads):
        att_bwd[0] += 1
        return saved_att_bwd(ctx, *grads)

    def timed_sampler(sampler):
        """The CLI's sampler, each call's seconds kept (guided, then plain)."""

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sampler(*a, **kw)
            torch.cuda.synchronize()
            sampler_s.append(time.perf_counter() - t0)
            return out

        return run

    def flow_run(tag, argv, m):
        """t2i.main(argv) between zeroed and read counters: (its folder, the run's record)."""
        flow_calls.update(calls=0, grad_calls=0)
        att_bwd[0] = 0
        sampler_s.clear()
        t2i.sample_flow_match = timed_sampler(saved_sampler)
        free_card()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30  # the models this script keeps
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            t2i.main(argv)
        finally:
            t2i.sample_flow_match = saved_sampler
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = {"s": wall, "sampler_s": list(sampler_s), "launches": kernels.launch_counts(), "routes": kernels.route_counts(),
             "gn_routes": kernels.gn_route_counts(), "calls": flow_calls["calls"], "grad_calls": flow_calls["grad_calls"],
             "attention_backwards": att_bwd[0], "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "resident_gib": resident}
        sites = FLOW_MODELS[m][2]
        check_counts(r["launches"], ("attention",), tag)
        if r["routes"]["tensor_core"] != r["calls"] * sites:
            fail(f"{tag}: {r['routes']['tensor_core']} tensor-core attention launches for {r['calls']} forwards of "
                 f"{sites} sites (routes {r['routes']})")
        if r["attention_backwards"] * 2 != r["grad_calls"] * sites:
            fail(f"{tag}: {r['attention_backwards']} attention backwards for {r['grad_calls']} forwards with autograd "
                 f"(each member forward twice: once checkpointed, once recomputed) of {sites} sites")
        out_dir = argv[argv.index("--out-dir") + 1]
        return os.path.join(out_dir, "0"), r

    def png_size(path):
        with open(path, "rb") as f:
            head = f.read(24)
        return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")

    n13, w13, m13 = 20, 20, 5  # the CLI's steps, window and members
    MMDiT.forward, FluxTransformer.forward = counted_forward(MMDiT), counted_forward(FluxTransformer)
    op_att._Attention.backward = staticmethod(counted_att_bwd)
    try:
        with tempfile.TemporaryDirectory() as root13:
            # 13b: the CLI at its defaults, --random-init true, no --device
            for m, post in (("sd3", False), ("sd3", True), ("flux", False), ("flux", True), ("sd35", True)):
                tag = f"13b {m} {'posterior' if post else 'gradient'}"
                out_dir = os.path.join(root13, f"{m}_{post}")
                argv = ["--model", m, "--random-init", "true", "--use-posterior", str(post).lower(), "--out-dir", out_dir]
                dest, r = flow_run(tag, argv, m)
                stem = "flux" if m == "flux" else "sd3"
                files = ["args.yaml", f"output_latent_preview_{stem}.png", f"output_latent_preview_{stem}_uc.png",
                         "uncertainty.npz"]
                if sorted(os.listdir(dest)) != files:
                    fail(f"{tag}: files {sorted(os.listdir(dest))}, want {files}")
                u = np.load(os.path.join(dest, "uncertainty.npz"))["data"]
                if not (u.shape == (w13, 1, 64, 64, 16) and bool(np.isfinite(u).all()) and u.mean() > 0):
                    fail(f"{tag}: maps {u.shape}, finite {bool(np.isfinite(u).all())}, mean {u.mean()}")
                # the guided and the plain run's trajectory, and one folded ensemble call a window
                # step (the gradient branch's twice: checkpointed, then recomputed)
                want = (2 * n13 + (w13 if post else 2 * w13), 0 if post else 2 * w13)
                if (r["calls"], r["grad_calls"]) != want:
                    fail(f"{tag}: {r['calls']} model calls ({r['grad_calls']} with autograd), want {want}")
                r.update(uncertainty_mean=float(u.mean()), guided_s=r["sampler_s"][0], plain_s=r["sampler_s"][1],
                         guided_images_per_s=1.0 / r["sampler_s"][0])
                print(f"[{tag}] --model {m} (512x512, 20 steps, window [0, 20), M=5 folded, p 0.95, CFG 7.5, bf16): "
                      f"guided {r['guided_s']:.2f} s "
                      f"({r['guided_images_per_s']:.4f} images/s), plain {r['plain_s']:.2f} s, {r['s']:.1f} s with the "
                      f"build, on {card}; {r['calls']} model calls ({r['grad_calls']} with autograd), attention "
                      f"{r['launches']['attention']} launches, {r['attention_backwards']} backwards; peak memory "
                      f"{r['peak_mem_gib']:.2f} GiB; maps {list(u.shape)} mean {r['uncertainty_mean']:.4e}", flush=True)
                phase13[f"cli_{m}_{'posterior' if post else 'gradient'}"] = r

            # 13c: the 16-channel VAE decode (float32) with seeded random weights
            vae_file = os.path.join(root13, "sd3_vae.pt")
            with torch.device("meta"):
                vae13 = AutoencoderKL(AutoencoderKLConfig.sd3_kl())
            torch.save(t2i.init_random_(vae13.to_empty(device="cpu"), 13).state_dict(), vae_file)
            del vae13
            argv = ["--model", "sd3", "--random-init", "true", "--use-posterior", "true", "--vae-weights", vae_file,
                    "--out-dir", os.path.join(root13, "decode")]
            dest, r = flow_run("13c sd3 decode", argv, "sd3")
            files = sorted(os.listdir(dest))
            sizes = [png_size(os.path.join(dest, n)) for n in ("output_sd3_uc.png", "output_sd3.png") if n in files]
            if files != ["args.yaml", "output_sd3.png", "output_sd3_uc.png", "uncertainty.npz"] or sizes != [(512, 512)] * 2:
                fail(f"13c: files {files}, image sizes {sizes}")
            check_counts(r["launches"], ("group_norm", "gn_stats", "gn_apply", "attention", "attention_long"), "13c")
            if r["gn_routes"]["pair"] != 2 * VAE_PAIRS or r["routes"]["wide"] != 2:
                fail(f"13c: GroupNorm routes {r['gn_routes']} (want {2 * VAE_PAIRS} pairs: two decodes), attention "
                     f"routes {r['routes']} (want the two decodes' D=512 on the wide route)")
            print(f"[13c] --model sd3 --use-posterior true --vae-weights (16-channel VAE, float32): images "
                  f"{sizes}; kernels {json.dumps(r['launches'])}; GroupNorm routes {json.dumps(r['gn_routes'])}; "
                  f"attention routes {json.dumps(r['routes'])}; peak memory {r['peak_mem_gib']:.2f} GiB", flush=True)
            phase13["cli_sd3_decode"] = r
    finally:
        MMDiT.forward, FluxTransformer.forward = saved_fwd[MMDiT], saved_fwd[FluxTransformer]
        op_att._Attention.backward = staticmethod(saved_att_bwd)
    lap("13b-c")

    # 13d: bench.py run_sd3's protocol through the stepwise sampler (not a
    # benchmark cell): SD3-medium, batch 4, 16 steps, M=2 posterior on [8, 16),
    # CFG 7.0 over 77 zero context tokens, bf16 latents
    stack = t2i.build_flow_stack(T2IConfig(model="sd3", random_init=True), device=dev)
    bb, nb = SD3_BENCH["batch"], SD3_BENCH["steps"]
    ctx_b = torch.zeros(2 * bb, SD3_BENCH["tokens"], 4096, device=dev)
    pooled_b = torch.zeros(2 * bb, 2048, device=dev)

    def bench_velocity(x, t):
        vu, vc = stack.model(torch.cat([x, x]), t, ctx_b, pooled_b).chunk(2)
        return vu + SD3_BENCH["cfg"] * (vc - vu)

    fm13 = FlowMatchConfig(num_inference_steps=nb, shift=3.0, after_step=nb // 2, num_steps_uc=nb // 2, M=SD3_BENCH["M"],
                           use_posterior=True)
    bench13 = []
    for i in range(2):  # the first run makes the cuBLAS plans of the batch-8 shapes
        noise13 = TorchNoise(SEED + 70 + i, dev)
        x_b = noise13.normal((bb, 64, 64, 16)).to(torch.bfloat16)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res13 = sample_flow_match_stepwise(bench_velocity, x_b, noise13, fm13)
        torch.cuda.synchronize()
        bench13.append(time.perf_counter() - t0)
        counts = kernels.launch_counts()
    calls_b = nb + (nb // 2) * SD3_BENCH["M"]
    if counts["attention"] != calls_b * FLOW_MODELS["sd3"][2] or not bool(torch.isfinite(res13.sample.float()).all()):
        fail(f"13d: {counts['attention']} attention launches (want {calls_b * FLOW_MODELS['sd3'][2]}), finite "
             f"{bool(torch.isfinite(res13.sample.float()).all())}")
    if tuple(res13.uncertainty.shape) != (nb // 2, bb, 64, 64, 16) or not float(res13.uncertainty.mean()) > 0:
        fail(f"13d: maps {tuple(res13.uncertainty.shape)} mean {float(res13.uncertainty.mean())}")
    print(f"[13d] run_sd3's protocol (SD3-medium, batch {bb}, {nb} steps, M={SD3_BENCH['M']} posterior on [{nb // 2}, "
          f"{nb}), CFG {SD3_BENCH['cfg']}, {SD3_BENCH['tokens']} context tokens, sample_flow_match_stepwise): "
          f"{bench13[1]:.2f} s, {bb / bench13[1]:.3f} images/s on {card} (first run {bench13[0]:.2f} s; "
          f"information, not a benchmark cell); {calls_b} forwards of batch {2 * bb}", flush=True)
    phase13["run_sd3_protocol"] = {"s": bench13, "images_per_s": bb / bench13[1], "launches": counts}
    del stack, res13
    free_card()
    details.update(phase13=phase13)
    lap("13d")
    print(f"[13] phase time {sum(details['phase_s'][k] for k in ('13a', '13b-c', '13d')):.1f} s", flush=True)

    # ---- phase 14: the text towers, SD 2.1 and the safety checker ----------
    import copy

    from diffusion_uncertainty_torch.factory import init_normal_
    from diffusion_uncertainty_torch.models import CLIPVisionConfig
    from diffusion_uncertainty_torch.pipelines import safety_checker as sc_mod
    from diffusion_uncertainty_torch.pipelines import text_encoder as te
    from diffusion_uncertainty_torch.pipelines import text_to_image as tti
    from diffusion_uncertainty_torch.utils.config import read_config

    def host_available_gib() -> float:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / 2**20
        return 0.0

    def png_info(path):
        """(width, height, colour type, pixels [H, W, C] uint8) of a PNG the
        t2i CLI wrote (zlib, filter 0 on every row)."""
        import zlib

        with open(path, "rb") as f:
            data = f.read()
        pos, idat, head = 8, b"", b""
        while pos < len(data):
            n, tag = int.from_bytes(data[pos:pos + 4], "big"), data[pos + 4:pos + 8]
            if tag == b"IHDR":
                head = data[pos + 8:pos + 8 + n]
            elif tag == b"IDAT":
                idat += data[pos + 8:pos + 8 + n]
            pos += 12 + n
        w, h, ctype = int.from_bytes(head[:4], "big"), int.from_bytes(head[4:8], "big"), head[9]
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * {2: 3, 6: 4}[ctype])
        if rows[:, 0].any():
            fail(f"{path}: a PNG row with a filter other than 0")
        return w, h, ctype, rows[:, 1:].reshape(h, w, -1)

    def t5_blocks_against_f64(t5, ids):
        """Each T5 block on the card in float32 against the same block in
        float64 on the card, both on the float32 run's input: rel L2 a block."""
        rels = {}
        with torch.no_grad():
            x, bias = t5.shared(ids.long()), t5.position_bias(ids.shape[1])
            for i, blk in enumerate(t5.encoder.block):
                y = blk(x, bias, None)
                blk64 = copy.deepcopy(blk).double()
                rels[f"block_{i}"] = rel_l2(y, blk64(x.double(), bias.double(), None))
                del blk64
                x = y
        return rels

    def run_phase14() -> dict:
        """Phase 14's records; the CLI runs' carry their launches."""
        p14: dict = {}
        # 14a: the three towers at full width against float32 (TF32 off)
        f32 = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
               "float32_matmul_precision": torch.get_float32_matmul_precision()}
        if f32["allow_tf32"] or f32["float32_matmul_precision"] != "highest":
            fail(f"14a: TF32 is on for the towers' float32 matmuls: {f32}")
        free_card()
        t0 = time.perf_counter()
        towers = te.T2ITowers("sd3", scale="full", seed=SEED, device=dev)
        torch.cuda.synchronize()
        rec = {"build_s": time.perf_counter() - t0, "f32_matmuls": f32, "host_available_gib": host_available_gib()}
        prompts = ["a photo of a cat", ""]
        ids = {"clip": te.pseudo_token_ids(prompts, 77, te.CLIP_VOCAB, bos=te.CLIP_VOCAB - 2, eos=te.CLIP_EOS),
               "t5": te.pseudo_token_ids(prompts, 77, te.T5_VOCAB, eos=1)}
        ids = {k: torch.from_numpy(v).to(dev) for k, v in ids.items()}
        for name, module, key in (("clip_l", towers.clip_l, "clip"), ("clip_g", towers.clip_g, "clip"),
                                  ("t5", towers.t5, "t5")):
            n_p = sum(p.numel() for p in module.parameters())
            with torch.no_grad():
                module(ids[key])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = module(ids[key])
                torch.cuda.synchronize()
                fwd_ms = (time.perf_counter() - t0) * 1e3
            got = {"last_hidden": got} if name == "t5" else got._asdict()
            t0 = time.perf_counter()
            if name == "t5" and rec["host_available_gib"] < 2.5 * n_p * 4 / 2**30:
                how, limit = "block by block against float64 on the card (the host cannot hold a float32 copy)", 1e-5
                rels = t5_blocks_against_f64(module, ids[key])
            else:
                how, limit = "against float32 on the CPU (batch 1)", 1e-4
                with torch.device("meta"):
                    ref_model = type(module)(module.cfg)
                ref_model.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()}, assign=True)
                with torch.no_grad():
                    ref = ref_model.eval()(ids[key][:1].cpu())
                del ref_model
                ref = {"last_hidden": ref} if name == "t5" else ref._asdict()
                rels = {k: rel_l2(v[:1], ref[k]) for k, v in got.items()}
            ref_s = time.perf_counter() - t0
            print(f"[14a] {name} ({n_p / 1e6:.1f}M params, float32, batch 2, 77 tokens): {fwd_ms:.1f} ms (second call); "
                  f"held {how} ({ref_s:.1f} s): rel L2 {json.dumps({k: float(f'{v:.3e}') for k, v in rels.items()})} "
                  f"(limit {limit})", flush=True)
            if max(rels.values()) > limit:
                fail(f"14a {name}: relative L2 errors {rels} above {limit} ({how})")
            rec[name] = {"params": n_p, "forward_ms": fwd_ms, "held": how, "rel_l2": rels, "reference_s": ref_s}
        print(f"[14a] towers built in {rec['build_s']:.1f} s on the card (seeded, float32: CLIP N(0, 0.02), T5 at its init "
              f"scales); float32 matmuls "
              f"{json.dumps(f32)}; host MemAvailable {rec['host_available_gib']:.1f} GiB", flush=True)
        p14["towers"] = rec
        del towers, got, module
        free_card()
        lap("14a")

        # 14b: the flow CLI with the towers, no --device
        enc_log: list = []
        saved_init, saved_encode = te.T2ITowers.__init__, te.T2ITowers.encode

        def timed_init(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            saved_init(self, *a, **kw)
            torch.cuda.synchronize()
            enc_log.append(("build", time.perf_counter() - t0))

        def timed_encode(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c, p = saved_encode(self, *a, **kw)
            torch.cuda.synchronize()
            enc_log.append(("encode", time.perf_counter() - t0, tuple(c.shape), tuple(p.shape),
                            torch.cuda.max_memory_allocated() / 2**30, self.used_pseudo_tokens))
            return c, p

        te.T2ITowers.__init__, te.T2ITowers.encode = timed_init, timed_encode
        MMDiT.forward, FluxTransformer.forward = counted_forward(MMDiT), counted_forward(FluxTransformer)
        op_att._Attention.backward = staticmethod(counted_att_bwd)
        try:
            for m, scale, post in (("sd3", "full", False), ("sd3", "full", True), ("flux", "full", True),
                                   ("sd35", "small", True)):
                branch = "posterior" if post else "gradient"
                tag = f"14b {m} --text-towers {scale} {branch}"
                argv = ["--model", m, "--random-init", "true", "--text-towers", scale, "--use-posterior", str(post).lower(),
                        "--out-dir", os.path.join(work.name, f"towers_{m}_{branch}")]
                enc_log.clear()
                with Recorder(wrapper_mods) as rec14:
                    dest, r = flow_run(tag, argv, m)
                heads, d, sites = FLOW_MODELS[m]
                stem = "flux" if m == "flux" else "sd3"
                files = ["args.yaml", f"output_latent_preview_{stem}.png", f"output_latent_preview_{stem}_uc.png",
                         "uncertainty.npz"]
                if sorted(os.listdir(dest)) != files:
                    fail(f"{tag}: files {sorted(os.listdir(dest))}, want {files}")
                stamps = read_config(os.path.join(dest, "args.yaml"))
                want = ((1, 77, 4096), (1, 768)) if m == "flux" else ((1, 154, 4096), (1, 2048))
                encodes = [e for e in enc_log if e[0] == "encode"]
                # pseudo token ids where no tokenizer files are on disk (the local Hugging Face cache)
                pseudo_tokens = any(e[5] for e in encodes)
                if (stamps["pseudo_text"], stamps["pseudo_tokens"], stamps["text_towers"]) != (False, pseudo_tokens, scale):
                    fail(f"{tag}: args.yaml pseudo_text {stamps['pseudo_text']}, pseudo_tokens {stamps['pseudo_tokens']}, "
                         f"text_towers {stamps['text_towers']}: want false, {pseudo_tokens} (the towers' tokenizers), {scale}")
                if len(encodes) != 2 or any(e[2:4] != want for e in encodes):
                    fail(f"{tag}: encodes {encodes}, want two of context / pooled shapes {want}")
                n_tok = FLOW_TOWER_TOKENS[m]
                sigs = {sig for name, sig in rec14.sigs if name == "attention"}
                if sigs != {(n_tok, n_tok, heads, d, "separate", None)}:
                    fail(f"{tag}: attention at {sigs}, want the joint length {n_tok} (phase 2's shapes)")
                want_calls = (2 * n13 + (w13 if post else 2 * w13), 0 if post else 2 * w13)
                if (r["calls"], r["grad_calls"]) != want_calls:
                    fail(f"{tag}: {r['calls']} model calls ({r['grad_calls']} with autograd), want {want_calls}")
                u = np.load(os.path.join(dest, "uncertainty.npz"))["data"]
                if not (u.shape == (w13, 1, 64, 64, 16) and bool(np.isfinite(u).all()) and u.mean() > 0):
                    fail(f"{tag}: maps {u.shape}, finite {bool(np.isfinite(u).all())}, mean {u.mean()}")
                r.update(towers_build_s=sum(e[1] for e in enc_log if e[0] == "build"),
                         encode_s=sum(e[1] for e in encodes), towers_peak_gib=max(e[4] for e in encodes),
                         context=list(want[0]), pooled=list(want[1]), joint_tokens=n_tok, pseudo_tokens=pseudo_tokens,
                         encode_s_each=[e[1] for e in encodes], guided_s=r["sampler_s"][0],
                         plain_s=r["sampler_s"][1], uncertainty_mean=float(u.mean()))
                print(f"[{tag}] towers built in {r['towers_build_s']:.2f} s, two prompts encoded in "
                      f"{' + '.join(f'{e:.3f}' for e in r['encode_s_each'])} s with "
                      f"{'pseudo token ids' if pseudo_tokens else 'the tokenizers of the local Hugging Face cache'} "
                      f"(peak {r['towers_peak_gib'] - r['resident_gib']:.2f} GiB with the towers, above the models this "
                      f"script keeps); context {want[0]}, pooled {want[1]}; guided "
                      f"{r['guided_s']:.2f} s, plain {r['plain_s']:.2f} s, {r['s']:.1f} s in all on {card}; "
                      f"{r['calls']} model calls, {r['launches']['attention']} attention launches at {n_tok} tokens, "
                      f"{r['attention_backwards']} backwards; peak memory {r['peak_mem_gib']:.2f} GiB, "
                      f"{r['peak_mem_gib'] - r['resident_gib']:.2f} above the {r['resident_gib']:.2f} GiB this script keeps",
                      flush=True)
                p14[f"cli_{m}_{scale}_{branch}"] = r
        finally:
            te.T2ITowers.__init__, te.T2ITowers.encode = saved_init, saved_encode
            MMDiT.forward, FluxTransformer.forward = saved_fwd[MMDiT], saved_fwd[FluxTransformer]
            op_att._Attention.backward = staticmethod(saved_att_bwd)
        lap("14b")

        # 14c: SD 2.1, the full-width forward against float32, then the CLI
        check_counts(sd21_fwd_counts, SD_UNET_PATH, "14c SD 2.1 forward")
        if {k: sd21_fwd_counts[k] for k in SD_UNET_PATH} != {k: sd_fwd_counts[k] for k in SD_UNET_PATH}:
            fail(f"14c SD 2.1 forward: launches {sd21_fwd_counts}, want SD 1.5's block program {sd_fwd_counts}")
        check_tc_routes(sd21_fwd_routes, "14c SD 2.1 forward")
        check_gn_one_launch(sd21_gn_routes, "14c SD 2.1 forward")
        if not bool(torch.isfinite(out_sd21).all()):
            fail("14c SD 2.1 forward: non-finite output")
        t0 = time.perf_counter()
        with torch.device("meta"):
            cpu21 = SDUNet(stack21.mcfg)
        cpu21.load_state_dict({k: v.float().cpu() for k, v in stack21.unet.state_dict().items()}, assign=True)
        with torch.no_grad():
            ref21 = cpu21.eval()(xs21[:1].cpu(), 500, ctx21[:1].cpu())
        del cpu21
        cpu_s = time.perf_counter() - t0
        rel21 = rel_l2(out_sd21[:1], ref21)
        with torch.no_grad(), PlainKernels(wrapper_mods, plains):
            plain21 = rel_l2(stack21.unet(xs21[:1], 500, ctx21[:1]), ref21)
        n21 = sum(p.numel() for p in stack21.unet.parameters())
        print(f"[14c] SD 2.1 UNet forward ({n21 / 1e6:.1f}M params, bf16, batch 2, t=500, 5 x 1024 context): "
              f"{sd21_fwd_s * 1e3:.1f} ms; image 0 vs float32 CPU ({cpu_s:.1f} s): rel L2 {rel21:.3e} (the plain versions "
              f"{plain21:.3e}; limits 2e-2 and plain + 1e-3); launches a forward {json.dumps(sd21_fwd_counts)}, attention "
              f"routes {json.dumps(sd21_fwd_routes)}", flush=True)
        if not (rel21 <= 2e-2 and rel21 <= plain21 + 1e-3):
            fail(f"14c SD 2.1 forward: relative L2 error {rel21} (plain versions {plain21}; limits 2e-2 and plain + 1e-3)")
        p14["sd21_forward"] = {"params": n21, "forward_ms": sd21_fwd_s * 1e3, "rel_l2": rel21, "plain_rel_l2": plain21,
                               "launches_per_forward": sd21_fwd_counts}
        pipe_s: list = []
        saved_call = tti.TextToImageUncertaintyPipeline.__call__

        def timed_call(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved_call(self, *a, **kw)
            torch.cuda.synchronize()
            pipe_s.append(time.perf_counter() - t0)
            return out

        def sd_run(tag, argv, path, extra_files=()):
            """t2i.main(argv) (SD 1.x) between zeroed and read counters."""
            pipe_s.clear()
            free_card()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated() / 2**30
            kernels.reset_launch_counts()
            tti.TextToImageUncertaintyPipeline.__call__ = timed_call
            t0 = time.perf_counter()
            try:
                t2i.main(argv)
            finally:
                tti.TextToImageUncertaintyPipeline.__call__ = saved_call
            torch.cuda.synchronize()
            r = {"s": time.perf_counter() - t0, "pipeline_s": list(pipe_s), "launches": kernels.launch_counts(),
                 "routes": kernels.route_counts(), "gn_routes": kernels.gn_route_counts(),
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "resident_gib": resident}
            check_counts(r["launches"], path, tag)
            if r["routes"]["cuda_core"] or r["routes"]["tensor_core"] <= 0:
                fail(f"{tag}: an attention launch left the tensor-core route: {r['routes']}")
            dest = os.path.join(argv[argv.index("--out-dir") + 1], "0")
            files = sorted(["args.yaml", "output_sd.png", "output_sd_uc.png", "uncertainty.npz", *extra_files])
            if sorted(os.listdir(dest)) != files:
                fail(f"{tag}: files {sorted(os.listdir(dest))}, want {files}")
            u = np.load(os.path.join(dest, "uncertainty.npz"))["data"]
            if not (u.shape == (1, 20, 64, 64, 4) and bool(np.isfinite(u).all()) and u.mean() > 0):
                fail(f"{tag}: maps {u.shape}, finite {bool(np.isfinite(u).all())}, mean {u.mean()}")
            r.update(guided_s=pipe_s[0], plain_s=pipe_s[1], uncertainty_mean=float(u.mean()))
            return dest, r

        for post, vae_file in ((False, None), (True, None), (True, sd_vae_file)):
            branch = "posterior" if post else "gradient"
            tag = f"14c sd21 {branch}" + (" --vae-weights" if vae_file else "")
            argv = ["--model", "sd21", "--random-init", "true", "--use-posterior", str(post).lower(),
                    "--out-dir", os.path.join(work.name, f"sd21_{branch}_{bool(vae_file)}")]
            dest, r = sd_run(tag, argv + (["--vae-weights", vae_file] if vae_file else []),
                             SD_PATH if vae_file else SD_UNET_PATH)
            pngs = [png_info(os.path.join(dest, n))[:3] for n in ("output_sd_uc.png", "output_sd.png")]
            want_png = (512, 512, 2) if vae_file else (64, 64, 6)  # an RGB image, or the RGBA latent grid
            pairs, wide = (2 * VAE_PAIRS, 2) if vae_file else (0, 0)
            if pngs != [want_png] * 2 or r["gn_routes"]["pair"] != pairs or r["routes"]["wide"] != wide:
                fail(f"{tag}: PNGs (width, height, colour type) {pngs}, want {want_png}; GroupNorm routes {r['gn_routes']} "
                     f"(want {pairs} pairs), attention routes {r['routes']} (want {wide} wide)")
            if read_config(os.path.join(dest, "args.yaml"))["pseudo_text"] is not True:
                fail(f"{tag}: args.yaml must stamp pseudo_text: true")
            print(f"[{tag}] (512x512, 20 steps, CFG 7.5, window [0, 20), p 0.95, M=5, bf16, 5 x 1024 pseudo context): "
                  f"guided {r['guided_s']:.2f} s per image, plain {r['plain_s']:.2f} s, {r['s']:.1f} s in all on {card}; "
                  f"PNGs {pngs[0]}; kernels {json.dumps(r['launches'])}; GroupNorm routes {json.dumps(r['gn_routes'])}; "
                  f"peak memory {r['peak_mem_gib'] - r['resident_gib']:.2f} GiB above the {r['resident_gib']:.2f} this script "
                  f"keeps", flush=True)
            p14[f"sd21_{branch}" + ("_decode" if vae_file else "")] = r
        lap("14c")

        # 14d: the SD 1.5 CLI with --safety-checker-weights (a seeded random
        # ViT-L/14 checker); a calibration run that flags nothing sets concept
        # 0 between the guided and the plain image, so that one flags
        with torch.device("meta"):
            checker = sc_mod.SafetyChecker(CLIPVisionConfig.vit_l_14())
        checker = init_normal_(checker.to_empty(device=dev), torch.Generator(device=dev).manual_seed(SEED + 14))
        checker = checker.eval().requires_grad_(False)
        with torch.no_grad():
            checker.concept_embeds_weights.fill_(2.0)  # above any cosine: nothing flags
            checker.special_care_embeds_weights.fill_(2.0)
        ckpt = os.path.join(work.name, "safety_checker.pt")
        seen: list = []
        saved_run = sc_mod.run_safety_checker

        def seeing(chk, images, adjustment=0.0):
            seen.append(images.detach().clone())
            return saved_run(chk, images, adjustment)

        def embeds(model, images):
            with torch.no_grad():
                return model(sc_mod.clip_preprocess(images, 224)).float()

        base = ["--random-init", "true", "--use-posterior", "true", "--vae-weights", sd_vae_file,
                "--safety-checker-weights", ckpt]
        sc_mod.run_safety_checker = seeing
        try:
            torch.save({k: v.cpu() for k, v in checker.state_dict().items()}, ckpt)
            dest0, r0 = sd_run("14d calibration", base + ["--out-dir", os.path.join(work.name, "checker0")], SD_PATH,
                               ("nsfw_flags.yaml",))
            with open(os.path.join(dest0, "nsfw_flags.yaml")) as f:
                if f.read() != "guided:\n- false\noriginal:\n- false\n":
                    fail("14d calibration: an image flagged with every threshold above 1")
            e_g, e_o = (F.normalize(embeds(checker, img), dim=-1)[0] for img in seen)
            margin = float((e_g - e_o).norm()) / 2
            if margin < 1e-4:
                fail(f"14d: the guided and the plain image embed {2 * margin:.2e} apart: too close to split")
            direction = (e_g - e_o) / (2 * margin)
            with torch.no_grad():
                checker.concept_embeds[0] = direction
                checker.concept_embeds_weights[0] = float((e_g + e_o) @ direction) / 2
            torch.save({k: v.cpu() for k, v in checker.state_dict().items()}, ckpt)
            seen.clear()
            dest, r = sd_run("14d safety checker", base + ["--out-dir", os.path.join(work.name, "checker1")], SD_PATH,
                             ("nsfw_flags.yaml",))
        finally:
            sc_mod.run_safety_checker = saved_run
        with open(os.path.join(dest, "nsfw_flags.yaml")) as f:
            flags_text = f.read()
        if flags_text != "guided:\n- true\noriginal:\n- false\n":
            fail(f"14d: nsfw_flags.yaml {flags_text!r}, want the guided image flagged and the plain one not")
        black = [bool((png_info(os.path.join(dest, n))[3] == 0).all()) for n in ("output_sd_uc.png", "output_sd.png")]
        if black != [True, False]:
            fail(f"14d: images black {black}: want the flagged guided image black, the plain one not")
        with torch.device("meta"):
            cpu_checker = sc_mod.SafetyChecker(CLIPVisionConfig.vit_l_14())
        cpu_checker.load_state_dict({k: v.cpu() for k, v in checker.state_dict().items()}, assign=True)
        cpu_checker.eval()
        emb_rel, cpu_flags = [], []
        for img in seen:
            emb_rel.append(rel_l2(embeds(checker, img), embeds(cpu_checker, img.cpu())))
            cpu_flags.append(bool(sc_mod.safety_scores(cpu_checker, sc_mod.clip_preprocess(img.cpu(), 224))[0][0]))
        del cpu_checker
        print(f"[14d] SD 1.5 CLI --safety-checker-weights (ViT-L/14 checker, 304.0M params, float32; posterior, "
              f"--vae-weights): nsfw_flags.yaml {flags_text!r}; flagged image black; image embeds vs float32 CPU rel L2 "
              f"{[float(f'{e:.3e}') for e in emb_rel]} (limit 1e-4), CPU flags {cpu_flags}; half the embed gap "
              f"{margin:.3e}; guided {r['guided_s']:.2f} s, {r['s']:.1f} s in all; kernels {json.dumps(r['launches'])}",
              flush=True)
        if max(emb_rel) > 1e-4 or cpu_flags != [True, False]:
            fail(f"14d: image embeds rel L2 {emb_rel} (limit 1e-4), CPU flags {cpu_flags} (the CLI's [True, False])")
        r.update(embeds_rel_l2=emb_rel, cpu_flags=cpu_flags, half_gap=margin)
        p14["safety_calibration"], p14["safety_checker"] = r0, r
        lap("14d")
        return p14

    phase14 = run_phase14()
    details.update(phase14=phase14)
    print(f"[14] phase time {sum(details['phase_s'][k] for k in ('14a', '14b', '14c', '14d')):.1f} s", flush=True)

    # ---- phase 15: ADM-128's DDPM and KDPM2 samplers, measure_times, the grid ----
    phase15_runs = phase15(dev, card, wrapper_mods, plains, lap)
    details.update(phase15=phase15_runs)
    print(f"[15] phase time {sum(details['phase_s'][k] for k in ('15a-b', '15c', '15d')):.1f} s", flush=True)

    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)), exist_ok=True)
        with open(args.details, "w") as f:
            json.dump(details, f, indent=1, default=str)

    path_runs = (*sd_runs.values(), *cifar_runs.values(), *(r for r in metric_runs.values() if "launches" in r),
                 uvit_runs["main path"], guided_runs["guided"], guided_runs["dpm"], *phase12.values(),
                 *(r for k, r in phase13.items() if k.startswith("cli_")), *(r for r in phase14.values() if "launches" in r),
                 *phase15_runs.values())
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
                         forms="ADM-128, ADM-64, the ImageNet-128 classifier (float32): pair (two tensors a launch); "
                               "SD, CIFAR-10: single",
                         single_form={key: sum(r[key] for r in single)
                                      for key in ("ms", "device_only_ms", "host_us", "plain_ms", "library_ms", "bound_ms")})
        entries.append(entry)
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
