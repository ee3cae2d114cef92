#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and hold its kernels to account.

    python3 chip_smoke.py [--details PATH]   # one card, about a minute

Phases (a failure in any of them ends the run with a non-zero exit):

1. Build the hand-written Hopper kernels from ``diffusion_uncertainty_torch/
   kernels/csrc`` with nvcc (one process per source, in parallel); print the
   seconds and the card's name and power limit.
2. Hold every kernel against its plain PyTorch version on the card, at every
   shape the ADM-128 forward gives it (recorded from the phase-3 forward), at
   batch 2 and 8, in bfloat16 (and float32 for GroupNorm and attention).
   Tolerances: interleave bit-exact; avg-pool within 1 bf16 ulp; GroupNorm
   |kernel - plain| <= 2e-2 + 2^-7·|plain| in bf16 (the second term is one
   output rounding step where |y| > 2) and <= 1e-4 in f32; attention 2e-2 in
   bf16 and 1e-4 in f32. Median device times (CUDA events, after warm-up) of
   kernel and plain version, bfloat16.
3. The full-width ImageNet-128 ADM forward (421M parameters, random bf16
   weights N(0, 0.02), batch 2) on the card through the kernels, against the
   same weights run in float32 on the CPU at batch 1 (the kernel wrappers take
   their plain versions for CPU tensors): relative L2 error of image 0 <= 2e-2.
   Every kernel's launch counter must rise.
4. The main path: 50 DDIM steps, uncertainty window [40, 50) with
   uncertainty_zigzag_centered (M=5, num_zigzag=3, members one after another),
   bf16, batch 8. Counters are set to 0 just before and read just after; each
   kernel must have launched. The sample must be finite and the uncertainty
   map of shape (10, 8, 128, 128, 3) with a positive mean. Prints images/sec
   with the card's name and power limit (information, not a claim).

The last two lines are the kernels JSON and the device JSON. ``--details``
writes every check, time and the ptxas report as JSON to PATH.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "nvidia-smi: not available"


class Recorder:
    """Stands in for a kernel wrapper during the recording forward: logs the
    call's arguments and forwards it. ``launches`` reads and writes the
    wrapper's own counter, which the wrapper increments by its module name."""

    def __init__(self, mod, name, log):
        self.mod, self.name, self.fn, self.log = mod, name, getattr(mod, name), log

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, v):
        self.fn.launches = v

    def __call__(self, *args, **kwargs):
        self.log.append((self.name, args, kwargs))
        return self.fn(*args, **kwargs)

    def __enter__(self):
        setattr(self.mod, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)


def device_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return statistics.median(times)


def bf16_ulp(t):
    import torch

    mag = t.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


SEED = 0
BATCH = 8  # images of the main-path run (phase 4)


def main() -> None:
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one H100 and check its kernels.")
    ap.add_argument("--details", help="write every check and time as JSON to this path")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's kernels run only on a CUDA card")
    from diffusion_uncertainty_torch import kernels
    from diffusion_uncertainty_torch.diffusion import SamplerConfig, make_schedule, sample_ddim
    from diffusion_uncertainty_torch.kernels import attention as katt
    from diffusion_uncertainty_torch.kernels import avgpool as kpool
    from diffusion_uncertainty_torch.kernels import groupnorm as kgn
    from diffusion_uncertainty_torch.kernels import interleave as kilv
    from diffusion_uncertainty_torch.models import ADMUNet, ADMUNetConfig
    from diffusion_uncertainty_torch.models.layers import split_qkv
    from diffusion_uncertainty_torch.ops.groupnorm import _reference_impl
    from diffusion_uncertainty_torch.uncertainty import EstimatorConfig, make_estimator
    from diffusion_uncertainty_torch.utils import TorchNoise

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)
    details: dict = {"card": card}

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    print(f"[1] build: {build_s:.1f} s ({', '.join(kernels.SOURCES)}) on {card}", flush=True)
    details["build_s"] = build_s
    details["ptxas"] = dict(kernels._build.build_logs)

    # ---- model + recording forward (phase 3's card run) ----------------
    cfg = ADMUNetConfig.imagenet128()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.device(dev):
        model = ADMUNet(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    model = model.to(dtype=torch.bfloat16, memory_format=torch.channels_last).eval()
    n_params = sum(p.numel() for p in model.parameters())
    x2 = torch.randn(2, 128, 128, 3, generator=gen, device=dev).to(torch.bfloat16)
    y2 = torch.randint(0, cfg.num_classes, (2,), generator=gen, device=dev)

    log: list = []
    kernels.reset_launch_counts()
    with torch.no_grad(), Recorder(kgn, "gn_stats", log), Recorder(kgn, "gn_apply", log), \
            Recorder(katt, "attention", log), Recorder(kpool, "avg_pool_2x2", log), Recorder(kilv, "interleave_2x", log):
        t0 = time.perf_counter()
        out_gpu = model(x2, 500, y2)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    fwd_counts = kernels.launch_counts()

    # ---- phase 2: every kernel against its plain version -----------------
    sigs = {"gn": [], "attention": [], "avg_pool_2x2": [], "interleave_2x": []}
    pending = None
    for name, a, kw in log:
        if name == "gn_stats":
            x, g = a[0], a[3]
            pending = (x.shape[1], x.shape[2], x.shape[3], g, a[5] is not None if len(a) > 5 else kw.get("scale") is not None)
        elif name == "gn_apply":
            silu = a[3] if len(a) > 3 else kw.get("apply_silu", True)
            sigs["gn"].append(pending + (bool(silu),))
        elif name == "attention":
            q = a[0]
            sigs["attention"].append((q.shape[1], q.shape[2], q.shape[3], q.stride(2) == 3 * q.shape[3]))
        elif name == "avg_pool_2x2":
            sigs["avg_pool_2x2"].append(tuple(a[0].shape[1:]))
        else:
            sigs["interleave_2x"].append(tuple(a[0].shape[1:]) + (a[0] is a[1],))
    sigs = {k: sorted(set(v)) for k, v in sigs.items()}
    print(f"[2] main-path shapes: " + ", ".join(f"{k} {len(v)}" for k, v in sigs.items()), flush=True)

    err = {k: 0.0 for k in ("gn_stats", "gn_apply", "attention", "avg_pool_2x2", "interleave_2x")}
    ms = {k: 0.0 for k in err}
    plain_ms = {k: 0.0 for k in err}
    rows = []

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def note(kernel, e, batch, dtype, k_ms=None, p_ms=None, shape=None, tol=None):
        err[kernel] = max(err[kernel], e)
        if batch == 8 and dtype == torch.bfloat16 and k_ms is not None:
            ms[kernel] += k_ms
            plain_ms[kernel] += p_ms
        rows.append({"kernel": kernel, "batch": batch, "dtype": str(dtype).split(".")[-1], "shape": shape,
                     "max_abs_err": e, "tol": tol, "ms": k_ms, "plain_ms": p_ms})

    for batch in (2, 8):
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16
            for h, w, c, groups, ss, silu in sigs["gn"]:
                x = rnd(batch, h, w, c, dtype=dtype)
                gamma, beta = rnd(c, dtype=dtype, scale=0.1, shift=1.0), rnd(c, dtype=dtype, scale=0.1)
                sc = rnd(batch, c, dtype=dtype, scale=0.1) if ss else None
                sh = rnd(batch, c, dtype=dtype, scale=0.1) if ss else None
                a, b = kgn.gn_stats(x, gamma, beta, groups, 1e-5, sc, sh)
                ap_, bp_ = kgn.gn_stats_plain(x, gamma, beta, groups, 1e-5, sc, sh)
                y = kgn.gn_apply(x, a, b, silu)
                ref = _reference_impl(x, gamma, beta, groups, 1e-5, sc, sh, silu).float()
                e_pair = (y.float() - ref).abs()
                tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
                bound = tol + (2.0**-7 * ref.abs() if dtype == torch.bfloat16 else 0.0)
                if not bool((e_pair <= bound).all()):
                    fail(f"GroupNorm pair disagrees at {(batch, h, w, c, groups, ss, silu, dtype)}: max err {float(e_pair.max())}")
                e_stats = max(float((a - ap_).abs().max()), float((b - bp_).abs().max()))
                if e_stats > 1e-3:
                    fail(f"gn_stats disagrees at {(batch, h, w, c, groups)}: {e_stats}")
                shape = [batch, h, w, c, groups, ss, silu]
                k1 = p1 = k2 = p2 = None
                if timed:
                    k1 = device_ms(lambda: kgn.gn_stats(x, gamma, beta, groups, 1e-5, sc, sh))
                    p1 = device_ms(lambda: kgn.gn_stats_plain(x, gamma, beta, groups, 1e-5, sc, sh))
                    k2 = device_ms(lambda: kgn.gn_apply(x, a, b, silu))
                    p2 = device_ms(lambda: kgn.gn_apply_plain(x, a, b, silu))
                note("gn_stats", e_stats, batch, dtype, k1, p1, shape, 1e-3)
                note("gn_apply", float(e_pair.max()), batch, dtype, k2, p2, shape, tol)
            for s, heads, d, legacy in sigs["attention"]:
                qkv = rnd(batch, s, 3 * heads * d, dtype=dtype)
                q, k, v = split_qkv(qkv, heads, legacy)
                o = katt.attention(q, k, v)
                e = float((o.float() - katt.attention_plain(q, k, v).float()).abs().max())
                tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
                if e > tol:
                    fail(f"attention disagrees at {(batch, s, heads, d, dtype)}: {e}")
                km = pm = None
                if timed:
                    km = device_ms(lambda: katt.attention(q, k, v))
                    pm = device_ms(lambda: katt.attention_plain(q, k, v))
                note("attention", e, batch, dtype, km, pm, [batch, s, heads, d, legacy], tol)
            if not timed:
                continue
            for h, w, c in sigs["avg_pool_2x2"]:
                x = rnd(batch, h, w, c)
                y, ref = kpool.avg_pool_2x2(x), kpool.avg_pool_2x2_plain(x)
                diff = (y.float() - ref.float()).abs()
                if not bool((diff <= bf16_ulp(ref)).all()):
                    fail(f"avg_pool_2x2 disagrees by more than 1 bf16 ulp at {(batch, h, w, c)}")
                km, pm = device_ms(lambda: kpool.avg_pool_2x2(x)), device_ms(lambda: kpool.avg_pool_2x2_plain(x))
                note("avg_pool_2x2", float(diff.max()), batch, dtype, km, pm, [batch, h, w, c], "1 ulp")
            for h, w, c, same in sigs["interleave_2x"]:
                ys = [rnd(batch, h, w, c)] * 4 if same else [rnd(batch, h, w, c) for _ in range(4)]
                if not torch.equal(kilv.interleave_2x(*ys), kilv.interleave_2x_plain(*ys)):
                    fail(f"interleave_2x is not bit-exact at {(batch, h, w, c)}")
                km, pm = device_ms(lambda: kilv.interleave_2x(*ys)), device_ms(lambda: kilv.interleave_2x_plain(*ys))
                note("interleave_2x", 0.0, batch, dtype, km, pm, [batch, h, w, c, same], "exact")
    torch.cuda.synchronize()
    for r in rows:
        if r["ms"] is not None:
            print(f"    {r['kernel']:<13} {r['dtype']:<8} {str(r['shape']):<40} err {r['max_abs_err']:.3g}  "
                  f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms", flush=True)
    print(f"[2] kernels agree with their plain versions at every main-path shape: max errors {err}", flush=True)

    # ---- phase 3: full-width forward against float32 on the CPU ----------
    for name, n in fwd_counts.items():
        if n <= 0:
            fail(f"forward: kernel {name} was never launched")
    t0 = time.perf_counter()
    with torch.device("meta"):
        cpu_model = ADMUNet(cfg)
    cpu_model.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()}, assign=True)
    cpu_model.eval()
    with torch.no_grad():
        ref = cpu_model(x2[:1].float().cpu(), 500, y2[:1].cpu())
    cpu_s = time.perf_counter() - t0
    del cpu_model
    got = out_gpu[:1].float().cpu()
    if not bool(torch.isfinite(got).all()):
        fail("forward: non-finite output on the card")
    rel_l2 = float((got - ref).norm() / ref.norm())
    print(f"[3] ADM-128 forward ({n_params / 1e6:.1f}M params, bf16, batch 2): {fwd_s:.2f} s first call; "
          f"image 0 vs float32 CPU (batch 1, {cpu_s:.1f} s): rel L2 {rel_l2:.3e} (limit 2e-2)", flush=True)
    print(f"[3] kernels {json.dumps(fwd_counts)}", flush=True)
    if not rel_l2 <= 2e-2:
        fail(f"forward: relative L2 error {rel_l2} > 2e-2")
    details.update(n_params=n_params, forward_rel_l2=rel_l2, forward_launches=fwd_counts)

    # ---- phase 4: the main path ------------------------------------------
    B = BATCH
    yb = torch.randint(0, cfg.num_classes, (B,), generator=gen, device=dev)
    x_T = torch.randn(B, 128, 128, 3, generator=gen, device=dev).to(torch.bfloat16)
    sched = make_schedule("linear", 1000, device=dev)
    scfg = SamplerConfig(num_inference_steps=50, after_step=40, num_steps_uc=10)
    est = make_estimator(EstimatorConfig(name="uncertainty_zigzag_centered", M=5, num_zigzag=3, ensemble_chunk=1))
    model_fn = lambda x, t, _: model(x, t, yb)[..., :3]  # noqa: E731
    with torch.no_grad():
        model_fn(x_T, 999, None)  # warm-up at this batch
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = sample_ddim(model_fn, sched, x_T, TorchNoise(SEED + 1, dev), scfg, estimator=est)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for name, n in launches.items():
        if n <= 0:
            fail(f"main path: kernel {name} was never launched")
    if not bool(torch.isfinite(res.sample.float()).all()):
        fail("main path: non-finite sample")
    u = res.uncertainty
    if tuple(u.shape) != (10, B, 128, 128, 3):
        fail(f"main path: uncertainty shape {tuple(u.shape)}")
    u_mean = float(u.mean())
    if not (math.isfinite(u_mean) and u_mean > 0):
        fail(f"main path: uncertainty mean {u_mean}")
    ips = B / wall
    print(f"[4] main path: 50 DDIM steps, zigzag M=5 x3 in [40, 50), bf16, batch {B}: {wall:.2f} s, "
          f"{ips:.4f} images/s on {card} (information, not a claim); uncertainty mean {u_mean:.4e}", flush=True)
    print(f"[4] kernels {json.dumps(launches)}", flush=True)
    details.update(main_path_s=wall, images_per_s=ips, main_path_launches=launches, uncertainty_mean=u_mean,
                   checks=rows)

    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)), exist_ok=True)
        with open(args.details, "w") as f:
            json.dump(details, f, indent=1, default=str)

    src = "diffusion_uncertainty_torch/kernels/csrc/"
    meta = {
        "gn_stats": (src + "groupnorm.cu", "diffusion_uncertainty_tpu/ops/groupnorm.py:454"),
        "gn_apply": (src + "groupnorm.cu", "diffusion_uncertainty_tpu/ops/groupnorm.py:65"),
        "attention": (src + "attention.cu", "diffusion_uncertainty_tpu/ops/flash_attention.py:87"),
        "avg_pool_2x2": (src + "avgpool.cu", "diffusion_uncertainty_tpu/ops/avgpool.py:30"),
        "interleave_2x": (src + "interleave.cu", "diffusion_uncertainty_tpu/ops/fused_upsample.py:110"),
    }
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": s, "replaces": r, "launches": launches[k],
         "max_abs_err": err[k], "ms": ms[k], "plain_ms": plain_ms[k]}
        for k, (s, r) in meta.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
