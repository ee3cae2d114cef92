"""The Winograd conv kernel at the main-path shapes, and the GroupNorm
wrapper's host time against its device time, on the card.

    python -m diffusion_uncertainty_torch.scripts.bench_winograd [--json PATH]

No JAX counterpart. Builds ``kernels/csrc/winograd.cu`` and
``groupnorm.cu``, prints each kernel instance's ptxas registers and spills,
then:

* Winograd: at every 3x3 conv shape the CIFAR-10 UNet gives it at batch 128
  (the CLI batch) and 640 (the folded M=5 window forward), and the
  ADM-128 ResBlock conv shapes at batch 8, draws seeded random bf16 inputs,
  holds ``winograd_conv`` to ``winograd_conv_plain`` (max error <= 2 bf16
  ulps of max|plain|, relative L2 <= 5e-3) and times it (CUDA events,
  median of 5 x 10 back-to-back calls) against ``F.conv2d`` on
  channels_last bf16 views plus the residual add (cuDNN; the TF32 switches
  are printed, and do not touch bf16 convs), with the bound max(bytes /
  3.35 TB/s, 2 x 16 x tiles x C x K / 989 TFLOP/s).
* GroupNorm (the SD 1.5 UNet's 19 GroupNorm calls at batch 2, each shape
  once): ``torch.profiler`` over 20 forwards' worth of calls of the
  one-launch route (``group_norm``) and of the pair (``gn_stats`` +
  ``gn_apply``, the route every GroupNorm took before the one-launch
  kernel): host microseconds per GroupNorm (the host clock over the calls,
  issued back to back without a synchronize) against device microseconds
  (the kernels' CUDA time in the profiler), and the launches per GroupNorm.
* Shares: where the Winograd kernel's time goes. Builds three variants
  of ``csrc/winograd.cu`` (text patches, into ``kernels/_build/``): without
  the input transform's loop (V is left as it is), without the products
  (no wgmma), and without both, and times each against the kernel at the
  CIFAR-10 shapes at batch 128. The differences are the shares the transform
  and the products add on top of the pipeline's loads, exchange and
  epilogue (the variants' outputs are wrong by design and not checked).

Exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from ..kernels import _build, build
from ..kernels import groupnorm as kgn
from ..kernels import winograd as kwino
from ..utils.device import device_ms

HBM = 3.35e12
BF16 = 989e12
# (H, W, C, K, residual) of the CIFAR-10 UNet's Winograd sites
CIFAR = (
    (32, 32, 128, 128, False), (32, 32, 128, 128, True), (32, 32, 256, 128, False), (32, 32, 384, 128, False),
    (16, 16, 128, 256, False), (16, 16, 256, 256, False), (16, 16, 256, 256, True), (16, 16, 384, 256, False),
    (16, 16, 512, 256, False), (8, 8, 256, 256, False), (8, 8, 256, 256, True), (8, 8, 512, 256, False),
    (4, 4, 256, 256, False), (4, 4, 256, 256, True), (4, 4, 512, 256, False),
)
# the ADM-128 ResBlock convs the route serves (chip_smoke.py's information rows)
ADM = (
    (128, 128, 256, 256, False), (128, 128, 256, 256, True), (64, 64, 256, 256, False), (64, 64, 256, 256, True),
    (64, 64, 512, 512, True), (64, 64, 768, 256, False), (32, 32, 256, 256, False), (32, 32, 256, 256, True),
    (32, 32, 256, 512, False), (32, 32, 512, 512, False), (32, 32, 512, 512, True), (32, 32, 768, 512, False),
    (32, 32, 768, 768, True), (32, 32, 1280, 512, False), (16, 16, 512, 512, False), (16, 16, 512, 512, True),
    (16, 16, 512, 768, False), (16, 16, 768, 768, False), (16, 16, 768, 768, True), (16, 16, 1024, 1024, True),
    (16, 16, 1280, 768, False), (16, 16, 1792, 768, False), (8, 8, 768, 768, False), (8, 8, 768, 768, True),
    (8, 8, 768, 1024, False), (8, 8, 1024, 1024, False), (8, 8, 1024, 1024, True), (8, 8, 1792, 1024, False),
)
# (H, W, C, groups, eps, silu) of the SD 1.5 UNet's GroupNorm calls at batch 2
SD_GN = (
    (64, 64, 320, 32, 1e-5, True), (64, 64, 320, 32, 1e-6, False), (64, 64, 320, 32, 1e-6, True),
    (64, 64, 640, 32, 1e-6, True), (64, 64, 960, 32, 1e-6, True), (32, 32, 320, 32, 1e-6, True),
    (32, 32, 640, 32, 1e-6, False), (32, 32, 640, 32, 1e-6, True), (32, 32, 960, 32, 1e-6, True),
    (32, 32, 1280, 32, 1e-6, True), (32, 32, 1920, 32, 1e-6, True), (16, 16, 640, 32, 1e-6, True),
    (16, 16, 1280, 32, 1e-6, False), (16, 16, 1280, 32, 1e-6, True), (16, 16, 1920, 32, 1e-6, True),
    (16, 16, 2560, 32, 1e-6, True), (8, 8, 1280, 32, 1e-6, False), (8, 8, 1280, 32, 1e-6, True),
    (8, 8, 2560, 32, 1e-6, True),
)


def bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(abs(v), 2.0**-126))) - 7)


def bench_conv(model, batch, h, w, c, k, has_res, gen, dev, timed=True):
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(torch.bfloat16)  # noqa: E731
    x, wt, b = r(batch, h, w, c), r(k, c, 3, 3, scale=0.05), r(k)
    res = r(batch, h, w, k) if has_res else None
    u, b32 = kwino.weight_transform(wt), b.float()
    got = kwino.winograd_conv(x, u, b32, res).float()
    ref = kwino.winograd_conv_plain(x, u, b32, res).float()
    err, ref_max = float((got - ref).abs().max()), float(ref.abs().max())
    rel = float((got - ref).norm() / ref.norm())
    row = {"model": model, "batch": batch, "shape": [h, w, c, k, has_res], "max_abs_err": err, "plain_max": ref_max,
           "rel_l2": rel, "ok": err <= 2 * bf16_ulp(ref_max) and rel <= 5e-3}
    if timed:
        xcl, wcl = x.permute(0, 3, 1, 2), wt.contiguous(memory_format=torch.channels_last)
        rcl = res.permute(0, 3, 1, 2) if has_res else None

        def library():
            y = F.conv2d(xcl, wcl, b, padding=1)
            return y if rcl is None else y.add_(rcl)

        n_bytes = (x.numel() + batch * h * w * k * (2 if has_res else 1)) * 2 + u.numel() * 2 + k * 4
        flops = 2.0 * 16 * batch * (h // 2) * (w // 2) * c * k
        row.update(ms=device_ms(lambda: kwino.winograd_conv(x, u, b32, res)), library_ms=device_ms(library),
                   bound_ms=max(n_bytes / HBM, flops / BF16) * 1e3)
        row["tflops"] = flops / row["ms"] / 1e9
    return row


def profile_gn(route: str, gen, dev, reps: int = 20) -> dict:
    """Host and device microseconds per GroupNorm over the SD shapes."""
    from torch.profiler import ProfilerActivity, profile

    calls = []
    for h, w, c, g, eps, silu in SD_GN:
        x = torch.randn(2, h, w, c, generator=gen, device=dev).to(torch.bfloat16)
        gamma = (1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        beta = (0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        calls.append((x, gamma, beta, g, eps, silu))

    def one(x, gamma, beta, g, eps, silu):
        if route == "pair":
            return kgn.gn_apply(x, *kgn.gn_stats(x, gamma, beta, g, eps), silu)
        return kgn.group_norm(x, gamma, beta, g, eps, None, None, silu)

    for a in calls:  # warm-up: builds, attributes, caches
        one(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for a in calls:
            one(*a)
    host_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for a in calls:
                one(*a)
        torch.cuda.synchronize()
    n = reps * len(calls)
    device_us = launches = 0.0
    names = set()
    for ev in prof.key_averages():  # only the GroupNorm kernels ran on the card in the window
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device_us += getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0.0)
            launches += ev.count
            names.add(ev.key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].replace("void ", ""))
    return {"route": route, "calls": n, "host_us_per_gn": host_wall / n * 1e6, "device_us_per_gn": device_us / n,
            "launches_per_gn": launches / n, "kernels": sorted(names)}


# text patches of csrc/winograd.cu for --shares: each turns one loop's trip count to 0
_NO_TRANSFORM = ("      for (int q = 0; q < 4; ++q) {\n        const int p0 = ", "      for (int q = 0; q < 0; ++q) {\n        const int p0 = ")
_NO_PRODUCTS = ("        for (int a = 0; a < kPos; ++a) {\n#pragma unroll\n          for (int kk",
                "        for (int a = 0; a < 0; ++a) {\n#pragma unroll\n          for (int kk")


def _variant(name: str, patches) -> ctypes.CDLL:
    """``csrc/winograd.cu`` with ``patches`` applied, built into ``_build/``."""
    src = (_build.CSRC / "winograd.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"bench_winograd --shares: the source no longer has the loop a patch removes: {old!r}")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = _build.BUILD_DIR / f"winograd_{name}.cu", _build.BUILD_DIR / f"libwinograd_{name}.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.du_winograd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.du_winograd.restype = ctypes.c_int
    lib.du_error_string.argtypes = [ctypes.c_int]
    lib.du_error_string.restype = ctypes.c_char_p
    return lib


def shares(gen, dev) -> list:
    """Kernel time with and without the transform and the products, CIFAR-10 shapes at batch 128."""
    libs = {"kernel": kwino._lib(), "no_transform": _variant("no_transform", [_NO_TRANSFORM]),
            "no_products": _variant("no_products", [_NO_PRODUCTS]),
            "neither": _variant("neither", [_NO_TRANSFORM, _NO_PRODUCTS])}
    rows = []
    for h, w, c, k, has_res in CIFAR:
        n = 128
        x = torch.randn(n, h, w, c, generator=gen, device=dev).to(torch.bfloat16)
        u = kwino.weight_transform((0.05 * torch.randn(k, c, 3, 3, generator=gen, device=dev)).to(torch.bfloat16))
        b = torch.randn(k, generator=gen, device=dev)
        res = torch.randn(n, h, w, k, generator=gen, device=dev).to(torch.bfloat16) if has_res else None
        out = torch.empty(n, h, w, k, device=dev, dtype=torch.bfloat16)
        row = {"shape": [h, w, c, k, has_res]}
        for name, lib in libs.items():
            def call(lib=lib, name=name):
                err = lib.du_winograd(x.data_ptr(), u.data_ptr(), b.data_ptr(), None if res is None else res.data_ptr(),
                                      out.data_ptr(), n, h, w, c, k, u.shape[0] * kwino.K_ALIGN, 1, _build.stream_ptr(x))
                _build.check(lib, err, f"winograd {name}")

            row[name] = device_ms(call)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Check and time the Winograd kernel; profile the GroupNorm wrapper.")
    ap.add_argument("--json", help="write every row as JSON to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_winograd needs a CUDA card")
    dev = torch.device("cuda")
    build(("winograd", "groupnorm"))
    for src in ("winograd", "groupnorm"):
        for inst in _build.ptxas_report(src):
            print(f"ptxas {src} {inst}", flush=True)
    print(f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32} "
          "(bf16 convs do not use TF32)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, ok = [], True
    for model, batch, shapes in (("cifar", 128, CIFAR), ("cifar", 640, CIFAR), ("adm", 8, ADM)):
        for shape in shapes:
            row = bench_conv(model, batch, *shape, gen, dev)
            rows.append(row)
            ok &= row["ok"]
            print(f"{'ok ' if row['ok'] else 'BAD'} {model:<5} b{batch:<4} {str(row['shape']):<30} err {row['max_abs_err']:.3g} "
                  f"(max|plain| {row['plain_max']:.4g})  rel L2 {row['rel_l2']:.3e}  {row['ms']:.4f} ms  "
                  f"cuDNN {row['library_ms']:.4f}  bound {row['bound_ms']:.4f}  ({row['ms'] / row['library_ms']:.2f}x cuDNN, "
                  f"{row['tflops']:.1f} TFLOP/s)", flush=True)
        sel = [r for r in rows if r["model"] == model and r["batch"] == batch]
        ms, lib, bound = (sum(r[key] for r in sel) for key in ("ms", "library_ms", "bound_ms"))
        print(f"sum {model} batch {batch}, {len(sel)} shapes: {ms:.4f} ms, cuDNN {lib:.4f} ms ({ms / lib:.2f}x), "
              f"bound {bound:.4f} ms", flush=True)
    gn = []
    for route in ("pair", "one_launch"):
        p = profile_gn(route, gen, dev)
        gn.append(p)
        print(f"GroupNorm {route:<10} SD shapes, batch 2: host {p['host_us_per_gn']:.2f} us per GroupNorm, device "
              f"{p['device_us_per_gn']:.2f} us, {p['launches_per_gn']:.2f} launches ({', '.join(p['kernels'])})",
              flush=True)
    share_rows = shares(gen, dev)
    for r in share_rows:
        print(f"shares {str(r['shape']):<26} kernel {r['kernel']:.4f} ms  without transform {r['no_transform']:.4f}  "
              f"without products {r['no_products']:.4f}  without both {r['neither']:.4f}", flush=True)
    t = {key: sum(r[key] for r in share_rows) for key in ("kernel", "no_transform", "no_products", "neither")}
    print(f"shares sum over the CIFAR-10 shapes, batch 128: kernel {t['kernel']:.4f} ms; the transform adds "
          f"{t['kernel'] - t['no_transform']:.4f} (alone {t['no_products'] - t['neither']:.4f}), the products "
          f"{t['kernel'] - t['no_products']:.4f} (alone {t['no_transform'] - t['neither']:.4f}); loads, exchange and "
          f"epilogue {t['neither']:.4f}", flush=True)
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"winograd": rows, "group_norm_profile": gn, "shares": share_rows}, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
