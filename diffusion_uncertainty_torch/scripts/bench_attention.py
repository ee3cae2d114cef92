"""Every attention shape of the port's main paths, on the card: route, error
against the plain version, and times against ``F.scaled_dot_product_attention``.

    python -m diffusion_uncertainty_torch.scripts.bench_attention [--json PATH] [--no-time]

No JAX counterpart. Builds ``kernels/csrc/attention.cu``, then for each shape
(the ones ``chip_smoke.py`` phase 2 records from the full-width forwards:
ADM-128 at batch 8, the SD 1.5 UNet at batch 2 and its M=5 ensemble batch
10, the SD VAE at batch 1 in float32 and bf16, the CIFAR-10 UNet at batch
128, the joint attention of SD3-medium, SD3.5-large (D=64) and Flux-dev
(D=128) over 1040 tokens at the CFG / plain batch and the folded M=5
ensemble; and a few with keys masked by kv_len inside the last key tile and
split, which SDPA times without the mask) draws seeded random q, k, v, runs ``kernels.attention.attention`` once,
and holds it to ``attention_plain`` (bf16: max error <= 2^-6·max|plain| and
relative L2 <= 5e-3; float32: max error <= 1e-4·max|plain|) and, on the wide
route, to ``attention_split_plain`` at the split count the wrapper picks.
Then times (CUDA events, median of 5 x 10 back-to-back calls) the kernel,
the plain version and SDPA, and prints the route each launch took and the
ptxas report of each kernel instance. Exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels import attention as katt
from ..kernels import build, reset_launch_counts, route_counts
from ..models.layers import split_qkv
from ..utils.device import device_ms

# (model, batch, dtype, S, S_kv, heads, head dim, layout, kv_len); "mask":
# keys masked by kv_len inside the last key tile (and, on the wide route,
# inside the last split), outside the sums
SHAPES = (
    ("sd", 2, "bfloat16", 4096, 4096, 8, 40, "separate", None),
    ("sd", 2, "bfloat16", 4096, 77, 8, 40, "separate", None),
    ("sd", 2, "bfloat16", 1024, 1024, 8, 80, "separate", None),
    ("sd", 2, "bfloat16", 1024, 77, 8, 80, "separate", None),
    ("sd", 2, "bfloat16", 256, 256, 8, 160, "separate", None),
    ("sd", 2, "bfloat16", 256, 77, 8, 160, "separate", None),
    ("sd", 2, "bfloat16", 64, 64, 8, 160, "separate", None),
    ("sd", 2, "bfloat16", 64, 77, 8, 160, "separate", None),
    ("sd", 10, "bfloat16", 4096, 4096, 8, 40, "separate", None),
    ("vae", 1, "float32", 4096, 4096, 1, 512, "separate", None),
    ("vae", 1, "bfloat16", 4096, 4096, 1, 512, "separate", None),
    ("adm", 8, "bfloat16", 1024, 1024, 4, 128, "legacy", None),
    ("adm", 8, "bfloat16", 256, 256, 4, 192, "legacy", None),
    ("adm", 8, "bfloat16", 64, 64, 4, 256, "legacy", None),
    ("cifar", 128, "bfloat16", 16, 16, 1, 256, "separate", None),
    ("cifar", 128, "bfloat16", 256, 256, 1, 256, "separate", None),
    # the flow-matching transformers' joint attention at the t2i CLI's
    # defaults (1024 image + 16 text tokens): the plain (CFG) batch, then the
    # folded M=5 ensemble
    ("sd3", 2, "bfloat16", 1040, 1040, 24, 64, "separate", None),
    ("sd3", 10, "bfloat16", 1040, 1040, 24, 64, "separate", None),
    ("sd35", 2, "bfloat16", 1040, 1040, 38, 64, "separate", None),
    ("sd35", 10, "bfloat16", 1040, 1040, 38, 64, "separate", None),
    ("flux", 1, "bfloat16", 1040, 1040, 24, 128, "separate", None),
    ("flux", 5, "bfloat16", 1040, 1040, 24, 128, "separate", None),
    ("mask", 2, "bfloat16", 1024, 128, 8, 40, "separate", 77),
    ("mask", 2, "bfloat16", 200, 200, 4, 160, "legacy", 150),
    ("mask", 1, "float32", 4096, 4096, 1, 512, "separate", 3999),
    ("mask", 1, "bfloat16", 256, 128, 2, 512, "separate", 77),
    ("mask", 1, "float32", 100, 300, 3, 264, "separate", 290),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Check and time the attention kernels at the main-path shapes.")
    ap.add_argument("--json", help="write every row as JSON to this path")
    ap.add_argument("--no-time", action="store_true", help="check only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention needs a CUDA card")
    dev = torch.device("cuda")
    build(("attention",))
    for inst in _build.ptxas_report("attention"):
        print(f"ptxas {inst}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, ok = [], True
    for model, batch, dt, s, s_kv, heads, d, layout, kv_len in SHAPES:
        dtype = getattr(torch, dt)
        if layout == "separate":
            q, k, v = (torch.randn(batch, n, heads, d, generator=gen, device=dev).to(dtype) for n in (s, s_kv, s_kv))
        else:
            q, k, v = split_qkv(torch.randn(batch, s, 3 * heads * d, generator=gen, device=dev).to(dtype), heads, True)
        reset_launch_counts()
        got = katt.attention(q, k, v, kv_len).float()
        torch.cuda.synchronize()
        routes = {r: n for r, n in route_counts().items() if n}
        ref = katt.attention_plain(q, k, v, kv_len).float()
        err = float((got - ref).abs().max())
        ref_max = float(ref.abs().max())
        rel = float((got - ref).norm() / ref.norm())
        bf16 = dtype == torch.bfloat16
        good = err <= (2.0**-6 if bf16 else 1e-4) * ref_max and (rel <= 5e-3 or not bf16)
        row = {"model": model, "batch": batch, "dtype": dt, "shape": [s, s_kv, heads, d, layout, kv_len], "routes": routes,
               "max_abs_err": err, "plain_max": ref_max, "rel_l2": rel}
        if "wide" in routes:
            n_keys = s_kv if kv_len is None else kv_len
            n = katt.split_chunk(n_keys, katt.wide_splits(batch, s, heads, n_keys))[1]
            split_ref = katt.attention_split_plain(q, k, v, kv_len, n).float()
            row["split_err"] = float((got - split_ref).abs().max())
            row["splits"] = n
        ok &= good
        if not args.no_time:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row.update(ms=device_ms(lambda: katt.attention(q, k, v, kv_len)),
                       plain_ms=device_ms(lambda: katt.attention_plain(q, k, v, kv_len)),
                       library_ms=device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)))
            row["tflops"] = 4.0 * batch * heads * s * (kv_len or s_kv) * d / row["ms"] / 1e9
        rows.append(row)
        times = "" if args.no_time else (f"  {row['ms']:.4f} ms  plain {row['plain_ms']:.4f}  SDPA {row['library_ms']:.4f}"
                                        f"  ({row['ms'] / row['library_ms']:.2f}x SDPA, {row['tflops']:.1f} TFLOP/s)")
        split = f"  vs split plain {row['split_err']:.3g} ({row['splits']} splits)" if "split_err" in row else ""
        print(f"{'ok ' if good else 'BAD'} {model:<5} b{batch:<3} {dt:<8} {str(row['shape']):<36} {routes}  "
              f"err {err:.3g} (max|plain| {ref_max:.4g})  rel L2 {rel:.3e}{split}{times}", flush=True)
        del q, k, v, got, ref
    if not args.no_time:
        for model in ("sd", "vae", "adm", "cifar", "sd3", "sd35", "flux"):
            for dt in ("bfloat16", "float32"):
                # each model's main-path batch: the first of its shapes
                main_batch = next(r["batch"] for r in rows if r["model"] == model)
                sel = [r for r in rows if r["model"] == model and r["dtype"] == dt and r["batch"] == main_batch]
                if sel:
                    ms, lib = sum(r["ms"] for r in sel), sum(r["library_ms"] for r in sel)
                    print(f"sum {model:<5} {dt:<8} {len(sel)} shapes: {ms:.4f} ms, SDPA {lib:.4f} ms ({ms / lib:.2f}x)")
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if ok and all(math.isfinite(r["max_abs_err"]) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
