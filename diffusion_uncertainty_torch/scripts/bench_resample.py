"""The avg-pool and interleave kernels at every site of the ADM-128, SD 1.5 and
CIFAR-10 forwards, on the card.

    python -m diffusion_uncertainty_torch.scripts.bench_resample [--json PATH]
    PYTHONPATH=<another checkout> python <this file> [--json PATH]

No JAX counterpart. The sites are the shapes the models' up and down
resampling gives the two kernels at each main path's batch (``sites``; ADM-128
at 8, the SD 1.5 UNet at 2, the CIFAR-10 UNet at 128), in bf16. Each form a
path runs is timed (``measure``): the pool of one tensor and of a pair (ADM's
down ResBlock), the phase interleave, the nearest upsample and their pair
(ADM's up ResBlock). Per form: ``ms``, CUDA events around 10 back-to-back
wrapper calls; ``device_only_ms``, the same calls captured once in a CUDA
graph and timed by its replays; ``host_us``, the wrapper's host time a call;
the plain version's ms, the library call's ms (``F.avg_pool2d``;
``F.interpolate`` nearest; a stack/permute/reshape copy for the phase
interleave; two calls for a pair), the bound (bytes moved, each input read
once and each output written once, over 3.35 TB/s) and the route the launch
took. Run with another checkout first on the path, it times that checkout's
kernels with this file's clocks; where that checkout's wrappers have no
paired or nearest form, a pair is two calls and a nearest upsample the
interleave of four copies.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# bytes moved by a form, in units of one input tensor's bytes
BOUND_INPUTS = {("pool", "single"): 1.25, ("pool", "pair"): 2.5, ("interleave", "phase"): 8.0,
                ("interleave", "nearest"): 5.0, ("interleave", "pair"): 13.0}
FORMS = {"pool": ("single", "pair"), "interleave": ("phase", "nearest", "pair")}
BATCHES = {"adm": 8, "sd": 2, "cifar": 128}


def _clocks():
    """``device_ms``, ``graph_ms``, ``host_us`` of this file's checkout (a
    standalone module: the package on the path may be another checkout's)."""
    path = Path(__file__).resolve().parents[1] / "utils" / "device.py"
    spec = importlib.util.spec_from_file_location("_bench_resample_clocks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_ms, mod.graph_ms, mod.host_us


def sites() -> dict[str, dict[str, list[tuple]]]:
    """{model: {"pool": shapes, "interleave": shapes}} of [n, h, w, c] kernel
    inputs, in forward order: ADM-128's down ResBlocks pool [8, s, s, c] at
    every level but the last, its up ResBlocks interleave at every level but
    the first; the SD 1.5 and CIFAR-10 UNets' up-samplers interleave after
    every up block but the last."""
    from diffusion_uncertainty_torch.models import ADMUNetConfig, SDUNetConfig, UNet2DConfig

    adm = ADMUNetConfig.imagenet128()
    chans = [adm.model_channels * m for m in adm.channel_mult]
    res = [adm.image_size >> level for level in range(len(chans))]
    out = {"adm": {"pool": [(BATCHES["adm"], res[i], res[i], chans[i]) for i in range(len(chans) - 1)],
                   "interleave": [(BATCHES["adm"], res[i], res[i], chans[i]) for i in range(len(chans) - 1, 0, -1)]}}
    for name, cfg in (("sd", SDUNetConfig.sd15()), ("cifar", UNet2DConfig.ddpm_cifar10())):
        rev = list(reversed(cfg.block_out_channels))
        n = len(rev)
        out[name] = {"pool": [], "interleave": [(BATCHES[name], cfg.sample_size >> (n - 1 - bi), cfg.sample_size >> (n - 1 - bi),
                                                 rev[bi]) for bi in range(n - 1)]}
    return out


def calls(kpool, kilv, kind: str, form: str, ts: list):
    """(kernel call, plain call, library call) of a form on inputs ts."""
    if kind == "pool":
        x = ts[0]
        xs = [t.permute(0, 3, 1, 2) for t in ts]
        if form == "single":
            return (lambda: kpool.avg_pool_2x2(x)), (lambda: kpool.avg_pool_2x2_plain(x)), (lambda: F.avg_pool2d(xs[0], 2))
        pair = getattr(kpool, "avg_pool_2x2_pair", lambda a, b: (kpool.avg_pool_2x2(a), kpool.avg_pool_2x2(b)))
        return ((lambda: pair(*ts)), (lambda: [kpool.avg_pool_2x2_plain(t) for t in ts]),
                (lambda: [F.avg_pool2d(t, 2) for t in xs]))
    nearest = getattr(kilv, "nearest_2x", lambda x: kilv.interleave_2x(x, x, x, x))

    def copy():  # the phase interleave as one stack/permute/reshape copy
        n, h, w, c = ts[0].shape
        st = torch.stack([torch.stack(ts[:2]), torch.stack(ts[2:4])])
        return st.permute(2, 3, 0, 4, 1, 5).reshape(n, 2 * h, 2 * w, c)

    def interp():
        return F.interpolate(ts[-1].permute(0, 3, 1, 2), scale_factor=2, mode="nearest")

    x = ts[-1]
    if form == "phase":
        return (lambda: kilv.interleave_2x(*ts)), (lambda: kilv.interleave_2x_plain(*ts)), copy
    if form == "nearest":
        return (lambda: nearest(x)), (lambda: kilv.interleave_2x_plain(x, x, x, x)), interp
    pair = getattr(kilv, "interleave_2x_pair", lambda ys, x: (kilv.interleave_2x(*ys), nearest(x)))
    return ((lambda: pair(ts[:4], x)), (lambda: (kilv.interleave_2x_plain(*ts[:4]), kilv.interleave_2x_plain(x, x, x, x))),
            (lambda: (copy(), interp())))


def inputs(kind: str, form: str, shape, gen, dtype=torch.bfloat16) -> list:
    count = {"single": 1, "pair": 2 if kind == "pool" else 5, "phase": 4, "nearest": 1}[form]
    return [torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(count)]


def route_of(mod, fn) -> str:
    """The route counters' change over one call of fn ('-' where the module
    has none)."""
    counts = getattr(mod, "ROUTE_LAUNCHES", None)
    if counts is None:
        return "-"
    before = dict(counts)
    fn()
    return "+".join(f"{k}" for k, v in counts.items() if v > before.get(k, 0)) or "-"


def measure(kpool, kilv, kind: str, form: str, shape, gen, clocks=None, dtype=torch.bfloat16) -> dict:
    """One form at one site in ``dtype``: its times, bound and route (module
    docstring)."""
    device_ms, graph_ms, host_us = clocks or _clocks()
    ts = inputs(kind, form, shape, gen, dtype)
    fn, plain, lib = calls(kpool, kilv, kind, form, ts)
    nbytes = ts[0].numel() * ts[0].element_size()
    return {"kernel": "avg_pool_2x2" if kind == "pool" else "interleave_2x", "form": form, "shape": list(shape),
            "route": route_of(kpool if kind == "pool" else kilv, fn), "ms": device_ms(fn),
            "device_only_ms": graph_ms(fn), "host_us": host_us(fn), "plain_ms": device_ms(plain),
            "library_ms": device_ms(lib), "bound_ms": BOUND_INPUTS[(kind, form)] * nbytes / HBM_BYTES_PER_S * 1e3}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="write every row and the sums to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_resample: needs a CUDA card")
    from diffusion_uncertainty_torch.kernels import avgpool as kpool
    from diffusion_uncertainty_torch.kernels import interleave as kilv

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    clocks = _clocks()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for model, by_kind in sites().items():
        for kind, shapes in by_kind.items():
            for shape in shapes:
                for form in FORMS[kind] if model == "adm" else ("phase",):
                    r = measure(kpool, kilv, kind, form, shape, gen, clocks)
                    rows.append({"model": model, **r})
                    print(f"{model:<5} {r['kernel']:<13} {form:<7} {str(shape):<20} route {r['route']:<10} "
                          f"{r['ms']:.4f} ms  device-only {r['device_only_ms']:.4f}  host {r['host_us']:.2f} us  "
                          f"plain {r['plain_ms']:.4f}  library {r['library_ms']:.4f}  bound {r['bound_ms']:.4f}", flush=True)
    sums = {}
    for r in rows:
        t = sums.setdefault(f"{r['model']} {r['kernel']} {r['form']}", {"shapes": 0})
        t["shapes"] += 1
        for key in ("ms", "device_only_ms", "host_us", "plain_ms", "library_ms", "bound_ms"):
            t[key] = t.get(key, 0.0) + r[key]
    for key, t in sums.items():
        print(f"sum {key:<32} {t['shapes']} shapes  {t['ms']:.4f} ms  device-only {t['device_only_ms']:.4f}  "
              f"host {t['host_us']:.2f} us  plain {t['plain_ms']:.4f}  library {t['library_ms']:.4f}  "
              f"bound {t['bound_ms']:.4f}", flush=True)
    print(card, flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "rows": rows, "sums": sums}, indent=1))


if __name__ == "__main__":
    main()
