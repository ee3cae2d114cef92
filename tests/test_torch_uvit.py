"""The U-ViT slice of the port against the JAX package, float32 on the CPU:
the model (``models/uvit.py``) and its converter in both weight directions,
the full-size parameter counts, attention at U-ViT's head dim 72, the
latent dataset run with its VAE decode (``sampling.generate_uncertainty_dataset``
with ``decode_fn``), the factory's U-ViT bundles and the dataset CLI on the
``imagenet256`` dataset.

Tolerances: a tiny forward within relative L2 1e-5 (float32 summation order
of the matmuls, LayerNorms and attention); attention within 1e-5 of the
largest reference output; the dataset run's decoded images and latent maps
within relative L2 1e-4 (a DDIM chain amplifies float32 rounding along its
steps, ROADMAP.md section 3), its uint8 images equal up to one step on at
most 0.1% of the pixels (a value on a rounding boundary).
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import ReplayNoise, jax_sampler_noise, make_vae_state_dict, torch_state_dict

import diffusion_uncertainty_torch.factory as tfactory
import diffusion_uncertainty_torch.sampling as tsampling
import diffusion_uncertainty_tpu.ops.attention as jattn
import diffusion_uncertainty_tpu.sampling as jsampling
from diffusion_uncertainty_torch.diffusion import SamplerConfig as TSamplerConfig
from diffusion_uncertainty_torch.diffusion import make_schedule as t_make_schedule
from diffusion_uncertainty_torch.kernels import attention as katt
from diffusion_uncertainty_torch.models import AutoencoderKL as TAutoencoderKL
from diffusion_uncertainty_torch.models import AutoencoderKLConfig as TAutoencoderKLConfig
from diffusion_uncertainty_torch.models import UViT as TUViT
from diffusion_uncertainty_torch.models import UViTConfig as TUViTConfig
from diffusion_uncertainty_torch.models import uvit_state_dict_from_flax
from diffusion_uncertainty_torch.ops import dot_product_attention
from diffusion_uncertainty_torch.scripts import generate_dataset_score_uncertainty as tcli
from diffusion_uncertainty_torch.uncertainty import EstimatorConfig as TEstimatorConfig
from diffusion_uncertainty_torch.uncertainty import make_estimator as t_make_estimator
from diffusion_uncertainty_torch.utils.experiments import load_run_arrays
from diffusion_uncertainty_torch.utils.rng import batch_seed
from diffusion_uncertainty_tpu.diffusion import SamplerConfig, make_schedule
from diffusion_uncertainty_tpu.models import AutoencoderKL, AutoencoderKLConfig, UViT, UViTConfig
from diffusion_uncertainty_tpu.models.convert import convert_autoencoder_kl, convert_uvit
from diffusion_uncertainty_tpu.scripts import generate_dataset_score_uncertainty as jcli
from diffusion_uncertainty_tpu.uncertainty import EstimatorConfig, make_estimator
from diffusion_uncertainty_tpu.utils.rng import batch_key, run_key

REPO = Path(__file__).resolve().parents[1]
FWD_REL = 1e-5
RUN_REL = 1e-4

# config fields set on top of ``tiny()`` in the forward cases
TINY_CASES = {
    "tiny": {},
    "time_mlp_final_conv": {"mlp_time_embed": True, "final_conv": True},
    "unconditional": {"num_classes": None},
}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cfgs(**kw):
    return dataclasses.replace(UViTConfig.tiny(), **kw), dataclasses.replace(TUViTConfig.tiny(), **kw)


def _random_jax_params(jcfg, seed):
    """JAX U-ViT parameters with every value random and non-zero (norm
    scales around 1)."""
    rng = np.random.RandomState(seed)
    z = jcfg.img_size
    shapes = jax.eval_shape(
        lambda k: UViT(jcfg).init(k, jnp.zeros((1, z, z, jcfg.in_chans)), jnp.asarray(0), jnp.zeros((1,), jnp.int32)),
        jax.random.key(0),
    )

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "norm" in name and "scale" in name:
            return (1.0 + rng.randn(*s.shape) * 0.1).astype(np.float32)
        return (rng.randn(*s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _uvit_reference_sd(tcfg, seed) -> dict:
    """A random reference-layout U-ViT state dict (the keys JAX
    ``convert_uvit`` reads), as numpy arrays."""
    rng = np.random.RandomState(seed)
    d, p, c = tcfg.embed_dim, tcfg.patch_size, tcfg.in_chans
    hid = int(d * tcfg.mlp_ratio)
    extras = 2 if tcfg.num_classes else 1
    sd = {}

    def put(key, *shape, around=0.0):
        sd[key] = (around + rng.randn(*shape) * (0.1 if around else 0.05)).astype(np.float32)

    def block(pfx, skip):
        for n in ("norm1", "norm2"):
            put(f"{pfx}.{n}.weight", d, around=1.0)
            put(f"{pfx}.{n}.bias", d)
        put(f"{pfx}.attn.qkv.weight", 3 * d, d)
        if tcfg.qkv_bias:
            put(f"{pfx}.attn.qkv.bias", 3 * d)
        put(f"{pfx}.attn.proj.weight", d, d)
        put(f"{pfx}.attn.proj.bias", d)
        put(f"{pfx}.mlp.fc1.weight", hid, d)
        put(f"{pfx}.mlp.fc1.bias", hid)
        put(f"{pfx}.mlp.fc2.weight", d, hid)
        put(f"{pfx}.mlp.fc2.bias", d)
        if skip:
            put(f"{pfx}.skip_linear.weight", d, 2 * d)
            put(f"{pfx}.skip_linear.bias", d)

    put("patch_embed.proj.weight", d, c, p, p)
    put("patch_embed.proj.bias", d)
    put("pos_embed", 1, extras + (tcfg.img_size // p) ** 2, d)
    if tcfg.num_classes:
        put("label_emb.weight", tcfg.num_classes, d)
    if tcfg.mlp_time_embed:
        put("time_embed.0.weight", 4 * d, d)
        put("time_embed.0.bias", 4 * d)
        put("time_embed.2.weight", d, 4 * d)
        put("time_embed.2.bias", d)
    for i in range(tcfg.depth // 2):
        block(f"in_blocks.{i}", False)
        block(f"out_blocks.{i}", True)
    block("mid_block", False)
    put("norm.weight", d, around=1.0)
    put("norm.bias", d)
    put("decoder_pred.weight", p * p * c, d)
    put("decoder_pred.bias", p * p * c)
    if tcfg.final_conv:
        put("final_layer.weight", c, c, 3, 3)
        put("final_layer.bias", c)
    return sd


def _inputs(cfg, seed, b=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, cfg.img_size, cfg.img_size, cfg.in_chans).astype(np.float32)
    t = np.array([500, 137][:b], np.int32)
    y = rng.randint(0, cfg.num_classes, size=b).astype(np.int32) if cfg.num_classes else None
    return x, t, y


def _port_forward(model, x, t, y):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t), None if y is None else torch.from_numpy(y).long()).numpy()


def _jax_forward(jcfg, params, x, t, y):
    return np.asarray(UViT(jcfg).apply(params, jnp.asarray(x), jnp.asarray(t), None if y is None else jnp.asarray(y)))


@pytest.mark.parametrize("case", sorted(TINY_CASES))
def test_tiny_forward_matches_jax(case):
    """JAX parameters carried into the port by ``uvit_state_dict_from_flax``."""
    jcfg, tcfg = _cfgs(**TINY_CASES[case])
    params = _random_jax_params(jcfg, seed=1)
    model = TUViT(tcfg)
    model.load_state_dict(uvit_state_dict_from_flax(params, tcfg))
    x, t, y = _inputs(tcfg, seed=2)
    out = _port_forward(model.eval(), x, t, y)
    ref = _jax_forward(jcfg, params, x, t, y)
    assert out.shape == ref.shape == x.shape and out.dtype == np.float32
    assert _rel_l2(out, ref) <= FWD_REL


@pytest.mark.parametrize("case", sorted(TINY_CASES))
def test_reference_state_dict_loads_on_both_sides(case):
    """A random reference-key state dict loaded by the port directly and by
    JAX through ``convert_uvit``; ``uvit_state_dict_from_flax`` gives it
    back exactly."""
    jcfg, tcfg = _cfgs(**TINY_CASES[case])
    sd = _uvit_reference_sd(tcfg, seed=3)
    model = TUViT(tcfg)
    model.load_state_dict(torch_state_dict(sd))
    params = convert_uvit(sd, jcfg)
    back = uvit_state_dict_from_flax(params, tcfg)
    assert sorted(back) == sorted(sd) == sorted(model.state_dict())
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    x, t, y = _inputs(tcfg, seed=4)
    assert _rel_l2(_port_forward(model.eval(), x, t, y), _jax_forward(jcfg, params, x, t, y)) <= FWD_REL


def test_folded_labels_repeat():
    """A batch that is a multiple of the labels' (an ensemble folded into
    the batch) takes the labels member by member, as JAX's vmap does."""
    jcfg, tcfg = _cfgs()
    params = _random_jax_params(jcfg, seed=5)
    model = TUViT(tcfg).eval()
    model.load_state_dict(uvit_state_dict_from_flax(params, tcfg))
    x, t, y = _inputs(tcfg, seed=6)
    xs = np.concatenate([x, x[::-1]])
    with torch.no_grad():
        out = model(torch.from_numpy(xs), 300, torch.from_numpy(y).long()).numpy()
    ref = _jax_forward(jcfg, params, xs, np.int32(300), np.concatenate([y, y]))
    assert _rel_l2(out, ref) <= FWD_REL
    with pytest.raises(ValueError, match="multiple"):
        model(torch.zeros(3, 8, 8, 4), 300, torch.tensor([1, 2]))


@pytest.mark.parametrize("which", ["imagenet256", "imagenet512"])
def test_full_size_parameter_count_equals_jax(which):
    jcfg, tcfg = getattr(UViTConfig, which)(), getattr(TUViTConfig, which)()
    assert dataclasses.asdict(tcfg) == {k: v for k, v in dataclasses.asdict(jcfg).items() if k not in ("dtype", "remat")}
    with torch.device("meta"):
        n_port = sum(p.numel() for p in TUViT(tcfg).parameters())
    z = jcfg.img_size
    shapes = jax.eval_shape(
        lambda k: UViT(jcfg).init(k, jnp.zeros((1, z, z, 4)), jnp.asarray(0), jnp.zeros((1,), jnp.int32)),
        jax.random.key(0),
    )
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n_port == n_jax and 450e6 < n_port < 560e6


@pytest.mark.parametrize("b,s,h", [(1, 258, 2), (2, 37, 3)], ids=["uvit_tokens", "ragged"])
def test_attention_at_head_dim_72_matches_jax(monkeypatch, b, s, h):
    """q, k, v as views of one qkv projection [B, S, 3·H·72], as U-ViT makes
    them: the port's plain version against the JAX packed-head Pallas kernel
    (interpret mode) and its XLA route."""
    d = 72
    qkv = np.random.RandomState(s).randn(b, s, 3 * h * d).astype(np.float32)
    tq = torch.from_numpy(qkv).view(b, s, 3, h, d)
    q, k, v = tq[:, :, 0], tq[:, :, 1], tq[:, :, 2]
    assert q.stride() == (s * 3 * h * d, 3 * h * d, d, 1)
    out = dot_product_attention(q, k, v).numpy()
    assert np.array_equal(out, katt.attention_plain(q, k, v).numpy())
    packed = []
    real = jattn._packed_with_xla_grad
    monkeypatch.setattr(jattn, "_packed_with_xla_grad", lambda *a: packed.append(1) or real(*a))
    jq, jk, jv = (jnp.asarray(qkv.reshape(b, s, 3, h, d)[:, :, i]) for i in range(3))
    for use_pallas in (True, False):
        ref = np.asarray(jattn.dot_product_attention(jq, jk, jv, use_pallas=use_pallas))
        np.testing.assert_allclose(out, ref, atol=1e-5 * float(np.abs(ref).max()), rtol=0, err_msg=str(use_pallas))
    assert packed == [1]  # the Pallas packed-head kernel ran
    assert katt.route(torch.bfloat16, d, True) == "tensor_core"
    # U-ViT-huge's qkv views start every row and head on 16 bytes (bf16)
    row, head = 3 * 1152 * 2, 72 * 2
    assert row % 16 == 0 and head % 16 == 0 and (1152 * 2) % 16 == 0


def _jax_bundle(jcfg, jae_cfg, params, ae_params):
    model, ae = UViT(jcfg), AutoencoderKL(jae_cfg)
    return (
        lambda p, x, t, y, k: model.apply(p["model"], x, t, y),
        lambda p, z: ae.apply(p["ae"], z, "decode"),
        {"model": params, "ae": ae_params},
    )


def test_latent_dataset_run_with_decode_matches_jax(monkeypatch, tmp_path):
    """A tiny U-ViT and the tiny VAE through both packages' generation
    loops: zigzag-centered M=2 x2, 6 DDIM steps with the window [3, 6), 3
    latents in batches of 2 (the last padded), each batch's final sample
    decoded to images before the uint8 conversion; the port replays the JAX
    run's draws. The decoded floats are read where each loop converts them
    to uint8."""
    jcfg, tcfg = _cfgs()
    jae_cfg = AutoencoderKLConfig.tiny()
    params = _random_jax_params(jcfg, seed=7)
    vae_sd = make_vae_state_dict(jae_cfg, seed=8)
    apply_fn, decode_fn, jparams = _jax_bundle(jcfg, jae_cfg, params, convert_autoencoder_kl(vae_sd, jae_cfg))
    model = TUViT(tcfg).eval()
    model.load_state_dict(uvit_state_dict_from_flax(params, tcfg))
    vae = TAutoencoderKL(TAutoencoderKLConfig.tiny()).eval()
    vae.load_state_dict(torch_state_dict(vae_sd))
    steps, after, n_uc, M, zig, seed, batch = 6, 3, 3, 2, 2, 4, 2
    rng = np.random.RandomState(9)
    x_t = rng.randn(3, 8, 8, 4).astype(np.float32)
    y = rng.randint(0, tcfg.num_classes, size=3).astype(np.int32)
    decoded = {"jax": [], "port": []}
    for side, mod in (("jax", jsampling), ("port", tsampling)):
        real = mod.to_uint8
        monkeypatch.setattr(mod, "to_uint8", lambda a, side=side, real=real: decoded[side].append(np.array(a)) or real(a))
    sched = ("scaled_linear", 1000, 0.00085, 0.012)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jres = jsampling.generate_uncertainty_dataset(
        apply_fn, make_schedule(*sched), SamplerConfig(num_inference_steps=steps, after_step=after, num_steps_uc=n_uc),
        x_t, y, batch, params=jparams, seed=seed,
        estimator=make_estimator(EstimatorConfig(name="uncertainty_zigzag_centered", M=M, num_zigzag=zig)),
        run_dir=jdir, decode_fn=decode_fn,
    )
    draws = {batch_seed(seed, b): jax_sampler_noise(batch_key(run_key(seed), b), (batch, 8, 8, 4), steps, after, n_uc, M, zig)
             for b in range(2)}
    sources = []

    def replay(s, device):
        sources.append(ReplayNoise(draws[s]))
        return sources[-1]

    with torch.no_grad():
        tres = tsampling.generate_uncertainty_dataset(
            lambda x, t, yy, nz: model(x, t, yy), t_make_schedule(*sched, device="cpu"),
            TSamplerConfig(num_inference_steps=steps, after_step=after, num_steps_uc=n_uc), x_t, y, batch, seed=seed,
            estimator=t_make_estimator(TEstimatorConfig(name="uncertainty_zigzag_centered", M=M, num_zigzag=zig)),
            run_dir=tdir, noise_factory=replay, decode_fn=vae.decode,
        )
    assert len(sources) == 2 and all(src.used == len(src.draws) == n_uc * M * zig for src in sources)
    assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    # decoded images, before uint8: [batch, 16, 16, 3] floats per batch
    assert [a.shape for a in decoded["port"]] == [a.shape for a in decoded["jax"]] == [(batch, 16, 16, 3)] * 2
    for got, want in zip(decoded["port"], decoded["jax"]):
        assert _rel_l2(got, want) <= RUN_REL
    imgs, jimgs = load_run_arrays(tdir, "gen_images").astype(int), load_run_arrays(jdir, "gen_images").astype(int)
    assert imgs.shape == (3, 16, 16, 3) and tres.gen_images.dtype == np.uint8
    diff = np.abs(imgs - jimgs)
    assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size
    # the maps and scores stay in latent space
    assert tres.uncertainty.shape == (3, n_uc, 8, 8, 4)
    for name in ("uncertainty", "score"):
        assert _rel_l2(load_run_arrays(tdir, name), load_run_arrays(jdir, name)) <= RUN_REL, name
    assert _rel_l2(tres.uncertainty, jres.uncertainty) <= RUN_REL


def _small_uvit256(cfg_cls):
    """U-ViT on the imagenet256 latents (32x32x4) at a test width."""
    return cfg_cls(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2)


def test_dataset_cli_runs_imagenet256_and_writes_jax_files(monkeypatch, tmp_path):
    """``--dataset imagenet256`` builds a U-ViT bundle and decodes its
    latents (a narrow U-ViT and the tiny VAE patched into both factories):
    the port's CLI writes the files of the JAX CLI, images at the VAE's
    resolution and maps in latent space."""
    monkeypatch.setattr(UViTConfig, "imagenet256", staticmethod(lambda: _small_uvit256(UViTConfig)))
    monkeypatch.setattr(TUViTConfig, "imagenet256", staticmethod(lambda: _small_uvit256(TUViTConfig)))
    monkeypatch.setattr(AutoencoderKLConfig, "sd_kl_ema", staticmethod(AutoencoderKLConfig.tiny))
    monkeypatch.setattr(TAutoencoderKLConfig, "sd_kl_ema", staticmethod(TAutoencoderKLConfig.tiny))
    argv = ["--dataset", "imagenet256", "--scheduler-type", "uncertainty_zigzag_centered", "--random-init", "true",
            "--dtype", "float32", "--num-samples", "3", "--batch-size", "2", "--M", "2", "--num-zigzag", "2",
            "--generation-steps", "4", "--start-step-uc", "2", "--num-steps-uc", "2"]
    runs = {}
    for side, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        root = tmp_path / side
        d = root / "data" / "diffusion-starting-points" / "imagenet256"
        d.mkdir(parents=True)
        rng = np.random.RandomState(0)
        np.savez(d / "X_T.npz", data=rng.randn(3, 32, 32, 4).astype(np.float32))
        np.savez(d / "y.npz", data=rng.randint(0, 1000, size=3).astype(np.int32))
        monkeypatch.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(root))
        runs[side] = main(argv + extra)
    names = sorted(p.name for p in runs["port"].iterdir())
    assert names == sorted(p.name for p in runs["jax"].iterdir())
    for name, shape, dtype in (("gen_images", (3, 64, 64, 3), np.uint8), ("uncertainty", (3, 2, 32, 32, 4), np.float32),
                               ("score", (3, 2, 32, 32, 4), np.float32)):
        got, want = load_run_arrays(runs["port"], name), load_run_arrays(runs["jax"], name)
        assert got.shape == want.shape == shape and got.dtype == want.dtype == dtype, name
    u = load_run_arrays(runs["port"], "uncertainty")
    assert np.isfinite(u).all() and u.mean() > 0


def test_factory_builds_uvit_bundles(monkeypatch):
    """Both U-ViT datasets build a bundle with a decoder (narrow U-ViTs and
    the tiny VAE patched in); one seeded generator makes the same weights
    twice; norm scales start at 1."""
    monkeypatch.setattr(TUViTConfig, "imagenet256", staticmethod(lambda: _small_uvit256(TUViTConfig)))
    monkeypatch.setattr(TAutoencoderKLConfig, "sd_kl_ema", staticmethod(TAutoencoderKLConfig.tiny))
    a = tfactory.instantiate_model_scheduler("imagenet256", dtype=torch.float32, random_init=True, device="cpu")
    b = tfactory.instantiate_model_scheduler("imagenet256", dtype=torch.float32, random_init=True, device="cpu")
    assert a.sample_shape == (32, 32, 4) and a.image_size == 256 and a.num_classes == 1001
    assert a.apply_fn is a.apply_fn_dropout
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
    assert torch.equal(a.model.norm.weight, torch.ones(32))
    assert not any(p.requires_grad for p in a.model.parameters())
    z = torch.randn(2, 32, 32, 4)
    with torch.no_grad():
        eps = a.apply_fn(z, 500, torch.tensor([3, 7]), None)
        img = a.decode_fn(z)
    assert eps.shape == (2, 32, 32, 4) and img.shape == (2, 64, 64, 3) and img.dtype == torch.float32
    with pytest.raises(FileNotFoundError, match="random_init=True"):
        tfactory.instantiate_model_scheduler("imagenet256", device="cpu", models_dir="/nonexistent")


_NO_JAX = """
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "diffusion_uncertainty_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, ".")
for m in ("diffusion_uncertainty_torch.models.uvit", "diffusion_uncertainty_torch.models.convert",
          "diffusion_uncertainty_torch.factory", "diffusion_uncertainty_torch.sampling",
          "diffusion_uncertainty_torch.kernels.attention",
          "diffusion_uncertainty_torch.scripts.generate_dataset_score_uncertainty",
          "diffusion_uncertainty_torch.scripts.profile_forward", "diffusion_uncertainty_torch.scripts.bench_uvit_path",
          "chip_smoke"):
    importlib.import_module(m)
import torch
from diffusion_uncertainty_torch.models import UViT, UViTConfig
with torch.no_grad():
    out = UViT(UViTConfig.tiny()).eval()(torch.zeros(1, 8, 8, 4), 10, torch.tensor([1]))
assert out.shape == (1, 8, 8, 4)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("no jax")
"""


def test_uvit_modules_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "no jax", out.stderr[-2000:]
