"""The CIFAR-10 slice of the port against the JAX package, float32 on the CPU:
the DDPM ``UNet2D`` (deterministic, with replayed MC-dropout masks, and with
the Winograd conv route), its converter, the ``mc_dropout`` estimator,
``generate_uncertainty_dataset`` (shards and resume), the starting points
and the dataset CLI.

Dropout masks: JAX draws them inside flax's ``nn.Dropout``; the tests record
them by wrapping ``Dropout.__call__`` (``record_dropout_masks``) while the JAX
model runs, and hand them to the port in its draw order (site by site in
forward order, one mask of the folded [M·B, ...] activation per site) through
``ReplayNoise.bernoulli``. Members of a JAX ensemble draw from their own keys
(``jax.random.split(k_est, M)``), so each member's masks are recorded by one
un-vmapped forward with that key.
"""

import dataclasses
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import ReplayNoise, torch_state_dict
from test_torch_winograd import PallasReplay

import diffusion_uncertainty_torch.models.convert as tconvert
from diffusion_uncertainty_torch.diffusion import SamplerConfig as TSamplerConfig
from diffusion_uncertainty_torch.diffusion import StepState as TStepState
from diffusion_uncertainty_torch.diffusion import make_schedule as t_make_schedule
from diffusion_uncertainty_torch.factory import instantiate_model_scheduler as t_instantiate
from diffusion_uncertainty_torch.models import UNet2D as TUNet2D
from diffusion_uncertainty_torch.models import UNet2DConfig as TUNet2DConfig
from diffusion_uncertainty_torch.models import unet2d_state_dict_from_flax
from diffusion_uncertainty_torch.models.layers import GroupNorm32 as TGroupNorm32
from diffusion_uncertainty_torch.sampling import generate_uncertainty_dataset as t_generate
from diffusion_uncertainty_torch.scripts import generate_dataset_score_uncertainty as tcli
from diffusion_uncertainty_torch.scripts import generate_starting_points as tstart
from diffusion_uncertainty_torch.uncertainty import EstimatorConfig as TEstimatorConfig
from diffusion_uncertainty_torch.uncertainty import make_estimator as t_make_estimator
from diffusion_uncertainty_torch.utils.experiments import load_run_arrays
from diffusion_uncertainty_torch.utils.rng import batch_seed
from diffusion_uncertainty_tpu.diffusion.sampler import SamplerConfig, StepState
from diffusion_uncertainty_tpu.diffusion.schedule import make_schedule, uncertainty_window
from diffusion_uncertainty_tpu.models import UNet2D, UNet2DConfig
from diffusion_uncertainty_tpu.models.convert import convert_unet2d
from diffusion_uncertainty_tpu.sampling import generate_uncertainty_dataset
from diffusion_uncertainty_tpu.scripts import generate_starting_points as jstart
from diffusion_uncertainty_tpu.uncertainty import EstimatorConfig, make_estimator
from diffusion_uncertainty_tpu.utils.rng import batch_key, run_key

# float32 both sides: summation order of convs, GroupNorm and attention
ATOL = 1e-4


def _cfgs(dropout=0.0, **kw):
    j = dataclasses.replace(UNet2DConfig.tiny(), dropout=dropout, **kw)
    t = dataclasses.replace(TUNet2DConfig.tiny(), dropout=dropout, **kw)
    return j, t


def make_unet2d_state_dict(tcfg, seed=0, std=0.05) -> dict:
    """{key: float32 ndarray} in the diffusers ``UNet2DModel`` layout (keys
    and shapes from the port's model on the meta device); GroupNorm scales
    around 1, every other parameter non-zero."""
    with torch.device("meta"):
        model = TUNet2D(tcfg)
    norms = {n for n, m in model.named_modules() if isinstance(m, TGroupNorm32)}
    rng = np.random.RandomState(seed)
    sd = {}
    for key, v in model.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        if owner in norms and leaf == "weight":
            sd[key] = (1.0 + rng.randn(*v.shape) * 0.1).astype(np.float32)
        else:
            sd[key] = (rng.randn(*v.shape) * std).astype(np.float32)
    return sd


def _port(tcfg, sd):
    model = TUNet2D(tcfg).eval()
    model.load_state_dict(torch_state_dict(sd))  # strict: keys and shapes as the checkpoint's
    return model


_FLAX_DROPOUT_CALL = nn.Dropout.__call__


class record_dropout_masks:
    """Wraps ``flax.linen.Dropout.__call__`` so each stochastic call records
    its keep-mask (the same ``make_rng`` key and ``bernoulli`` draw flax
    makes, then handed to flax as ``rng``)."""

    def __init__(self, monkeypatch):
        self.masks = []
        orig = _FLAX_DROPOUT_CALL

        def rec(mod, inputs, deterministic=None, rng=None):
            det = nn.module.merge_param("deterministic", mod.deterministic, deterministic)
            if mod.rate > 0.0 and not det:
                rng = mod.make_rng(mod.rng_collection) if rng is None else rng
                self.masks.append(np.array(jax.random.bernoulli(rng, 1.0 - mod.rate, inputs.shape)))
            return orig(mod, inputs, deterministic, rng)

        monkeypatch.setattr(nn.Dropout, "__call__", rec)


def test_unet2d_state_dict_from_flax_inverts_convert():
    _, tcfg = _cfgs()
    sd = make_unet2d_state_dict(tcfg, seed=1)
    back = unet2d_state_dict_from_flax(convert_unet2d(sd, UNet2DConfig.tiny()), tcfg)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_full_width_keys_and_shapes_match_jax(monkeypatch):
    """``ddpm_cifar10`` at full width: torch on the meta device against JAX
    through eval_shape, carried across as zero-stride views."""
    with torch.device("meta"):
        model = TUNet2D(TUNet2DConfig.ddpm_cifar10(dropout=0.1))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert abs(sum(int(np.prod(s)) for s in want.values()) / 1e6 - 35.746) < 0.001
    jcfg = UNet2DConfig.ddpm_cifar10(dropout=0.1)
    shapes = jax.eval_shape(lambda k: UNet2D(jcfg).init(k, jnp.zeros((1, 32, 32, 3)), jnp.asarray(1)), jax.random.key(0))
    views = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    monkeypatch.setattr(tconvert._Out, "put", lambda self, key, a: self.sd.__setitem__(key, tuple(np.shape(a))))
    assert unet2d_state_dict_from_flax(views, jcfg) == want


@pytest.mark.parametrize("stochastic", [False, True])
def test_tiny_forward_matches_jax(monkeypatch, stochastic):
    """Deterministic, and with dropout 0.1 on the masks the JAX run drew."""
    jcfg, tcfg = _cfgs(dropout=0.1)
    sd = make_unet2d_state_dict(tcfg, seed=2)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    rec = record_dropout_masks(monkeypatch)
    kw = {"deterministic": False, "rngs": {"dropout": jax.random.key(7)}} if stochastic else {}
    ref = np.asarray(UNet2D(jcfg).apply(convert_unet2d(sd, jcfg), jnp.asarray(x), jnp.asarray(321), **kw))
    assert len(rec.masks) == (8 if stochastic else 0)  # one per ResnetBlock2D
    noise = ReplayNoise([], rec.masks) if stochastic else None
    with torch.no_grad():
        out = _port(tcfg, sd)(torch.from_numpy(x), 321, noise=noise)
    assert out.dtype == torch.float32 and out.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    if stochastic:
        assert noise.masks_used == len(rec.masks)
        with torch.no_grad():
            det = _port(tcfg, sd)(torch.from_numpy(x), 321).numpy()
        assert np.abs(det - ref).max() > 100 * ATOL  # the masks matter


def test_unet2d_with_winograd_matches_jax_pallas(monkeypatch):
    """A small UNet2D with 128-channel levels and ``winograd=True`` (every
    ResnetBlock2D conv meets the shape rule) against the JAX model with the
    Pallas kernel in interpret mode, site by site (``PallasReplay``)."""
    kw = {"sample_size": 8, "block_out_channels": (128, 128)}
    jcfg, tcfg = _cfgs(**kw)
    tcfg = dataclasses.replace(tcfg, winograd=True)
    sd = make_unet2d_state_dict(tcfg, seed=3, std=0.03)
    x = np.random.RandomState(4).randn(8, 8, 8, 3).astype(np.float32)  # batch 8: the JAX kernel's batch tile
    replay = PallasReplay(monkeypatch)
    ref = replay.run_jax(lambda: UNet2D(jcfg).apply(convert_unet2d(sd, jcfg), jnp.asarray(x), jnp.asarray(250)))
    assert len(replay.calls) == 2 * (2 + 2 + 4)  # every ResnetBlock2D: conv1, conv2 with the residual
    out = replay.run_port(lambda: _port(tcfg, sd)(torch.from_numpy(x), 250))
    np.testing.assert_allclose(out, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())), rtol=0)


def _member_masks(monkeypatch, model, params, shape, t, keys):
    """Each member's masks (one forward per key), folded member-major per
    site: the port's draw order for one ensemble forward."""
    per_member = []
    for k in keys:
        rec = record_dropout_masks(monkeypatch)
        model.apply(params, jnp.zeros(shape), jnp.asarray(t), deterministic=False, rngs={"dropout": k})
        per_member.append(rec.masks)
    return [np.concatenate(site) for site in zip(*per_member)]


def test_mc_dropout_matches_jax_with_replayed_members(monkeypatch):
    """Var_m (ddof=1) of M dropout forwards on one x_t, the members' masks
    replayed from the JAX run's keys."""
    jcfg, tcfg = _cfgs(dropout=0.1)
    sd = make_unet2d_state_dict(tcfg, seed=5)
    params = convert_unet2d(sd, jcfg)
    model = UNet2D(jcfg)
    rng = np.random.RandomState(6)
    arrs = [rng.randn(2, 16, 16, 3).astype(np.float32) for _ in range(4)]
    M, t, key = 3, 400, jax.random.key(11)
    jstate = StepState(*(jnp.asarray(a) for a in arrs), timestep=jnp.asarray(t), prev_timestep=jnp.asarray(t - 20))
    jest = make_estimator(EstimatorConfig(name="mc_dropout", M=M))
    jfn = lambda x, tt, k: model.apply(params, x, tt, deterministic=False, rngs={"dropout": k})  # noqa: E731
    ref = np.asarray(jest(jfn, make_schedule("linear", 1000), jstate, key))
    masks = _member_masks(monkeypatch, model, params, (2, 16, 16, 3), t, jax.random.split(key, M))

    port = _port(tcfg, sd)
    tstate = TStepState(*(torch.from_numpy(a) for a in arrs), timestep=t, prev_timestep=t - 20)
    noise = ReplayNoise([], masks)
    test_est = t_make_estimator(TEstimatorConfig(name="mc_dropout", M=M))
    with torch.no_grad():
        u = test_est(lambda x, tt, nz: port(x, tt, noise=nz), t_make_schedule(device="cpu"), tstate, noise)
    assert noise.masks_used == len(masks) == 8  # one folded mask per ResnetBlock2D
    assert u.shape == (2, 16, 16, 3) and float(u.mean()) > 0
    np.testing.assert_allclose(u.numpy(), ref, atol=ATOL * float(np.abs(ref).max()), rtol=0)


def _jax_run_masks(monkeypatch, model, params, seed, n_batches, batch, steps, start, after, n_uc, M):
    """The dropout masks of the JAX ``generate_uncertainty_dataset`` with
    ``mc_dropout`` (eta 0), per batch: its key ``batch_key(run_key(seed), b)``
    walked as ``sample_ddim`` walks it (``sampler.py:138-148``), each window
    step's estimator key split into the M member keys."""
    from diffusion_uncertainty_tpu.diffusion.schedule import spaced_timesteps

    ts = spaced_timesteps(1000, steps)
    w0, w1 = uncertainty_window(after, n_uc, steps)
    out = {}
    for b in range(n_batches):
        key, masks = batch_key(run_key(seed), b), []
        for i in range(start, steps):
            if w0 <= i < w1:
                key, _, k_est = jax.random.split(key, 3)
                masks += _member_masks(monkeypatch, model, params, (batch, 16, 16, 3), int(ts[i]), jax.random.split(k_est, M))
            else:
                key, _ = jax.random.split(key)
        out[b] = masks
    return out


def test_generate_uncertainty_dataset_matches_jax(monkeypatch, tmp_path):
    """The tiny UNet2D with ``mc_dropout`` through both packages' generation
    loops, on the same X_T (3 images in batches of 2: the last batch padded)
    and the JAX run's dropout masks: the same images (the trajectory forward
    is deterministic), maps and scores, shard by shard; a resumed run
    recomputes only the missing shard."""
    jcfg, tcfg = _cfgs(dropout=0.1)
    sd = make_unet2d_state_dict(tcfg, seed=8)
    params = convert_unet2d(sd, jcfg)
    jmodel = UNet2D(jcfg)
    x_t = np.random.RandomState(9).randn(3, 16, 16, 3).astype(np.float32)
    # the chain starts at t=500 (step 2 of 6): from higher t a DDIM chain
    # amplifies float32 summation-order differences about 3x per step
    # (ROADMAP.md section 3)
    steps, start, after, n_uc, M, seed = 6, 2, 3, 3, 2, 5
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jres = generate_uncertainty_dataset(
        lambda p, x, t, y, k: jmodel.apply(p, x, t),
        make_schedule("linear", 1000),
        SamplerConfig(num_inference_steps=steps, after_step=after, num_steps_uc=n_uc, start_step=start),
        x_t, None, 2, params=params, seed=seed,
        estimator=make_estimator(EstimatorConfig(name="mc_dropout", M=M)),
        estimator_apply_fn=lambda p, x, t, y, k: jmodel.apply(p, x, t, deterministic=False, rngs={"dropout": k}),
        run_dir=jdir,
    )
    masks = _jax_run_masks(monkeypatch, jmodel, params, seed, 2, 2, steps, start, after, n_uc, M)

    port = _port(tcfg, sd)
    sources = []

    def replay(s, device):
        sources.append(ReplayNoise([], masks[s % 2**32]))
        return sources[-1]

    def run():
        with torch.no_grad():
            return t_generate(
                lambda x, t, y, nz: port(x, t),
                t_make_schedule("linear", 1000, device="cpu"),
                TSamplerConfig(num_inference_steps=steps, after_step=after, num_steps_uc=n_uc, start_step=start),
                x_t, None, 2, seed=seed,
                estimator=t_make_estimator(TEstimatorConfig(name="mc_dropout", M=M)),
                estimator_apply_fn=lambda x, t, y, nz: port(x, t, noise=nz),
                run_dir=tdir, noise_factory=replay,
            )

    tres = run()
    # every mask used: 8 dropout sites (ResnetBlock2Ds) per window step
    assert all(s.masks_used == len(s.masks) == n_uc * 8 for s in sources)
    assert tres.uncertainty.shape == (3, n_uc, 16, 16, 3) and tres.gen_images.dtype == np.uint8
    assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    np.testing.assert_array_equal(np.load(tdir / "timestep.npz")["data"], np.load(jdir / "timestep.npz")["data"])
    # uint8 of the same float32 sample: at most one step where a value sits on a boundary
    assert np.abs(load_run_arrays(tdir, "gen_images").astype(int) - load_run_arrays(jdir, "gen_images")).max() <= 1
    for name in ("uncertainty", "score"):
        got, want = load_run_arrays(tdir, name), load_run_arrays(jdir, name)
        np.testing.assert_allclose(got, want, atol=ATOL * float(np.abs(want).max()), rtol=0, err_msg=name)
    np.testing.assert_allclose(tres.uncertainty, jres.uncertainty, atol=ATOL * float(np.abs(jres.uncertainty).max()), rtol=0)

    # resume: shard 0 is kept, shard 1 recomputed with batch 1's own noise
    before = load_run_arrays(tdir, "uncertainty")
    (tdir / "gen_images_1.npz").unlink()
    sources.clear()
    again = run()
    assert len(sources) == 1 and again.gen_images.shape[0] == 1
    np.testing.assert_array_equal(load_run_arrays(tdir, "uncertainty"), before)


def test_generate_starting_points_writes_jax_bytes(monkeypatch, tmp_path):
    """The port's numpy-only copy writes the same files as the JAX script
    (the same seed chain); zip timestamps pinned so bytes compare."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    argv = ["--datasets", "imagenet64,cifar10", "--num-samples", "5", "--extra-samples", "2"]
    for root, main in ((tmp_path / "jax", jstart.main), (tmp_path / "port", tstart.main)):
        monkeypatch.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(root))
        main(argv)
    for ds in ("imagenet64", "cifar10"):
        for f in ("X_T.npz", "y.npz"):
            a = (tmp_path / "jax" / "data" / "diffusion-starting-points" / ds / f).read_bytes()
            assert a == (tmp_path / "port" / "data" / "diffusion-starting-points" / ds / f).read_bytes(), (ds, f)
    with np.load(tmp_path / "port" / "data" / "diffusion-starting-points" / "cifar10" / "X_T.npz") as z:
        assert z["data"].shape == (7, 32, 32, 3) and z["data"].dtype == np.float32
    assert not (tmp_path / "port" / "data" / "diffusion-starting-points" / "imagenet128").exists()


@pytest.mark.parametrize("scheduler", ["mc_dropout", "uncertainty_zigzag_centered", "dpm_2_uncertainty_centered", "uncertainty",
                                       "infer_noise", "uncertainty_image", "uncertainty_centered_d", "flip",
                                       "uncertainty_grad"])
def test_dataset_cli_writes_its_files(monkeypatch, tmp_path, scheduler):
    monkeypatch.setenv("DIFFUSION_UNCERTAINTY_ROOT", str(tmp_path))
    d = tmp_path / "data" / "diffusion-starting-points" / "tiny"
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    np.savez(d / "X_T.npz", data=rng.randn(3, 16, 16, 3).astype(np.float32))
    np.savez(d / "y.npz", data=rng.randint(0, 10, size=3).astype(np.int32))
    argv = ["--dataset", "tiny", "--scheduler-type", scheduler, "--random-init", "true", "--device", "cpu",
            "--dtype", "float32", "--num-samples", "3", "--batch-size", "2", "--M", "2", "--num-zigzag", "2",
            "--generation-steps", "4", "--start-step-uc", "2", "--num-steps-uc", "2"]
    run = tcli.main(argv)
    assert run.parent == tmp_path / "results" / "score-uncertainty"
    names = sorted(p.name for p in run.iterdir())
    assert names == sorted(["args.yaml", "timestep.npz"] + [f"{a}_{i}.npz" for a in ("gen_images", "uncertainty", "score") for i in (0, 1)])
    u = load_run_arrays(run, "uncertainty")
    assert u.shape == (3, 2, 16, 16, 3) and np.isfinite(u).all() and u.mean() > 0
    assert load_run_arrays(run, "gen_images").shape == (3, 16, 16, 3)
    args = (run / "args.yaml").read_text()
    assert f'scheduler_type: "{scheduler}"' in args and "winograd: false" in args


def test_dataset_cli_names_the_roadmap_item_of_what_is_not_ported():
    # every scheduler type runs (test_dataset_cli_writes_its_files); the mesh waits
    with pytest.raises(SystemExit, match="ROADMAP.md queue 1, item 18"):
        tcli.main(["--random-init", "true", "--device", "cpu", "--mesh-data", "2"])


def test_factory_random_init_is_seeded_and_routes_winograd(monkeypatch):
    a = t_instantiate("cifar10", dropout=0.1, dtype=torch.float32, random_init=True, device="cpu", winograd=True)
    b = t_instantiate("cifar10", dropout=0.1, dtype=torch.float32, random_init=True, device="cpu")
    assert a.image_size == 32 and a.num_classes is None and a.model.cfg.dropout == 0.1
    assert a.model.cfg.winograd and not b.model.cfg.winograd
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
    assert not any(p.requires_grad for p in a.model.parameters())
    with pytest.raises(FileNotFoundError, match="random_init=True"):
        t_instantiate("cifar10", device="cpu", models_dir="/nonexistent")
    # imagenet512 builds a U-ViT bundle with its VAE decoder (a narrow U-ViT
    # on the 64x64x4 latents and the tiny VAE, not 500M float32 parameters)
    from diffusion_uncertainty_torch.models import AutoencoderKLConfig as TAutoencoderKLConfig
    from diffusion_uncertainty_torch.models import UViTConfig as TUViTConfig

    monkeypatch.setattr(TUViTConfig, "imagenet512", staticmethod(
        lambda: TUViTConfig(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2)))
    monkeypatch.setattr(TAutoencoderKLConfig, "sd_kl_ema", staticmethod(TAutoencoderKLConfig.tiny))
    u = t_instantiate("imagenet512", dtype=torch.float32, random_init=True, device="cpu")
    assert u.sample_shape == (64, 64, 4) and u.image_size == 512 and u.decode_fn is not None
    assert batch_seed(3, 1) != batch_seed(3, 2) != batch_seed(4, 1)


def test_adm_dropout_forward_matches_jax(monkeypatch):
    """The tiny ADM (dropout 0.1, as the JAX config) with the masks its JAX
    run drew: one per ResBlock, in forward order."""
    from test_torch_helpers import make_adm_state_dict

    from diffusion_uncertainty_torch.models import ADMUNet as TADMUNet
    from diffusion_uncertainty_torch.models import ADMUNetConfig as TADMUNetConfig
    from diffusion_uncertainty_tpu.models import ADMUNet, ADMUNetConfig
    from diffusion_uncertainty_tpu.models.convert import convert_adm_unet

    jcfg, tcfg = ADMUNetConfig.tiny(), TADMUNetConfig.tiny()
    assert jcfg.dropout == tcfg.dropout == 0.1
    sd = make_adm_state_dict(jcfg, seed=6)
    rng = np.random.RandomState(2)
    x, y = rng.randn(2, 16, 16, 3).astype(np.float32), np.array([1, 7])
    rec = record_dropout_masks(monkeypatch)
    ref = np.asarray(ADMUNet(jcfg).apply(
        convert_adm_unet(sd, jcfg), jnp.asarray(x), jnp.asarray(300), jnp.asarray(y),
        deterministic=False, rngs={"dropout": jax.random.key(3)},
    ))
    model = TADMUNet(tcfg).eval()
    model.load_state_dict(torch_state_dict(sd))
    noise = ReplayNoise([], rec.masks)
    with torch.no_grad():
        out = model(torch.from_numpy(x), 300, torch.from_numpy(y), noise=noise).numpy()
    assert noise.masks_used == len(rec.masks) == 10  # 3 encoder, 2 middle, 5 decoder ResBlocks
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
