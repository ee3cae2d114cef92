"""SD 2.1 in the port against the JAX package, float32 on the CPU: the
``SDUNetConfig.sd21`` fields, the full-size parameter count (meta device
against JAX's ``eval_shape``), a narrow sd21-shaped UNet (linear
projections, 64-wide heads, a 1024-wide context) with one state dict, the
t2i CLI's 5 x 1024 pseudo conditioning against the JAX CLI's; and the SD
CLI without ``--vae-weights``, which writes the latent grid (an RGBA PNG) as
the JAX CLI does, not a decoded image. Torch runs on one intra-op thread;
154 s on one worker under the suite's 6-worker run, most of it the JAX
CLI's compiles."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from test_torch_helpers import make_sd_unet_state_dict, torch_state_dict

import diffusion_uncertainty_torch.models.sd_unet as tsd
import diffusion_uncertainty_torch.pipelines.text_to_image as ttti
import diffusion_uncertainty_tpu.models.sd_unet as jsd
import diffusion_uncertainty_tpu.pipelines.text_to_image as jtti
from diffusion_uncertainty_torch.scripts import generate_t2i_guided as tcli
from diffusion_uncertainty_tpu.models.convert import convert_sd_unet
from diffusion_uncertainty_tpu.scripts import generate_t2i_guided as jcli

torch.set_num_threads(1)

# an sd21-shaped UNet at narrow widths: 64-wide heads, linear projections, a 1024-wide context
NARROW = dict(sample_size=8, block_out_channels=(64, 128), layers_per_block=1,
              down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"), up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
              cross_attention_dim=1024, num_attention_heads=(1, 2), use_linear_projection=True)


def test_sd21_config_matches_jax():
    j, t = dataclasses.asdict(jsd.SDUNetConfig.sd21()), dataclasses.asdict(tsd.SDUNetConfig.sd21())
    assert {k: v for k, v in j.items() if k not in ("dtype", "remat", "dropout")} == {k: v for k, v in t.items() if k != "winograd"}
    assert (t["cross_attention_dim"], t["num_attention_heads"], t["use_linear_projection"]) == (1024, (5, 10, 20, 20), True)


def test_sd21_parameter_count():
    cfg = jsd.SDUNetConfig.sd21()
    shapes = jax.eval_shape(jsd.SDUNet(cfg).init, jax.random.key(0), jnp.zeros((1, 64, 64, 4)), jnp.asarray(0),
                            jnp.zeros((1, 77, 1024)))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == 865_910_724
    with torch.device("meta"):
        model = tsd.SDUNet(tsd.SDUNetConfig.sd21())
    assert sum(p.numel() for p in model.parameters()) == 865_910_724


def test_narrow_sd21_unet_matches_jax():
    jcfg, tcfg = jsd.SDUNetConfig(**NARROW), tsd.SDUNetConfig(**NARROW)
    sd = make_sd_unet_state_dict(tcfg, seed=4)
    assert sd["down_blocks.0.attentions.0.proj_in.weight"].shape == (64, 64)  # a Linear, not a 1x1 conv
    model = tsd.SDUNet(tcfg).eval()
    model.load_state_dict(torch_state_dict(sd))
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 5, 1024).astype(np.float32)
    ref = jsd.SDUNet(jcfg).apply(convert_sd_unet(sd, jcfg), jnp.asarray(x), jnp.asarray(500), jnp.asarray(ctx))
    with torch.no_grad():
        out = model(torch.from_numpy(x), 500, torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def _record_conditioning(monkeypatch, module, seen: list):
    """Each CLI's pipeline class, recording the conditioning it is called with."""
    base = module.TextToImageUncertaintyPipeline

    class Recording(base):
        def __call__(self, cond, *a, **kw):
            seen.append((np.asarray(cond), np.asarray(kw["uncond_embeds"])))
            return super().__call__(cond, *a, **kw)

    monkeypatch.setattr(module, "TextToImageUncertaintyPipeline", Recording)


def test_sd21_cli_conditions_as_the_jax_cli(monkeypatch, tmp_path):
    """The prompts enter as 5-token, 1024-wide pseudo embeddings: CLIP (or
    its 768-wide stand-in) does not match the UNet's context (the JAX CLI's
    rule, not a special case of the tiny model)."""
    for mod in (jsd, tsd):
        monkeypatch.setattr(mod.SDUNetConfig, "sd21", staticmethod(lambda c=mod.SDUNetConfig: c(**NARROW)))
    seen_j, seen_t = [], []
    _record_conditioning(monkeypatch, jtti, seen_j)
    _record_conditioning(monkeypatch, ttti, seen_t)
    argv = ["--model", "sd21", "--random-init", "true", "--dtype", "float32", "--height", "64", "--num-steps", "2",
            "--num-steps-threshold", "1", "--M", "2", "--skip-original", "true"]
    assert jcli.main(argv + ["--out-dir", str(tmp_path / "jax")]) == 0
    assert tcli.main(argv + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert len(seen_j) == len(seen_t) == 1
    for a, b in zip(seen_t[0], seen_j[0]):
        assert a.shape == (1, 5, 1024)
        np.testing.assert_array_equal(a, b)
    names = ["args.yaml", "output_sd_uc.png", "uncertainty.npz"]
    assert sorted(p.name for p in (tmp_path / "jax" / "0").iterdir()) == sorted(p.name for p in (tmp_path / "port" / "0").iterdir()) == names
    assert "pseudo_text: true" in (tmp_path / "port" / "0" / "args.yaml").read_text()


def test_sd15_random_init_without_vae_writes_the_latent_grid(monkeypatch, tmp_path):
    """``--random-init true`` alone builds no VAE: both CLIs save the
    undecoded latents, 4 channels as an RGBA PNG (the sd15 config shrunk on
    both sides)."""
    tiny = dataclasses.asdict(jsd.SDUNetConfig.tiny())
    tiny.pop("dtype"), tiny.pop("remat"), tiny.pop("dropout")
    for mod in (jsd, tsd):
        monkeypatch.setattr(mod.SDUNetConfig, "sd15", staticmethod(lambda c=mod.SDUNetConfig: c(**tiny)))
    argv = ["--random-init", "true", "--dtype", "float32", "--height", "64", "--num-steps", "2", "--num-steps-threshold", "1",
            "--M", "2"]
    assert jcli.main(argv + ["--out-dir", str(tmp_path / "jax")]) == 0
    assert tcli.main(argv + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    want, got = tmp_path / "jax" / "0", tmp_path / "port" / "0"
    names = ["args.yaml", "output_sd.png", "output_sd_uc.png", "uncertainty.npz"]
    assert sorted(p.name for p in want.iterdir()) == sorted(p.name for p in got.iterdir()) == names
    for name in names[1:3]:
        a, b = Image.open(got / name), Image.open(want / name)
        assert (a.mode, a.size) == (b.mode, b.size) == ("RGBA", (8, 8)), name
    assert tcli.build_sd_stack(tcli.Config(random_init=True), device="cpu").decode_fn is None
