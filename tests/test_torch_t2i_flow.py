"""The port's text-to-image CLI on the flow-matching family against the JAX
CLI, float32 on the CPU: ``--model sd3-tiny`` and ``--model flux-tiny`` in
both guidance branches, on the same weights (a diffusers-layout state dict
both CLIs load with ``--unet-weights``) with JAX's draws replayed: the file
names, ``uncertainty.npz``, the saved images and ``args.yaml``; the
16-channel VAEs' decode; the exits of the settings that are not ported and
the text towers' entry; the
card as the default device; and that the slice's modules import no JAX."""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from test_torch_helpers import ReplayNoise, jax_flow_noise, make_vae_state_dict

import diffusion_uncertainty_torch.utils.rng as trng
from diffusion_uncertainty_torch.models import AutoencoderKL as TAutoencoderKL
from diffusion_uncertainty_torch.models import AutoencoderKLConfig as TAutoencoderKLConfig
from diffusion_uncertainty_torch.models import flux_state_dict_from_flax, mmdit_state_dict_from_flax
from diffusion_uncertainty_torch.scripts import generate_t2i_guided as tcli
from diffusion_uncertainty_torch.utils.config import read_config
from diffusion_uncertainty_tpu.models import AutoencoderKL, AutoencoderKLConfig, FluxConfig, FluxTransformer, MMDiT, MMDiTConfig
from diffusion_uncertainty_tpu.models.convert import convert_autoencoder_kl
from diffusion_uncertainty_tpu.scripts import generate_t2i_guided as jcli

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
STEPS, AFTER, WINDOW, M = 3, 1, 2, 3
RUN = ["--num-steps", str(STEPS), "--start-step-threshold", str(AFTER), "--num-steps-threshold", str(WINDOW),
       "--M", str(M)]
SEED = 491  # the CLI's default
# 3-step chains through random tiny transformers, float32 both sides;
# measured rel L2 of the maps against JAX: at most 3e-6 (sd3-tiny) and
# 6e-6 (flux-tiny, its guidance embedding at 7500); the limit leaves 10x
U_REL = 1e-4


@functools.cache
def _weights(model: str, root: str) -> tuple:
    """(state-dict file, latent shape): JAX's random init of the tiny model
    moved by 0.05·N(0, 1) per leaf, as the port's diffusers-layout dict."""
    rng = np.random.RandomState(3)
    if model == "sd3-tiny":
        cfg, shape = MMDiTConfig.tiny(), (1, 8, 8, 16)
        init, to_sd, extra = MMDiT(cfg).init, mmdit_state_dict_from_flax, ()
    else:
        cfg, shape = FluxConfig.tiny(), (1, 8, 8, 4)
        init, to_sd, extra = FluxTransformer(cfg).init, flux_state_dict_from_flax, (jnp.asarray(1000.0),)
    params = jax.jit(init)(jax.random.key(0), jnp.zeros(shape), jnp.asarray(1.0), jnp.zeros((1, 16, cfg.joint_attention_dim)),
                           jnp.zeros((1, cfg.pooled_projection_dim)), *extra)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), params)
    path = Path(root) / f"{model}.pt"
    torch.save(to_sd(params, cfg), path)
    return str(path), shape


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), np.int16)


@pytest.mark.parametrize("posterior", ["false", "true"], ids=["gradient", "posterior"])
@pytest.mark.parametrize("model", ["sd3-tiny", "flux-tiny"])
def test_flow_cli_matches_the_jax_cli(monkeypatch, tmp_path, model, posterior):
    weights, shape = _weights(model, str(tmp_path.parent))
    argv = ["--model", model, "--unet-weights", weights, "--use-posterior", posterior] + RUN
    assert jcli.main(argv + ["--out-dir", str(tmp_path / "jax")]) == 0
    draws = jax_flow_noise(SEED, shape, STEPS, AFTER, WINDOW, M)
    made = []
    monkeypatch.setattr(trng, "TorchNoise", lambda seed, device: made.append(ReplayNoise(draws)) or made[-1])
    assert tcli.main(argv + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert len(made) == 1 and made[0].used == len(draws)  # x_T, then one draw per window step; none for the plain run

    want, got = tmp_path / "jax" / "0", tmp_path / "port" / "0"
    stem = "flux" if model == "flux-tiny" else "sd3"
    names = ["args.yaml", f"output_latent_preview_{stem}.png", f"output_latent_preview_{stem}_uc.png", "uncertainty.npz"]
    assert sorted(p.name for p in want.iterdir()) == sorted(p.name for p in got.iterdir()) == names
    u, u_ref = np.load(got / "uncertainty.npz")["data"], np.load(want / "uncertainty.npz")["data"]
    assert u.shape == u_ref.shape == (WINDOW,) + shape and np.isfinite(u).all() and u.mean() > 0
    assert float(np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref)) <= U_REL
    for name in names[1:3]:
        a, b = _png(got / name), _png(want / name)
        assert a.shape == b.shape == (8, 8, 3)
        assert np.abs(a - b).max() <= 1, name  # a value on a rounding edge may land one level over
    args, args_ref = read_config(got / "args.yaml"), yaml.safe_load((want / "args.yaml").read_text())
    assert args["pseudo_text"] is args_ref["pseudo_text"] is True and args["pseudo_tokens"] is args_ref["pseudo_tokens"] is False
    shared = set(args) & set(args_ref) - {"out_dir"}
    assert {"model", "use_posterior", "M", "text_towers", "streamed", "tower_seq_len"} <= shared
    assert {k: args[k] for k in shared} == {k: args_ref[k] for k in shared}


@pytest.mark.parametrize("which", ["sd3_kl", "flux_kl"])
def test_16_channel_vae_decode_matches_jax(which):
    """The 16-channel VAEs' configs equal JAX's, and the decode unshifts as
    JAX does (z / scale + shift, no post-quant conv), on the tiny widths."""
    jfull, tfull = getattr(AutoencoderKLConfig, which)(), getattr(TAutoencoderKLConfig, which)()
    assert dataclasses.asdict(tfull) == {k: v for k, v in dataclasses.asdict(jfull).items() if k not in ("dtype", "in_channels")}
    keep = {k: getattr(jfull, k) for k in ("z_channels", "embed_dim", "scale_factor", "shift_factor", "use_quant_conv")}
    jcfg = dataclasses.replace(AutoencoderKLConfig.tiny(), **keep)
    sd = make_vae_state_dict(jcfg, seed=5)
    assert not any(k.startswith(("quant_conv", "post_quant_conv")) for k in sd)
    vae = TAutoencoderKL(dataclasses.replace(TAutoencoderKLConfig.tiny(), **keep))
    vae.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    z = np.random.RandomState(6).randn(1, 4, 4, 16).astype(np.float32)
    ref = AutoencoderKL(jcfg).apply(convert_autoencoder_kl(sd, jcfg), jnp.asarray(z), "decode")
    with torch.no_grad():
        out = vae.eval().decode(torch.from_numpy(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


class _Reached(Exception):
    pass


@pytest.mark.parametrize("argv,item", [(["--model", "sd3", "--text-towers", "small"], ("sd3", "small")),
                                       (["--model", "flux", "--text-towers", "full"], ("flux", "full")),
                                       (["--model", "sd35", "--streamed", "true"], "item 16"),
                                       (["--model", "sd15", "--streamed", "true"], "item 16")],
                         ids=["sd3_small_towers", "flux_full_towers", "sd35_streamed", "sd15_streamed"])
def test_unported_settings_exit_naming_their_item(monkeypatch, argv, item):
    """Never accepted and dropped: the streamed executor exits before a
    model is built; ``--text-towers small|full`` on a full model (once item
    20) reaches ``T2ITowers`` with its family and scale before the
    transformer is built (stopped there: the towers are not built here)."""
    if isinstance(item, tuple):
        import diffusion_uncertainty_torch.pipelines.text_encoder as tte

        def towers(family, scale, **kw):
            raise _Reached(family, scale, kw["device"].type)

        monkeypatch.setattr(tte, "T2ITowers", towers)
        monkeypatch.setattr(tcli, "_build", lambda *a: pytest.fail("the transformer was built before the towers"))
        with pytest.raises(_Reached) as got:
            tcli.main(argv + ["--random-init", "true", "--device", "cpu"])
        assert got.value.args == (*item, "cpu")
        return
    with pytest.raises(SystemExit, match=f"ROADMAP.md queue 1, {item}"):
        tcli.main(argv + ["--random-init", "true", "--device", "cpu"])


def test_flow_models_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in ("sd3-tiny", "flux-tiny"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tcli.main(["--model", model])
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tcli.build_flow_stack(tcli.Config(model=model))
    stack = tcli.build_flow_stack(tcli.Config(model="flux-tiny"), device="cpu")
    assert next(stack.model.parameters()).device.type == "cpu" and stack.decode_fn is None and stack.is_flux


def test_full_models_draw_their_random_weights_in_bf16(monkeypatch):
    """The full-size builds cast on the meta device before allocating, so
    random weights are allocated and drawn once, in bf16 (here on the meta
    device: nothing is allocated or drawn)."""
    drawn = []
    monkeypatch.setattr(tcli, "init_random_", lambda m, seed: drawn.append({p.dtype for p in m.parameters()}) or m)
    stack = tcli.build_flow_stack(tcli.Config(model="sd35", random_init=True), device="meta")
    assert drawn == [{torch.bfloat16}] and stack.mcfg.qk_norm == "rms_norm" and stack.latent_size == 64
    # the RMS q/k-norm scales start at 1, as the JAX init's
    tiny = tcli.init_random_(tcli.FluxTransformer(tcli.FluxConfig.tiny()), 0)
    scales = [p for n, p in tiny.named_parameters() if ".norm_" in n]
    assert len(scales) == 2 * 4 + 2 * 2 and all(bool((p == 1).all()) for p in scales)


_NO_JAX = """
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "diffusion_uncertainty_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, ".")
for m in ("diffusion_uncertainty_torch.models.mmdit", "diffusion_uncertainty_torch.models.flux",
          "diffusion_uncertainty_torch.models.convert", "diffusion_uncertainty_torch.diffusion.flow_match",
          "diffusion_uncertainty_torch.scripts.generate_t2i_guided", "diffusion_uncertainty_torch.scripts.profile_forward",
          "diffusion_uncertainty_torch.scripts.bench_attention", "chip_smoke"):
    importlib.import_module(m)
import torch
from diffusion_uncertainty_torch.diffusion.flow_match import FlowMatchConfig, sample_flow_match
from diffusion_uncertainty_torch.models import FluxConfig, FluxTransformer, MMDiT, MMDiTConfig
from diffusion_uncertainty_torch.utils import TorchNoise
mm, fx = MMDiT(MMDiTConfig.tiny()).eval(), FluxTransformer(FluxConfig.tiny()).eval()
ctx = torch.zeros(1, 4, 24)
res = sample_flow_match(lambda x, t: mm(x, t, ctx.expand(len(x), -1, -1), torch.zeros(len(x), 20)), torch.zeros(1, 8, 8, 16),
                        TorchNoise(0, "cpu"), FlowMatchConfig(num_inference_steps=2, num_steps_uc=1, M=2))
with torch.no_grad():
    out = fx(torch.zeros(1, 8, 8, 4), 10.0, ctx, torch.zeros(1, 16), 7500.0)
assert res.uncertainty.shape == (1, 1, 8, 8, 16) and out.shape == (1, 8, 8, 4)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("no jax")
"""


def test_slice_modules_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "no jax", out.stderr[-2000:]
