"""The port's Stable Diffusion pieces against the JAX package, float32 on the
CPU: the tiny SD UNet forward and VAE decode, the inverse weight converters
(exact round trips, full-width keys and shapes), the long-key flash kernel's
plain version, the autograd backwards of the kernel ops, the text
conditioning, the entry points' device choice and the CLI."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import make_sd_unet_state_dict, make_vae_state_dict, torch_state_dict

import diffusion_uncertainty_torch.models.convert as tconvert
import diffusion_uncertainty_tpu.ops.groupnorm as jgn
from diffusion_uncertainty_torch.diffusion import make_schedule as t_make_schedule
from diffusion_uncertainty_torch.kernels.attention import attention_plain
from diffusion_uncertainty_torch.models import AutoencoderKL as TAutoencoderKL
from diffusion_uncertainty_torch.models import AutoencoderKLConfig as TAutoencoderKLConfig
from diffusion_uncertainty_torch.models import SDUNet as TSDUNet
from diffusion_uncertainty_torch.models import SDUNetConfig as TSDUNetConfig
from diffusion_uncertainty_torch.models import autoencoder_kl_state_dict_from_flax, sd_unet_state_dict_from_flax
from diffusion_uncertainty_torch.ops import (
    avg_pool_2x2,
    avg_pool_2x2_pair,
    dot_product_attention,
    group_norm_silu,
    interleave_and_upsample_2x,
    interleave_phases_2x,
    nearest_upsample_2x,
)
from diffusion_uncertainty_torch.pipelines.text_encoder import pseudo_text_embeddings as t_pseudo
from diffusion_uncertainty_torch.scripts import generate_t2i_guided as tcli
from diffusion_uncertainty_torch.utils import TorchNoise
from diffusion_uncertainty_tpu.models import AutoencoderKL, AutoencoderKLConfig, SDUNet, SDUNetConfig
from diffusion_uncertainty_tpu.models.convert import convert_autoencoder_kl, convert_sd_unet
from diffusion_uncertainty_tpu.ops import fused_upsample as jfu
from diffusion_uncertainty_tpu.ops.attention import _flash_with_xla_grad
from diffusion_uncertainty_tpu.ops.flash_attention import _flash_attention
from diffusion_uncertainty_tpu.pipelines.text_encoder import pseudo_text_embeddings

# float32 both sides; the sums of convs, matmuls and attention run in
# another order
MODEL_ATOL = 1e-4
OP_ATOL = 1e-5


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def test_sd_unet_tiny_forward_matches_jax():
    jcfg, tcfg = SDUNetConfig.tiny(), TSDUNetConfig.tiny()
    sd = make_sd_unet_state_dict(tcfg, seed=2)
    model = TSDUNet(tcfg)
    model.load_state_dict(torch_state_dict(sd))  # strict: diffusers keys and shapes
    model.eval()
    rng = np.random.RandomState(0)
    x = _rand(rng, 2, 8, 8, 4)
    ctx = _rand(rng, 2, 5, 16)
    ref = SDUNet(jcfg).apply(convert_sd_unet(sd, jcfg), jnp.asarray(x), jnp.asarray(321), jnp.asarray(ctx))
    with torch.no_grad():
        out = model(torch.from_numpy(x), 321, torch.from_numpy(ctx))
    assert out.dtype == torch.float32 and out.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MODEL_ATOL, rtol=0)
    # per-sample timesteps take the same path as the JAX [B] timesteps
    ref_t = SDUNet(jcfg).apply(convert_sd_unet(sd, jcfg), jnp.asarray(x), jnp.asarray([321, 20]), jnp.asarray(ctx))
    with torch.no_grad():
        out_t = model(torch.from_numpy(x), torch.tensor([321, 20]), torch.from_numpy(ctx))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_t), atol=MODEL_ATOL, rtol=0)


def test_vae_tiny_decode_matches_jax():
    jcfg = AutoencoderKLConfig.tiny()
    sd = make_vae_state_dict(jcfg, seed=3)
    vae = TAutoencoderKL(TAutoencoderKLConfig.tiny())
    vae.load_state_dict(torch_state_dict(sd))  # the encoder's keys are set aside
    vae.eval()
    z = _rand(np.random.RandomState(1), 2, 4, 4, 4)
    ref = AutoencoderKL(jcfg).apply(convert_autoencoder_kl(sd, jcfg), jnp.asarray(z), "decode")
    with torch.no_grad():
        out = vae.decode(torch.from_numpy(z))
    assert out.dtype == torch.float32 and out.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MODEL_ATOL, rtol=0)


def test_sd_unet_state_dict_from_flax_inverts_convert():
    jcfg = SDUNetConfig.tiny()
    sd = make_sd_unet_state_dict(TSDUNetConfig.tiny(), seed=1)
    params = convert_sd_unet(sd, jcfg)
    back = sd_unet_state_dict_from_flax(params, jcfg)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    again = convert_sd_unet({k: v.numpy() for k, v in back.items()}, jcfg)
    jax.tree.map(np.testing.assert_array_equal, again, params)


def test_autoencoder_kl_state_dict_from_flax_inverts_convert():
    jcfg = AutoencoderKLConfig.tiny()
    sd = make_vae_state_dict(jcfg, seed=4)
    assert any(k.startswith("encoder.") for k in sd) and "quant_conv.weight" in sd
    params = convert_autoencoder_kl(sd, jcfg)
    back = autoencoder_kl_state_dict_from_flax(params, jcfg)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    # decode-only parameters (no encoder) give the decoder's keys only
    dec_only = {"params": {k: v for k, v in params["params"].items() if k in ("decoder", "post_quant_conv")}}
    keys = set(autoencoder_kl_state_dict_from_flax(dec_only, jcfg))
    assert keys == {k for k in sd if k.startswith(("decoder.", "post_quant_conv."))}


def _shape_views(shapes):
    return jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)


@pytest.mark.parametrize("which", ["sd_unet", "vae"])
def test_full_width_keys_and_shapes_match_jax(monkeypatch, which):
    """SD 1.5 UNet (859.5M parameters) and VAE decoder keys and shapes at full
    width: torch on the meta device, JAX through eval_shape, carried across as
    zero-stride views."""
    monkeypatch.setattr(tconvert._Out, "put", lambda self, key, a: self.sd.__setitem__(key, tuple(np.shape(a))))
    if which == "sd_unet":
        jcfg = SDUNetConfig.sd15()
        with torch.device("meta"):
            model = TSDUNet(TSDUNetConfig.sd15())
        shapes = jax.eval_shape(
            lambda k: SDUNet(jcfg).init(k, jnp.zeros((1, 64, 64, 4)), jnp.asarray(1), jnp.zeros((1, 77, 768))),
            jax.random.key(0),
        )
        got = sd_unet_state_dict_from_flax(_shape_views(shapes), jcfg)
        n_params_m = 859.5
    else:
        jcfg = AutoencoderKLConfig.sd_kl_ema()
        with torch.device("meta"):
            model = TAutoencoderKL(TAutoencoderKLConfig.sd_kl_ema())
        shapes = jax.eval_shape(lambda k: AutoencoderKL(jcfg).init(k, jnp.zeros((1, 64, 64, 4)), "decode"), jax.random.key(0))
        got = autoencoder_kl_state_dict_from_flax(_shape_views(shapes), jcfg)
        n_params_m = 49.5
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert abs(sum(int(np.prod(s)) for s in want.values()) / 1e6 - n_params_m) < 0.1
    assert got == want


@pytest.mark.parametrize("d", [40, 128])  # the fold path and the lane path of `_flash_attention`
@pytest.mark.parametrize("kv_len", [None, 500])
def test_attention_plain_matches_long_key_flash_kernel(d, kv_len):
    """The Pallas online-softmax ``_kernel`` (interpret mode, 4 key blocks of
    128) against the port's plain version and its ``dot_product_attention``."""
    rng = np.random.RandomState(d)
    q, k, v = (_rand(rng, 1, 512, 2, d) for _ in range(3))
    ref = _flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bk=128, whole_row=False, kv_len=kv_len)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(attention_plain(tq, tk, tv, kv_len).numpy(), np.asarray(ref), atol=OP_ATOL, rtol=0)
    np.testing.assert_allclose(dot_product_attention(tq, tk, tv, kv_len).numpy(), np.asarray(ref), atol=OP_ATOL, rtol=0)


def _vjp_both(jfn, tfn, ins, seed):
    """(port grads, JAX grads) of the two functions for one cotangent."""
    out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in ins))
    ct = _rand(np.random.RandomState(seed), *out.shape)
    jgrads = vjp(jnp.asarray(ct))
    tins = [torch.from_numpy(a).requires_grad_() for a in ins]
    tgrads = torch.autograd.grad(tfn(*tins), tins, torch.from_numpy(ct))
    return [g.numpy() for g in tgrads], [np.asarray(g) for g in jgrads]


@pytest.mark.parametrize("scale_shift,silu", [(True, True), (False, True), (False, False)])
def test_group_norm_backward_matches_jax_vjp(scale_shift, silu):
    """``_GroupNorm.backward`` against ``jax.vjp`` through the Pallas GN
    (interpret mode) and its ``_pallas_gn_bwd``."""
    rng = np.random.RandomState(7)
    x = _rand(rng, 2, 4, 4, 128, scale=2.0, shift=0.3)
    gamma, beta = _rand(rng, 128, scale=0.2, shift=1.0), _rand(rng, 128, scale=0.2)
    ins = [x, gamma, beta]
    if scale_shift:
        ins += [_rand(rng, 2, 128, scale=0.3), _rand(rng, 2, 128, scale=0.3)]

    def jfn(*a):
        sc, sh = (a[3], a[4]) if scale_shift else (None, None)
        return jgn.group_norm_silu(a[0], a[1], a[2], 32, 1e-6, sc, sh, apply_silu=silu, use_pallas=True)

    def tfn(*a):
        sc, sh = (a[3], a[4]) if scale_shift else (None, None)
        return group_norm_silu(a[0], a[1], a[2], 32, 1e-6, sc, sh, apply_silu=silu)

    for got, want in zip(*_vjp_both(jfn, tfn, ins, 8)):
        np.testing.assert_allclose(got, want, atol=OP_ATOL, rtol=0)


@pytest.mark.parametrize("kv_len", [None, 80])
def test_attention_backward_matches_jax_vjp(kv_len):
    """``attention_bwd`` against ``jax.vjp`` of the flash kernel with its
    ``_flash_bwd`` (77-style ragged keys masked by ``kv_len``)."""
    rng = np.random.RandomState(9)
    ins = [_rand(rng, 2, 64, 2, 40), _rand(rng, 2, 96, 2, 40), _rand(rng, 2, 96, 2, 40)]
    got, want = _vjp_both(
        lambda q, k, v: _flash_with_xla_grad(q, k, v, kv_len),
        lambda q, k, v: dot_product_attention(q, k, v, kv_len),
        ins,
        10,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=OP_ATOL, rtol=0)


def test_interleave_backward_matches_jax_vjp():
    rng = np.random.RandomState(11)
    ins = [_rand(rng, 2, 3, 4, 128) for _ in range(4)]
    got, want = _vjp_both(jfu._interleave_nhwc, interleave_phases_2x, ins, 12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize(
    "op,shapes",
    [
        ("group_norm", [(2, 4, 4, 64), (64,), (64,)]),
        ("attention", [(2, 16, 2, 40), (2, 24, 2, 40), (2, 24, 2, 40)]),
        ("interleave", [(2, 3, 4, 8)] * 4),
        ("avg_pool", [(2, 4, 6, 8)]),
        ("avg_pool_pair", [(2, 4, 6, 8)] * 2),
        ("interleave_pair", [(2, 3, 4, 8)] * 5),
        ("nearest", [(2, 3, 4, 8)]),
    ],
)
def test_ops_record_a_graph_only_when_a_gradient_is_needed(op, shapes):
    """With no input that needs a gradient (the no-grad sampling loops) an op
    calls its kernel wrapper directly and records nothing; with one it goes
    through its ``autograd.Function``. Both give the same values (every
    output of a paired op)."""
    fn = {
        "group_norm": lambda x, g, b: group_norm_silu(x, g, b, 32, 1e-6),
        "attention": dot_product_attention,
        "interleave": interleave_phases_2x,
        "avg_pool": avg_pool_2x2,
        "avg_pool_pair": avg_pool_2x2_pair,
        "interleave_pair": lambda *t: interleave_and_upsample_2x(t[:4], t[4]),
        "nearest": nearest_upsample_2x,
    }[op]
    rng = np.random.RandomState(13)
    ins = [torch.from_numpy(_rand(rng, *s)) for s in shapes]

    def outs(r):
        return r if isinstance(r, tuple) else (r,)

    direct = outs(fn(*ins))
    assert all(t.grad_fn is None for t in direct)
    with torch.no_grad():
        assert all(t.grad_fn is None for t in outs(fn(*(t.clone().requires_grad_(True) for t in ins))))
    recorded = outs(fn(ins[0].clone().requires_grad_(True), *ins[1:]))
    backward = {"group_norm": "_GroupNormBackward", "attention": "_AttentionBackward", "interleave": "_InterleaveBackward",
                "avg_pool": "_AvgPoolBackward", "avg_pool_pair": "_AvgPoolPairBackward",
                "interleave_pair": "_InterleaveUpsampleBackward", "nearest": "_NearestBackward"}[op]
    for r, d in zip(recorded, direct):
        assert type(r.grad_fn).__name__ == backward
        torch.testing.assert_close(r.detach(), d, atol=0, rtol=0)


def test_pseudo_text_embeddings_bit_identical():
    prompts = ["a photo of a cat", "", "a photo of a cat"]
    np.testing.assert_array_equal(t_pseudo(prompts), pseudo_text_embeddings(prompts))
    np.testing.assert_array_equal(t_pseudo(prompts, seq_len=5, dim=16), pseudo_text_embeddings(prompts, seq_len=5, dim=16))


def test_entry_points_default_to_the_card(monkeypatch):
    """With no card, the entry points raise unless asked for the CPU; they
    never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcli.Config(model="tiny", random_init=True)
    for call in (t_make_schedule, lambda: TorchNoise(0), lambda: tcli.build_sd_stack(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcli.main(["--model", "tiny", "--random-init", "true"])
    stack = tcli.build_sd_stack(cfg, device="cpu")
    assert stack.schedule.device.type == "cpu" and next(stack.unet.parameters()).device.type == "cpu"
    assert TorchNoise(0, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("model,argv,item", [("sd21", [], None),
                                             ("sd3", ["--model", "sd3", "--text-towers", "small"], "item 12"),
                                             ("flux", ["--model", "flux", "--streamed", "true"], "item 16")],
                         ids=["sd21", "text_towers", "streamed"])
def test_cli_names_the_roadmap_item_of_unported_models(monkeypatch, tmp_path, model, argv, item):
    """What is still unported exits naming its ROADMAP.md item: the streamed
    executor (item 16) and JAX's orbax form of the towers' parameters (item
    12, ``utils/checkpoint.py``; the towers narrowed here to the tiny
    configs). SD 2.1, once item 22, builds (on the meta device: nothing is
    allocated or drawn)."""
    if item is None:
        monkeypatch.setattr(tcli, "init_random_", lambda m, seed: m)
        stack = tcli.build_sd_stack(dataclasses.replace(tcli.Config(), model=model, random_init=True), device="meta")
        assert stack.mcfg == TSDUNetConfig.sd21() and stack.vae is None and stack.latent_size == 64
        assert {p.dtype for p in stack.unet.parameters()} == {torch.bfloat16}
        return
    if item == "item 12":
        import diffusion_uncertainty_torch.models.clip_text as tclip
        import diffusion_uncertainty_torch.models.t5_text as tt5

        tiny_clip = tclip.CLIPTextConfig.tiny()
        for name in ("vit_l_14_projected", "vit_bigg_14"):
            monkeypatch.setattr(tclip.CLIPTextConfig, name, staticmethod(lambda: dataclasses.replace(
                tiny_clip, max_position_embeddings=77, eos_token_id=49407, vocab_size=49408)))
        monkeypatch.setattr(tt5.T5Config, "v1_1_xxl", staticmethod(lambda: dataclasses.replace(tt5.T5Config.tiny(), vocab_size=32128)))
        (tmp_path / "clip_l").mkdir()  # JAX's orbax checkpoint directory of a tower
        argv = argv + ["--towers-params-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match=f"ROADMAP.md queue 1, {item}"):
        tcli.main(argv + ["--random-init", "true", "--device", "cpu"])


def test_t2i_cli_main_writes_its_four_files(tmp_path):
    argv = ["--model", "tiny", "--random-init", "true", "--device", "cpu", "--out-dir", str(tmp_path),
            "--num-steps", "4", "--num-steps-threshold", "2"]
    assert tcli.main(argv) == 0
    dest = tmp_path / "0"
    assert sorted(p.name for p in dest.iterdir()) == ["args.yaml", "output_sd.png", "output_sd_uc.png", "uncertainty.npz"]
    u = np.load(dest / "uncertainty.npz")["data"]
    assert u.shape == (1, 2, 8, 8, 4) and np.isfinite(u).all() and u.mean() > 0
    png = (dest / "output_sd_uc.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and int.from_bytes(png[16:20], "big") == 16  # 8x8 latent -> 16 px
    args = (dest / "args.yaml").read_text()
    assert "pseudo_text: true" in args and 'model: "tiny"' in args
    assert tcli.main(argv) == 0 and (tmp_path / "1").is_dir()  # numbered folders
