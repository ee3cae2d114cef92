"""The port's SD3 MMDiT against the JAX package, float32 on the CPU: the tiny
forward (with and without the RMS q/k norm) through the inverse converter,
the converter's exact round trip through JAX's ``convert_sd3_mmdit``, the
full-size parameter counts, per-block remat, and the joint attention at
lengths the JAX Pallas kernels pad or pack."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_uncertainty_tpu.ops.attention as jattn
from diffusion_uncertainty_torch.kernels import attention as katt
from diffusion_uncertainty_torch.models import MMDiT as TMMDiT
from diffusion_uncertainty_torch.models import MMDiTConfig as TMMDiTConfig
from diffusion_uncertainty_torch.models import mmdit_state_dict_from_flax
from diffusion_uncertainty_torch.ops import dot_product_attention
from diffusion_uncertainty_tpu.models import MMDiT, MMDiTConfig
from diffusion_uncertainty_tpu.models.convert import convert_sd3_mmdit

# float32 both sides; matmuls and norms sum in another order
FWD_REL = 1e-5

torch.set_num_threads(1)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _configs(qk_norm):
    return (dataclasses.replace(MMDiTConfig.tiny(), qk_norm=qk_norm),
            dataclasses.replace(TMMDiTConfig.tiny(), qk_norm=qk_norm))


@functools.cache
def _jax_params(jcfg, seed: int = 1):
    """JAX init, then every leaf moved by 0.1·N(0, 1) (the init's zero biases,
    unit norm scales and zero-centred gates would hide a swapped chunk);
    shared by the tests: treat as read-only."""
    rng = np.random.RandomState(seed)
    z = jcfg.sample_size
    params = jax.jit(MMDiT(jcfg).init)(jax.random.key(seed), jnp.zeros((1, z, z, jcfg.in_channels)), jnp.asarray(1.0),
                              jnp.zeros((1, 6, jcfg.joint_attention_dim)), jnp.zeros((1, jcfg.pooled_projection_dim)))
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32), params)


def _inputs(jcfg, b: int, seed: int):
    rng = np.random.RandomState(seed)
    z = jcfg.sample_size
    return (rng.randn(b, z, z, jcfg.in_channels).astype(np.float32),
            rng.randn(b, 6, jcfg.joint_attention_dim).astype(np.float32),
            rng.randn(b, jcfg.pooled_projection_dim).astype(np.float32))


def _port(tcfg, params):
    model = TMMDiT(tcfg)
    model.load_state_dict(mmdit_state_dict_from_flax(params, tcfg))  # strict: diffusers keys and shapes
    return model.eval()


@pytest.mark.parametrize("qk_norm", [None, "rms_norm"], ids=["sd3", "sd35_qk_norm"])
def test_tiny_forward_matches_jax(qk_norm):
    jcfg, tcfg = _configs(qk_norm)
    params = _jax_params(jcfg)
    model = _port(tcfg, params)
    x, ctx, pooled = _inputs(jcfg, 2, seed=2)
    for t in (np.float32(321.5), np.array([30.0, 987.25], np.float32)):  # one t, and one per image
        ref = jax.jit(MMDiT(jcfg).apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(pooled))
        with torch.no_grad():
            out = model(torch.from_numpy(x), torch.from_numpy(np.asarray(t)), torch.from_numpy(ctx), torch.from_numpy(pooled))
        assert out.dtype == torch.float32 and out.shape == (2, 8, 8, 16)
        assert _rel_l2(out.numpy(), ref) <= FWD_REL


@pytest.mark.parametrize("qk_norm", [None, "rms_norm"], ids=["sd3", "sd35_qk_norm"])
def test_converter_round_trips_exactly(qk_norm):
    jcfg, tcfg = _configs(qk_norm)
    params = _jax_params(jcfg)
    sd = mmdit_state_dict_from_flax(params, tcfg)
    back = convert_sd3_mmdit({k: v.numpy() for k, v in sd.items()}, jcfg)  # strict: every key taken
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)))
    last = f"transformer_blocks.{tcfg.num_layers - 1}"
    assert f"{last}.attn.to_add_out.weight" not in sd and f"{last}.ff_context.net.2.weight" not in sd
    assert ("transformer_blocks.0.attn.norm_added_k.weight" in sd) == (qk_norm == "rms_norm")


@pytest.mark.parametrize("which", ["sd3_medium", "sd35_large"])
def test_full_size_parameter_count_equals_jax(which):
    jcfg, tcfg = getattr(MMDiTConfig, which)(), getattr(TMMDiTConfig, which)()
    assert dataclasses.asdict(tcfg) == {k: v for k, v in dataclasses.asdict(jcfg).items() if k not in ("dtype", "sp_axis")}
    with torch.device("meta"):
        model = TMMDiT(tcfg)
    n_port = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(
        lambda k: MMDiT(jcfg).init(k, jnp.zeros((1, 64, 64, 16)), jnp.asarray(1.0), jnp.zeros((1, 16, 4096)),
                                   jnp.zeros((1, 2048))),
        jax.random.key(0),
    )
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n_port == n_jax
    assert {"sd3_medium": 2.0e9, "sd35_large": 8.1e9}[which] < n_port < {"sd3_medium": 2.1e9, "sd35_large": 8.2e9}[which]


def test_remat_gives_the_same_forward_and_gradient():
    jcfg, tcfg = _configs("rms_norm")
    params = _jax_params(jcfg)
    plain, remat = _port(tcfg, params), _port(dataclasses.replace(tcfg, remat=True), params)
    x, ctx, pooled = (torch.from_numpy(a) for a in _inputs(jcfg, 2, seed=5))
    grads = []
    for model in (plain, remat):
        xg = x.clone().requires_grad_(True)
        out = model(xg, 500.0, ctx, pooled)
        (g,) = torch.autograd.grad(out.square().sum(), xg)
        grads.append((out.detach(), g))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=0, rtol=0)
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("b,s,h,d,kernel", [(2, 80, 3, 64, "_packed_with_xla_grad"),
                                            (1, 530, 2, 128, "_flash_with_xla_grad")], ids=["packed_d64", "padded_d128"])
def test_joint_attention_matches_jax_kernels(monkeypatch, b, s, h, d, kernel):
    """The joint [image | text] attention as the models make it (q, k, v
    concatenated along the sequence): the port's op against JAX's
    ``dot_product_attention`` with the Pallas kernel in interpret mode (the
    packed-head kernel at D=64; at D=128 the flash kernel, on keys padded to
    a multiple of 8 and masked) and with ``use_pallas=False``."""
    rng = np.random.RandomState(s)
    img, txt = ([rng.randn(b, n, h, d).astype(np.float32) for _ in range(3)] for n in (s - 16, 16))
    q, k, v = (np.concatenate([a, c], axis=1) for a, c in zip(img, txt))
    out = dot_product_attention(*(torch.cat([torch.from_numpy(a), torch.from_numpy(c)], 1) for a, c in zip(img, txt)))
    assert np.array_equal(out.numpy(), katt.attention_plain(*(torch.from_numpy(a) for a in (q, k, v))).numpy())
    ran = []
    real = getattr(jattn, kernel)
    monkeypatch.setattr(jattn, kernel, lambda *a: ran.append(a[3]) or real(*a))
    for use_pallas in (True, False):
        ref = np.asarray(jattn.dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)), use_pallas=use_pallas))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * float(np.abs(ref).max()), rtol=0, err_msg=str(use_pallas))
    # the Pallas kernel ran once; at D=128 on keys padded past s with a mask
    assert ran == ([None] if d == 64 else [s])
    assert katt.route(torch.bfloat16, d, True) == "tensor_core"
