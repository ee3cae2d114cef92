"""The port's ADM UNet against the JAX package: weights carried across both
ways, parameter keys and shapes at ImageNet-128 (no weights allocated), and
the float32 forward of the tiny configuration in both attention orders."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import make_adm_state_dict, torch_state_dict

import diffusion_uncertainty_torch.models.convert as tconvert
from diffusion_uncertainty_torch.models import ADMUNet as TADMUNet
from diffusion_uncertainty_torch.models import ADMUNetConfig as TADMUNetConfig
from diffusion_uncertainty_torch.models import adm_state_dict_from_flax
from diffusion_uncertainty_tpu.models import ADMUNet, ADMUNetConfig
from diffusion_uncertainty_tpu.models.convert import _legacy_qkv_permutation, convert_adm_unet


def _configs(new_order: bool, base=("tiny",)):
    jcfg = dataclasses.replace(getattr(ADMUNetConfig, base[0])(), use_new_attention_order=new_order)
    tcfg = dataclasses.replace(getattr(TADMUNetConfig, base[0])(), use_new_attention_order=new_order)
    return jcfg, tcfg


def test_legacy_permutation_matches_jax():
    for c, h in ((32, 2), (512, 4), (768, 4)):
        np.testing.assert_array_equal(tconvert.legacy_qkv_permutation(c, h), _legacy_qkv_permutation(c, h))


@pytest.mark.parametrize("new_order", [False, True])
def test_adm_state_dict_from_flax_inverts_convert(new_order):
    jcfg, _ = _configs(new_order)
    sd = make_adm_state_dict(jcfg, seed=1)
    back = adm_state_dict_from_flax(convert_adm_unet(sd, jcfg), jcfg)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("new_order", [False, True])
def test_tiny_forward_matches_jax(new_order):
    jcfg, tcfg = _configs(new_order)
    sd = make_adm_state_dict(jcfg, seed=2)
    model = TADMUNet(tcfg)
    model.load_state_dict(torch_state_dict(sd))  # strict: keys and shapes as the reference
    model.eval()
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    y = np.array([3, 8])
    ref = ADMUNet(jcfg).apply(convert_adm_unet(sd, jcfg), jnp.asarray(x), jnp.asarray(321), jnp.asarray(y))
    with torch.no_grad():
        out = model(torch.from_numpy(x), 321, torch.from_numpy(y))
    assert out.dtype == torch.float32 and out.shape == (2, 16, 16, jcfg.out_channels)
    # float32 both sides: summation order of convs and attention
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    # folded ensemble members: labels are tiled member-major
    with torch.no_grad():
        folded = model(torch.from_numpy(np.concatenate([x, x])), 321, torch.from_numpy(y))
    torch.testing.assert_close(folded[2:], out, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,new_order,n_params_m", [("imagenet128", False, 421.5), ("imagenet64", True, 295.9)])
def test_full_width_keys_and_shapes_match_jax(monkeypatch, name, new_order, n_params_m):
    """Parameter keys and shapes at full width: torch on the meta device,
    JAX through eval_shape, carried across as zero-stride views."""
    jcfg, tcfg = _configs(new_order, (name,))
    with torch.device("meta"):
        model = TADMUNet(tcfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    n_params = sum(int(np.prod(s)) for s in want.values())
    assert abs(n_params / 1e6 - n_params_m) < 0.1

    size = jcfg.image_size
    shapes = jax.eval_shape(
        lambda k: ADMUNet(jcfg).init(k, jnp.zeros((1, size, size, 3)), jnp.asarray(1), jnp.zeros((1,), jnp.int32)),
        jax.random.key(0),
    )
    views = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    monkeypatch.setattr(tconvert._Out, "put", lambda self, key, a: self.sd.__setitem__(key, tuple(np.shape(a))))
    got = adm_state_dict_from_flax(views, jcfg)
    assert got == want
