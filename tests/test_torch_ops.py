"""Kernel-holding ops of the port against the JAX package, float32 on the CPU.

Each port op runs its plain PyTorch version here (the tensors lie on the
CPU); the JAX op runs both its XLA route (``use_pallas=False``) and its Pallas
route in interpret mode, as ``tests/test_ops.py`` runs it. Tolerance: max abs
1e-5 (attention 2e-5, for the summation order of the logits and of P·V).
The Hopper kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``; the ``cuda`` tests below do the same where a card
is present.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_uncertainty_tpu.ops.groupnorm as jgn
from diffusion_uncertainty_torch.kernels import attention as katt
from diffusion_uncertainty_torch.kernels.attention import attention as attention_kernel
from diffusion_uncertainty_torch.kernels.attention import attention_plain
from diffusion_uncertainty_torch.kernels.avgpool import avg_pool_2x2 as avgpool_kernel
from diffusion_uncertainty_torch.kernels.avgpool import avg_pool_2x2_plain
from diffusion_uncertainty_torch.kernels.groupnorm import gn_apply, gn_apply_plain, gn_stats, gn_stats_plain
from diffusion_uncertainty_torch.kernels.interleave import interleave_2x, interleave_2x_plain
from diffusion_uncertainty_torch.models.layers import split_qkv
from diffusion_uncertainty_torch.ops import avg_pool_2x2, dot_product_attention, group_norm_silu
from diffusion_uncertainty_torch.ops.fused_upsample import (
    conv3x3_nearest_up2,
    interleave_phases_2x,
    nearest_upsample_2x,
    upsample2_conv1x1,
)
from diffusion_uncertainty_tpu.ops import fused_upsample as jfu
from diffusion_uncertainty_tpu.ops.attention import dot_product_attention as j_attention
from diffusion_uncertainty_tpu.ops.avgpool import avg_pool_2x2 as j_avg_pool
from diffusion_uncertainty_tpu.ops.flash_attention import flash_attention as j_flash

ATOL = 1e-5
ATTN_ATOL = 2e-5


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


def _gn_inputs(seed, b, h, w, c, scale_shift):
    rng = np.random.RandomState(seed)
    x = _rand(rng, b, h, w, c, scale=2.0, shift=0.3)
    gamma = _rand(rng, c, scale=0.2, shift=1.0)
    beta = _rand(rng, c, scale=0.2)
    sc = _rand(rng, b, c, scale=0.3) if scale_shift else None
    sh = _rand(rng, b, c, scale=0.3) if scale_shift else None
    return x, gamma, beta, sc, sh


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _port_gn(x, gamma, beta, groups, sc, sh, silu):
    return group_norm_silu(_t(x), _t(gamma), _t(beta), num_groups=groups, scale=_t(sc), shift=_t(sh), apply_silu=silu).numpy()


@pytest.mark.parametrize("c", [32, 128, 256])
@pytest.mark.parametrize("groups", [32, 8])
@pytest.mark.parametrize("scale_shift,silu", [(True, True), (False, True), (False, False)])
def test_group_norm_matches_jax_xla_route(c, groups, scale_shift, silu):
    x, gamma, beta, sc, sh = _gn_inputs(c + groups, 2, 8, 8, c, scale_shift)
    ref = jgn.group_norm_silu(_j(x), _j(gamma), _j(beta), num_groups=groups, scale=_j(sc), shift=_j(sh), apply_silu=silu, use_pallas=False)
    out = _port_gn(x, gamma, beta, groups, sc, sh, silu)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=0)


# (Pallas function, batch, H=W, env switches): B=8 with HW·C·4 > 128 KB
# reaches the [HW, N, C] kernels, B=2 the [B, HW, C] ones by slab size
_GN_ROUTES = {
    "_kernel": (2, 8, {}),
    "_tiled_kernel": (2, 32, {}),
    "_hwnc_kernel": (8, 32, {"DU_TPU_GN_STATS_ONLY": "0"}),
    "_stats_kernel": (8, 32, {"DU_TPU_GN_XLA_STATS": "0"}),
}


@pytest.mark.parametrize("route", sorted(_GN_ROUTES))
@pytest.mark.parametrize("c,groups,scale_shift", [(128, 32, True), (256, 8, False)])
def test_group_norm_matches_jax_pallas_route(monkeypatch, route, c, groups, scale_shift):
    b, hw, env = _GN_ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x, gamma, beta, sc, sh = _gn_inputs(7, b, hw, hw, c, scale_shift)
    called = []
    target = getattr(jgn, route)
    monkeypatch.setattr(jgn, route, lambda *a, **kw: called.append(route) or target(*a, **kw))
    ref = jgn.group_norm_silu(_j(x), _j(gamma), _j(beta), num_groups=groups, scale=_j(sc), shift=_j(sh), use_pallas=True)
    out = _port_gn(x, gamma, beta, groups, sc, sh, True)
    assert called, f"the JAX call did not reach {route}"
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("c,groups,scale_shift", [(32, 32, True), (128, 8, False), (96, 6, True)])
def test_gn_kernel_pair_plain_versions_match_jax(c, groups, scale_shift):
    """gn_stats + gn_apply (the kernels' plain versions on CPU tensors) give
    the op: the arithmetic the CUDA pair implements."""
    x, gamma, beta, sc, sh = _gn_inputs(3, 2, 4, 4, c, scale_shift)
    a, b = gn_stats(_t(x), _t(gamma), _t(beta), groups, 1e-5, _t(sc), _t(sh))
    assert a.dtype == b.dtype == torch.float32 and a.shape == (2, c)
    out = gn_apply(_t(x), a, b, True).numpy()
    ref = jgn.group_norm_silu(_j(x), _j(gamma), _j(beta), num_groups=groups, scale=_j(sc), shift=_j(sh), use_pallas=False)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=0)


def test_group_norm_rejects_bad_arguments():
    x = torch.zeros(1, 2, 2, 12)
    with pytest.raises(ValueError):
        group_norm_silu(x, torch.ones(12), torch.zeros(12), scale=torch.zeros(1, 12))
    with pytest.raises(ValueError):
        group_norm_silu(x, torch.ones(12), torch.zeros(12), num_groups=5)


def _qkv(seed, b, s, h, d, legacy):
    rng = np.random.RandomState(seed)
    qkv = _rand(rng, b, s, 3 * h * d)
    q, k, v = split_qkv(torch.from_numpy(qkv), h, legacy)
    return q, k, v


@pytest.mark.parametrize("d", [32, 128, 192, 256])
@pytest.mark.parametrize("s", [64, 256])
def test_attention_matches_jax(d, s):
    h = 2
    q, k, v = _qkv(d + s, 1, s, h, d, legacy=d % 64 == 0)
    assert q.stride(-1) == 1 and not q.is_contiguous()  # views into the projection
    out = dot_product_attention(q, k, v).numpy()
    jq, jk, jv = (jnp.asarray(t.contiguous().numpy()) for t in (q, k, v))
    ref_xla = np.asarray(j_attention(jq, jk, jv, use_pallas=False))
    np.testing.assert_allclose(out, ref_xla, atol=ATTN_ATOL, rtol=0)
    # Pallas route in interpret mode: the packed-head kernel at these lengths
    ref_packed = np.asarray(j_attention(jq, jk, jv, use_pallas=True))
    np.testing.assert_allclose(out, ref_packed, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("d", [32, 128])
def test_attention_matches_jax_whole_row_flash(d):
    """The whole-row flash kernel (head-sliced for D=128, fold+pad for D=32)."""
    q, k, v = _qkv(5, 1, 128, 2, d, legacy=False)
    out = dot_product_attention(q, k, v).numpy()
    jq, jk, jv = (jnp.asarray(t.contiguous().numpy()) for t in (q, k, v))
    np.testing.assert_allclose(out, np.asarray(j_flash(jq, jk, jv)), atol=ATTN_ATOL, rtol=0)


def test_attention_kv_len_mask_matches_jax():
    q, k, v = _qkv(9, 1, 64, 2, 64, legacy=True)
    out = dot_product_attention(q, k, v, kv_len=50).numpy()
    jq, jk, jv = (jnp.asarray(t.contiguous().numpy()) for t in (q, k, v))
    ref = np.asarray(j_flash(jq, jk, jv, kv_len=50))
    np.testing.assert_allclose(out, ref, atol=ATTN_ATOL, rtol=0)
    ref_trunc = np.asarray(j_attention(jq, jk[:, :50], jv[:, :50], use_pallas=False))
    np.testing.assert_allclose(out, ref_trunc, atol=ATTN_ATOL, rtol=0)


def test_avg_pool_matches_jax():
    x = _rand(np.random.RandomState(1), 8, 6, 4, 128)
    out = avg_pool_2x2(torch.from_numpy(x)).numpy()
    for use_pallas in (False, True):
        ref = np.asarray(j_avg_pool(jnp.asarray(x), use_pallas=use_pallas))
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_interleave_and_nearest_upsample_match_jax():
    rng = np.random.RandomState(2)
    ys = [_rand(rng, 8, 3, 4, 128) for _ in range(4)]
    out = interleave_phases_2x(*(torch.from_numpy(y) for y in ys)).numpy()
    up = nearest_upsample_2x(torch.from_numpy(ys[0])).numpy()
    for use_pallas in (False, True):
        ref = np.asarray(jfu.interleave_phases_2x(*(jnp.asarray(y) for y in ys), use_pallas=use_pallas))
        np.testing.assert_array_equal(out, ref)
        ref_up = np.asarray(jfu.nearest_upsample_2x(jnp.asarray(ys[0]), use_pallas=use_pallas))
        np.testing.assert_array_equal(up, ref_up)


def test_fused_upsample_convs_match_jax():
    rng = np.random.RandomState(4)
    x = _rand(rng, 2, 5, 6, 16)
    w = _rand(rng, 24, 16, 3, 3, scale=0.2)  # torch layout [K, C, kh, kw]
    b = _rand(rng, 24)
    w1 = _rand(rng, 24, 16, 1, 1, scale=0.2)
    out = conv3x3_nearest_up2(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    ref = jfu.conv3x3_nearest_up2(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b))
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=0)
    out1 = upsample2_conv1x1(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(b)).numpy()
    ref1 = jfu.upsample2_conv1x1(jnp.asarray(x), jnp.asarray(w1.transpose(2, 3, 1, 0)), jnp.asarray(b))
    np.testing.assert_allclose(out1, np.asarray(ref1), atol=ATOL, rtol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernels_on_card(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dtype)  # noqa: E731
    x, gn_args = r(2, 16, 16, 64), (r(64), r(64), 8, 1e-5, r(2, 64), r(2, 64))
    a, b = gn_stats(x, *gn_args)
    ap, bp = gn_stats_plain(x, *gn_args)
    assert (a - ap).abs().max() <= 1e-4 and (b - bp).abs().max() <= 1e-4
    y, yp = gn_apply(x, a, b), gn_apply_plain(x, a, b)
    # bf16: one rounding step of the output (2^-7 relative) on top of tol
    assert (y.float() - yp.float()).abs().max() <= tol + 2**-7 * yp.float().abs().max()
    # bf16 routes: tensor cores at SD's 40/80/160 and ADM's 64, CUDA cores at 72,
    # the wide kernel at 512 (64 keys: four splits and the combine); float32:
    # CUDA cores up to 256, the wide kernel (3xTF32) at 512
    bf16 = dtype == torch.bfloat16
    for d, heads, want in ((40, 2, "tensor_core"), (64, 2, "tensor_core"), (72, 2, "cuda_core"),
                           (80, 2, "tensor_core"), (160, 2, "tensor_core"), (512, 1, "wide")):
        q, k, v = split_qkv(r(2, 64, 3 * heads * d), heads, True)
        katt.ROUTE_LAUNCHES.clear()
        out = attention_kernel(q, k, v)
        assert katt.ROUTE_LAUNCHES[want if bf16 or d == 512 else "cuda_core"] == 1
        assert (out.float() - attention_plain(q, k, v).float()).abs().max() <= tol
    xp = r(2, 8, 8, 128)
    assert (avgpool_kernel(xp).float() - avg_pool_2x2_plain(xp).float()).abs().max() <= tol
    ys = [r(2, 4, 4, 128) for _ in range(4)]
    assert torch.equal(interleave_2x(*ys), interleave_2x_plain(*ys))
