"""The Winograd F(2×2, 3×3) conv of the port against the JAX package, float32
on the CPU.

``kernels.winograd.winograd_conv_plain`` repeats the Hopper kernel's
arithmetic (bf16-rounded input transform, bf16 pre-transformed weights,
float32 products and output transform); it is held to the JAX Pallas kernel
run in interpret mode at ``tests/test_winograd.py``'s shapes, and both to the
direct conv at JAX's own tolerance. Every comparison with the Pallas kernel
sets ``DU_TPU_WINO_NOGATE=1`` (the v5e roofline gate in ``_tile_params``
would route some shapes to ``lax.conv``) and asserts the JAX ``supports`` at
its shape, so the JAX side really runs the kernel. The Hopper kernel itself
is held against the plain version on the card by ``chip_smoke.py`` and the
``cuda`` test below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import make_adm_state_dict, torch_state_dict

import diffusion_uncertainty_torch.kernels.winograd as twk
import diffusion_uncertainty_tpu.ops.winograd_conv as wc
from diffusion_uncertainty_torch.models import ADMUNet as TADMUNet
from diffusion_uncertainty_torch.models import ADMUNetConfig as TADMUNetConfig
from diffusion_uncertainty_torch.models.layers import Conv3x3
from diffusion_uncertainty_torch.ops.winograd_conv import conv3x3_winograd, reference_conv, supports
from diffusion_uncertainty_tpu.models import ADMUNet, ADMUNetConfig
from diffusion_uncertainty_tpu.models.convert import convert_adm_unet

# float32 activations: the two sides round the same bf16 operands and differ
# only in the float32 summation order of the 16 products (measured: at most
# 1.4e-6 of max|ref| at these shapes)
F32_REL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _case(seed, n, h, w, c, k, res):
    rng = np.random.RandomState(seed)
    x = _rand(rng, n, h, w, c)
    wt = _rand(rng, 3, 3, c, k, scale=0.05)  # HWIO, the JAX layout
    b = _rand(rng, k)
    r = _rand(rng, n, h, w, k) if res else None
    return x, wt, b, r


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _torch_w(wt):
    return _t(wt.transpose(3, 2, 0, 1))  # [K, C, 3, 3]


def _pallas(monkeypatch, x, wt, b, r, dtype):
    monkeypatch.setenv("DU_TPU_WINO_NOGATE", "1")
    assert wc.supports(x.shape, wt.shape, (1, 1), (1, 1))
    cast = lambda a: None if a is None else jnp.asarray(a).astype(dtype)  # noqa: E731
    return np.asarray(wc.conv3x3_winograd(cast(x), cast(wt), cast(b), cast(r), use_pallas=True).astype(jnp.float32))


def _plain(x, wt, b, r, dtype):
    cast = lambda a: None if a is None else _t(a).to(dtype)  # noqa: E731
    w = _torch_w(wt).to(dtype)
    out = twk.winograd_conv_plain(cast(x), twk.weight_transform(w), cast(b).to(dtype).float(), cast(r))
    assert out.dtype == dtype
    return out.float().numpy()


# tests/test_winograd.py's shapes: one and two output-channel chunks, with and
# without the residual, float32 and bfloat16 storage
CASES = [
    ((8, 8, 16, 128, 128, False), "f32"),
    ((8, 8, 16, 128, 128, True), "f32"),
    ((8, 12, 32, 128, 256, False), "f32"),
    ((8, 12, 32, 128, 256, True), "f32"),
    ((8, 8, 16, 128, 128, False), "bf16"),
    ((8, 8, 16, 128, 128, True), "bf16"),
    ((8, 12, 32, 128, 256, True), "bf16"),
]


@pytest.mark.parametrize("shape,dt", CASES)
def test_plain_matches_pallas_kernel(monkeypatch, shape, dt):
    x, wt, b, r = _case(sum(shape[:5]), *shape)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = _pallas(monkeypatch, x, wt, b, r, jdt)
    got = _plain(x, wt, b, r, tdt)
    ref_max = float(np.abs(ref).max())
    if dt == "f32":
        np.testing.assert_allclose(got, ref, atol=F32_REL * ref_max, rtol=0)
    else:
        # bf16 outputs: the float32 values before the final rounding differ in
        # summation order only, so the stored values differ by at most one
        # bf16 rounding step (2^-8 relative) at the largest output
        np.testing.assert_allclose(got, ref, atol=2.0**-8 * ref_max, rtol=0)


@pytest.mark.parametrize("c,k", [(128, 128), (64, 136), (32, 8)])
def test_weight_transform_matches_jax(c, k):
    """The tiled U, unpacked, is the JAX ``_weight_transform`` (bf16, exact:
    both compute G g Gᵀ in float32 and round once), with zero columns from K
    up to Kp; each 32 KB tile holds column b's four positions of 128 output x
    32 input channels in 8 x 8 core matrices."""
    rng = np.random.RandomState(c + k)
    wt = _rand(rng, 3, 3, c, k, scale=0.05)
    u = twk.weight_transform(_torch_w(wt))
    assert u.shape == twk.u_shape(c, k) and u.dtype == torch.bfloat16 and u.is_contiguous()
    want = np.asarray(wc._weight_transform(jnp.asarray(wt), k).astype(jnp.float32))[0]  # [16, C, K]
    np.testing.assert_array_equal(twk.unpack_u(u, k).float().numpy(), want)
    kp = u.shape[0] * twk.K_ALIGN
    assert kp % 128 == 0 and kp >= k and not bool(twk.unpack_u(u, kp)[:, :, k:].any())
    # tile (kb, cc, b), position a, core matrix (k/8, c/8), row k%8, column c%8
    kk, cc, a, b = k - 1, c - 1, 2, 3
    tile = u[kk // 128, cc // 32, b, a]
    assert float(tile[(kk % 128) // 8, (cc % 32) // 8, kk % 8, cc % 8]) == float(want[4 * a + b, cc, kk])


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("shape", [(8, 8, 16, 128, 128), (8, 12, 32, 128, 256)])
def test_plain_matches_direct_conv(shape, res):
    """The Winograd route against the direct conv at JAX's own tolerance
    (``tests/test_winograd.py``: atol 0.05; the bf16 operands are the only
    rounding)."""
    x, wt, b, r = _case(3, *shape, res)
    ref = reference_conv(_t(x), _torch_w(wt), _t(b), _t(r)).numpy()
    np.testing.assert_allclose(_plain(x, wt, b, r, torch.float32), ref, atol=0.05, rtol=0)
    jref = np.asarray(wc._reference_conv(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), None if r is None else jnp.asarray(r)))
    np.testing.assert_allclose(ref, jref, atol=1e-4, rtol=0)  # the direct convs of the two packages


def test_supports_gate():
    """``tests/test_winograd.py::test_supports_gate``'s cases, torch weight layout."""
    kchw = lambda s: (s[3], s[2], s[0], s[1])  # noqa: E731  HWIO -> [K, C, 3, 3]
    cases = [
        ((8, 8, 16, 128), (3, 3, 128, 128), (1, 1), True),
        ((8, 8, 16, 128), (3, 3, 128, 128), (2, 2), False),
        ((8, 8, 16, 128), (1, 1, 128, 128), (1, 1), False),
        ((8, 8, 16, 96), (3, 3, 96, 128), (1, 1), False),
        ((8, 8, 16, 128), (3, 3, 128, 6), (1, 1), False),
        ((8, 6, 16, 128), (3, 3, 128, 128), (1, 1), False),
    ]
    for xs, ws, stride, want in cases:
        assert supports(xs, kchw(ws), stride, (1, 1)) is want, (xs, ws, stride)
        assert wc.supports(xs, ws, stride, (1, 1)) is want
    assert not supports((8, 8, 16, 128), (128, 128, 3, 3), (1, 1), (2, 2))
    assert not supports((8, 8, 16, 128), (128, 256, 3, 3))  # input channels differ
    assert supports((2, 16, 16, 384), (320, 384, 3, 3))  # no TPU tiling rule on K


def test_op_routes_by_shape_and_flag(monkeypatch):
    """``use_kernel=False`` and unsupported shapes give the direct conv; a
    supported shape with ``use_kernel=True`` runs the Winograd arithmetic
    (the plain version on a CPU tensor), decided before any call."""
    calls = []
    plain = twk.winograd_conv_plain
    monkeypatch.setattr(twk, "winograd_conv_plain", lambda *a: calls.append(1) or plain(*a))
    x, wt, b, r = (_t(a) for a in _case(5, 2, 8, 8, 128, 128, True))
    w = _torch_w(wt.numpy())
    direct = reference_conv(x, w, b, r.clone())
    assert torch.equal(conv3x3_winograd(x, w, b, r.clone()), direct) and not calls
    wino = conv3x3_winograd(x, w, b, r.clone(), use_kernel=True)
    assert len(calls) == 1 and not torch.equal(wino, direct)
    torch.testing.assert_close(wino, direct, atol=0.05, rtol=0)
    x6 = x[:, :6]  # H % 4 != 0: the direct conv
    assert torch.equal(conv3x3_winograd(x6, w, b, use_kernel=True), reference_conv(x6, w, b)) and len(calls) == 1
    cached = twk.weight_transform(w)
    assert torch.equal(conv3x3_winograd(x, w, b, r.clone(), use_kernel=True, u=cached), wino)


def test_conv3x3_caches_the_weight_transform():
    conv = Conv3x3(128, 128, winograd=True)
    u0 = conv.winograd_weights()
    assert conv.winograd_weights() is u0 and u0.shape == twk.u_shape(128, 128) and u0.dtype == torch.bfloat16
    with torch.no_grad():
        conv.weight.mul_(2.0)  # in place: the version changes
    u1 = conv.winograd_weights()
    assert u1 is not u0 and torch.equal(u1, twk.weight_transform(conv.weight))
    assert conv.winograd_weights(0, 64).shape == twk.u_shape(64, 128) == (1, 2, 4, 4, 16, 4, 8, 8)
    assert not Conv3x3(128, 128, up2=True, winograd=True).winograd  # the up2 conv never takes the route


@pytest.mark.parametrize("res", [False, True])
def test_backward_matches_jax_vjp(monkeypatch, res):
    """``_Conv3x3.backward`` against ``jax.vjp`` through the Pallas kernel
    (interpret mode) and its ``_conv3x3_bwd``: both are the direct conv's
    gradient in float32."""
    monkeypatch.setenv("DU_TPU_WINO_NOGATE", "1")
    x, wt, b, r = _case(11, 8, 8, 16, 128, 128, res)
    ins = [x, wt, b] + ([r] if res else [])
    assert wc.supports(x.shape, wt.shape, (1, 1), (1, 1))

    def jfn(*a):
        return wc.conv3x3_winograd(a[0], a[1], a[2], a[3] if res else None, use_pallas=True)

    out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in ins))
    ct = _rand(np.random.RandomState(12), *out.shape)
    jgrads = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    tx, tb = _t(x).requires_grad_(), _t(b).requires_grad_()
    tw = _torch_w(wt).requires_grad_()
    tr = _t(r).requires_grad_() if res else None
    y = conv3x3_winograd(tx, tw, tb, tr, use_kernel=True)
    assert type(y.grad_fn).__name__ == "_Conv3x3Backward"
    tins = [tx, tw, tb] + ([tr] if res else [])
    tgrads = torch.autograd.grad(y, tins, _t(ct))
    want = [jgrads[0], jgrads[1].transpose(3, 2, 0, 1), jgrads[2]] + jgrads[3:]
    for got, w_ in zip(tgrads, want):
        np.testing.assert_allclose(got.numpy(), w_, atol=1e-5 * max(1.0, float(np.abs(w_).max())), rtol=0)


class PallasReplay:
    """Runs a JAX model with every ``conv3x3_winograd`` call on the Pallas
    kernel (interpret mode), recording each call's input, residual and
    output; then, while the port's model runs, checks each of the port's
    Winograd calls against the JAX call of the same rank, teacher-forced.

    Why teacher-forced: the kernel rounds its input transform to bf16, so a
    1e-7 difference in a site's input (the float32 summation order of the
    layers before it) moves some operands by one bf16 step and the site's
    output by about 1e-3 of its size, which the next sites carry on. So at
    each site the port's input must match the JAX input (rel 1e-4: the
    layers between sites), the port's Winograd arithmetic on the JAX input
    and residual, with the module's cached transformed weights, must match
    the JAX output (rel 1e-5: summation order only), and the port then goes
    on from the JAX output."""

    def __init__(self, monkeypatch):
        monkeypatch.setenv("DU_TPU_WINO_NOGATE", "1")
        self.mp = monkeypatch
        self.calls = []

    def run_jax(self, fn):
        jconv = wc.conv3x3_winograd

        def pallas_conv(x, w, b, res=None, use_pallas=None):
            assert wc.supports(x.shape, w.shape, (1, 1), (1, 1)), (x.shape, w.shape)
            out = jconv(x, w, b, res, use_pallas=True)
            self.calls.append((np.array(x), None if res is None else np.array(res), np.array(out)))
            return out

        self.mp.setattr(wc, "conv3x3_winograd", pallas_conv)
        out = np.asarray(fn())
        self.mp.setattr(wc, "conv3x3_winograd", jconv)
        assert self.calls
        return out

    def run_port(self, fn):
        plain = twk.winograd_conv_plain
        seen = iter(range(len(self.calls)))

        def forced(x, u, bias, res=None):
            jx, jres, jout = self.calls[next(seen)]
            scale = lambda a: 1e-4 * max(1.0, float(np.abs(a).max()))  # noqa: E731
            np.testing.assert_allclose(x.numpy(), jx, atol=scale(jx), rtol=0)
            if jres is not None:
                np.testing.assert_allclose(res.numpy(), jres, atol=scale(jres), rtol=0)
            got = plain(torch.from_numpy(jx), u, bias, None if jres is None else torch.from_numpy(jres))
            np.testing.assert_allclose(got.numpy(), jout, atol=1e-5 * max(1.0, float(np.abs(jout).max())), rtol=0)
            return torch.from_numpy(jout)

        self.mp.setattr(twk, "winograd_conv_plain", forced)
        with torch.no_grad():
            out = fn().numpy()
        self.mp.setattr(twk, "winograd_conv_plain", plain)
        assert next(seen, None) is None, "the port took the Winograd route at fewer sites than JAX"
        return out


def _small_adm(winograd):
    """A small ADM with 128-channel levels, so every ResBlock 3x3 conv (and
    both partials of the split-skip input convs) meets the shape rule."""
    jcfg = dataclasses.replace(
        ADMUNetConfig.tiny(), image_size=8, model_channels=128, channel_mult=(1, 1), attention_resolutions=(2,),
        num_heads=2,
    )
    tcfg = dataclasses.replace(
        TADMUNetConfig.tiny(), image_size=8, model_channels=128, channel_mult=(1, 1), attention_resolutions=(2,),
        num_heads=2, winograd=winograd,
    )
    return jcfg, tcfg


def test_adm_with_winograd_matches_jax_pallas(monkeypatch):
    """``ADMUNetConfig.winograd=True`` through the plain version against the
    JAX ADM with every ``conv3x3_winograd`` call on the Pallas kernel: the
    same sites in the same order (the ResBlock convs and both partials of
    each split-skip input conv, the second with the first as its residual),
    each site as ``PallasReplay`` checks it, and the output at 1e-4."""
    jcfg, tcfg = _small_adm(True)
    sd = make_adm_state_dict(jcfg, seed=4, std=0.03)
    rng = np.random.RandomState(1)
    x = rng.randn(8, 8, 8, 3).astype(np.float32)  # batch 8: the JAX kernel's batch tile
    y = rng.randint(0, 10, size=8)
    replay = PallasReplay(monkeypatch)
    ref = replay.run_jax(
        lambda: ADMUNet(jcfg).apply(convert_adm_unet(sd, jcfg), jnp.asarray(x), jnp.asarray(250), jnp.asarray(y))
    )
    # 5 encoder/middle ResBlocks x 2 convs, 4 split-skip decoder ResBlocks x 3
    # (two input partials and out_conv), the upsampling ResBlock's out_conv
    assert len(replay.calls) == 23
    model = TADMUNet(tcfg).eval()
    model.load_state_dict(torch_state_dict(sd))
    out = replay.run_port(lambda: model(torch.from_numpy(x), 250, torch.from_numpy(y)))
    # float32 both sides: summation order of the network around the sites
    np.testing.assert_allclose(out, ref, atol=1e-4 * max(1.0, float(np.abs(ref).max())), rtol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_winograd_kernel_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dtype)  # noqa: E731
    # K beyond one 128-channel block; 4x4 maps (one window stage, and one V/U
    # stage in float32); a ragged tile grid (3 x 17 tiles) with C = 32, K = 8
    for n, h, w_, c, k in ((2, 8, 12, 128, 136), (16, 4, 4, 256, 256), (1, 6, 34, 32, 8)):
        x, w, b, res = r(n, h, w_, c), r(k, c, 3, 3) * 0.05, r(k), r(n, h, w_, k)
        u = twk.weight_transform(w)
        got = twk.winograd_conv(x, u, b.float(), res).float()
        want = twk.winograd_conv_plain(x, u, b.float(), res).float()
        tol = (2.0**-7 if dtype == torch.bfloat16 else 1e-5) * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol, (n, h, w_, c, k)
